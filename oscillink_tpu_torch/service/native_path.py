"""The service's small-N native route (port of
``oscillink_tpu/service/native_path.py``).

When ``OSCILLINK_NATIVE_SMALL_N`` is a positive threshold and a request has
N <= threshold, an exact-similarity build and no seed-jitter tie-break, its
settle (gates and chain priors included), bundle, chain receipt or batch is
served by the host C++ engine (`oscillink_tpu_torch.native`) instead of the
card: for lattices that settle in well under a millisecond on the host, the
card's fixed per-request cost is most of the request.  The response shape
(receipt, signatures, HMAC) is the device route's, with ``backend``
``"native"``; state signatures agree across routes by construction (the
shared graph-token scheme of `core.lattice.compute_graph_token`).
Diffusion-gated requests stay on the card unless
``OSCILLINK_NATIVE_DIFFUSION=1``: derived gates feed the state signature and
the two CG implementations agree only to about 1e-4.

Where the JAX route finds the engine unbuildable, ``eligible`` returns
False and the request is served from the device without a word.  Here
`require_engine` raises an `ApiError` 503 naming the build failure, and
`service.api.create_state` refuses to start when the threshold is set and
the engine does not build.
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional

import numpy as np

from ..core.lattice import OscillinkLattice, compute_graph_token, compute_state_sig
from ..core.receipts import receipt_body
from ..native import engine as _engine
from ..ops.graph import resolve_similarity
from .config import get_settings
from .governance import ApiError

__all__ = [
    "native_threshold",
    "eligible",
    "require_engine",
    "native_prepare",
    "native_settle",
    "chain_receipt_native",
]


def native_threshold() -> int:
    try:
        return int(os.getenv("OSCILLINK_NATIVE_SMALL_N", "0"))
    except ValueError:
        return 0


def require_engine() -> None:
    """Build (first call) and load the engine; a build failure is a 503
    naming it, never a quiet route to the card."""
    try:
        _engine.load_engine()
    except _engine.NativeBuildError as e:
        raise ApiError(
            503,
            f"OSCILLINK_NATIVE_SMALL_N={native_threshold()} routes this request to the "
            f"native engine, which is unavailable: {e}",
        ) from None


def eligible(sreq, n: int) -> bool:
    """Whether the native route serves this request (the JAX route's
    rules); raises a 503 `ApiError` when it would and the engine does not
    build."""
    thr = native_threshold()
    if thr <= 0 or n > thr:
        return False
    if sreq.params.deterministic_k is False and sreq.params.neighbor_seed is not None:
        return False  # seed-jitter tie-break is a device-path feature
    dopt = getattr(sreq, "diffusion", None)
    if dopt is not None and dopt.enable:
        # derived gates feed the state signature (compute_state_sig rounds
        # B at 1e-6) and the two CG implementations agree only to ~1e-4, so
        # routing diffusion natively would make state_sig (and signed
        # receipts, and the bundle cache) depend on which replica served
        # the request; opt in only where every replica serves small N
        # natively
        if os.getenv("OSCILLINK_NATIVE_DIFFUSION", "0") != "1":
            return False
    # both bundle modes (MMR and rerank/top-k) are implemented natively
    if resolve_similarity(n, getattr(sreq.params, "similarity", "exact")) != "exact":
        return False  # approximate builds are a device-path feature
    require_engine()
    return True


def _engine_for_request(sreq, eff_params: dict):
    """Build + configure the engine for a request (query, gates, diffusion,
    chain) and compute the cross-backend state signature.  Shared by the
    settle and chain-receipt native branches.  Returns
    (eng, psi, state_sig, k_eff, n, d)."""
    Y = np.array(sreq.Y, dtype=np.float32)
    n, d = Y.shape
    k_eff = min(int(eff_params["kneighbors"]), max(1, n - 1))
    eng = _engine.NativeEngine(
        Y,
        kneighbors=k_eff,
        lamG=eff_params["lamG"],
        lamC=eff_params["lamC"],
        lamQ=eff_params["lamQ"],
    )
    psi = (
        np.array(sreq.psi, dtype=np.float32)
        if sreq.psi is not None
        else np.zeros(d, dtype=np.float32)
    )
    gates = (
        np.array(sreq.gates, dtype=np.float32) if sreq.gates is not None else None
    )
    # a short psi/gates buffer would be an out-of-bounds read in the C
    # engine; the handlers validate first, this is the engine's own guard
    if psi.shape != (d,):
        raise ApiError(400, "psi dimension mismatch")
    if gates is not None and gates.shape != (n,):
        raise ApiError(400, "gates length mismatch")
    if sreq.chain:
        if len(sreq.chain) < 2:
            raise ApiError(400, "chain must have >=2 nodes")
        if min(sreq.chain) < 0 or max(sreq.chain) >= n:
            raise ApiError(400, "chain indices out of bounds")
    eng.set_query(psi, gates=gates)
    dopt = getattr(sreq, "diffusion", None)
    if dopt is not None and dopt.enable:
        # gates XOR diffusion is enforced upstream (_validate_diffusion);
        # derive over the engine's own graph like the device path does
        eng.diffusion_gates(
            beta=float(dopt.beta),
            gamma=float(dopt.gamma),
            tol=float(dopt.tol),
            max_iters=int(dopt.max_iters),
            apply=True,
        )
    if sreq.chain:
        eng.add_chain(sreq.chain, lamP=sreq.params.lamP)

    y_hash = OscillinkLattice._hash_anchors(Y)
    token = compute_graph_token(
        y_hash, k_eff, 1.0, bool(sreq.params.deterministic_k), sreq.params.neighbor_seed
    )
    state_sig = compute_state_sig(
        psi,
        eng.B,
        [eng.lamG, eng.lamC, eng.lamQ, float(eng.lamP)],
        bool(sreq.chain),
        len(sreq.chain) if sreq.chain else 0,
        k_eff,
        bool(sreq.params.deterministic_k),
        token,
    )
    return eng, psi, state_sig, k_eff, n, d


def native_prepare(sreq, eff_params: dict):
    """Engine + state signature for a request WITHOUT running the settle.

    The bundle endpoint needs `state_sig` for its cache lookup before
    paying for the solve — on a HIT the settle never runs.  Pass the
    returned tuple to `native_settle(..., prepared=...)` on a MISS."""
    return _engine_for_request(sreq, eff_params)


def chain_receipt_native(sreq, eff_params: dict, *, z_th: float = 2.5):
    """Chain receipt on the host engine; returns (chain_receipt, state_sig).
    Output contract matches `OscillinkLattice.chain_receipt` (the engine
    method mirrors ops/receipts.py:chain_edge_stats — parity tests in
    tests/test_torch_native_engine.py)."""
    eng, _, state_sig, *_ = _engine_for_request(sreq, eff_params)
    return eng.chain_receipt(sreq.chain, z_th=z_th), state_sig


def native_settle(
    sreq,
    eff_params: dict,
    *,
    include_receipt: Optional[bool] = None,
    bundle_alpha: float = 0.5,
    prepared=None,
) -> dict[str, Any]:
    """Run the settle on the native engine; returns the response body pieces
    {state_sig, receipt, bundle, settle_stats, t_ms}.  ``prepared`` accepts
    a `native_prepare` tuple so callers that already built the engine (for
    a cache lookup) don't rebuild it; t_ms then covers the settle only —
    the caller owns the prep timing."""
    t0 = time.perf_counter()
    eng, _, state_sig, k_eff, *_ = (
        prepared if prepared is not None else _engine_for_request(sreq, eff_params)
    )
    stats = eng.settle(
        dt=sreq.options.dt, max_iters=sreq.options.max_iters, tol=sreq.options.tol
    )
    t_ms = 1000.0 * (time.perf_counter() - t0)

    want_receipt = (
        sreq.options.include_receipt if include_receipt is None else include_receipt
    )
    receipt = None
    if want_receipt:
        Ustar, uiters, ures = eng.solve_ustar()
        s = get_settings()
        receipt = receipt_body(
            deltaH_total=eng.deltaH(eng.U, Ustar), sums=[t.sum() for t in eng.per_node(Ustar)],
            cg_iters=stats["iters"], residual=stats["res"], t_ms=t_ms,
            null_points=eng.null_points(Ustar),
            ustar_converged=ures <= 1e-4, ustar_res=ures, ustar_iters=uiters,
            last_settle_ms=t_ms, n_edges=(eng.w > 0).sum(), gates=eng.B, state_sig=state_sig,
            backend="native",
            secret=s.receipt_secret if s.enable_signature and s.receipt_secret else None,
        )

    bundle = None
    if sreq.options.bundle_k:
        bundle = eng.bundle(
            k=sreq.options.bundle_k,
            alpha=bundle_alpha,
            diversify=getattr(sreq.options, "bundle_diversify", True),
        )

    return {
        "state_sig": state_sig,
        "receipt": receipt,
        "bundle": bundle,
        "settle_stats": stats,
        "t_ms": t_ms,
        "k_eff": k_eff,
    }
