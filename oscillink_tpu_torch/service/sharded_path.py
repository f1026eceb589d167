"""The service's large-N sharded route (port of
``oscillink_tpu/service/sharded_path.py``).

When ``OSCILLINK_SHARDED_MIN_N`` is a positive threshold and a request has
N >= threshold, the settle is served by the mesh tier
(`parallel.serve.sharded_serve`) instead of a single-device lattice: graph
build, CG solves and every receipt quantity run row-sharded over the
service's mesh (`service.api.create_state`'s ``mesh``: every visible card,
or a list of devices that may repeat), on the largest prefix of it whose
size divides N, and U and U* never gather into one host buffer.  The
response shape (receipt, signatures, HMAC) is the device route's with
``backend`` ``"sharded"``; state signatures agree across routes by
construction (the shared graph-token scheme of `core.lattice`).

Raise ``OSCILLINK_MAX_NODES`` together with ``OSCILLINK_SHARDED_MIN_N``.
Chain priors ride along.  Routing exclusions (served by the device route
instead), as in the JAX service: seeded-jitter neighbour selection,
diffusion-gated requests, and rerank bundles (``bundle_diversify`` false).
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Any, Optional

import numpy as np

from ..core.lattice import OscillinkLattice, compute_graph_token, compute_state_sig
from ..core.receipts import _null_cap_env, null_summary, receipt_body
from ..ops.graph import resolve_similarity
from ..parallel.mesh import Mesh
from .config import get_settings
from .governance import ApiError

__all__ = [
    "sharded_threshold",
    "eligible",
    "mesh_for",
    "request_state_sig",
    "sharded_settle",
]


def sharded_threshold() -> int:
    try:
        return int(os.getenv("OSCILLINK_SHARDED_MIN_N", "0"))
    except ValueError:
        return 0


def mesh_for(n: int, mesh: Mesh) -> Mesh:
    """The first shards of the service's mesh, as many as the largest count
    that divides N (row blocks must be equal)."""
    n_dev = mesh.size
    while n_dev > 1 and n % n_dev != 0:
        n_dev -= 1
    return Mesh(mesh.devices[:n_dev], mesh.axis_name)


def eligible(sreq, n: int) -> bool:
    thr = sharded_threshold()
    if thr <= 0 or n < thr:
        return False
    if sreq.params.deterministic_k is False and sreq.params.neighbor_seed is not None:
        return False  # seed-jitter tie-break runs host-side (exact parity path)
    d = getattr(sreq, "diffusion", None)
    if d is not None and d.enable:
        return False  # diffusion gates ride the single-device lattice graph
    opts = getattr(sreq, "options", None)
    if (
        opts is not None
        and getattr(opts, "bundle_k", None)
        and getattr(opts, "bundle_diversify", True) is False
    ):
        return False  # the sharded serve pipeline implements MMR only
    return True


def request_state_sig(sreq, eff_params: dict, Y: np.ndarray) -> tuple[str, int]:
    """State signature for a request without building a lattice — the same
    token scheme as the single-device build (core/lattice.py:425-436), so
    signatures and bundle-cache keys agree across backends.
    Returns (state_sig, k_eff)."""
    n, d = Y.shape
    k_eff = min(int(eff_params["kneighbors"]), max(1, n - 1))
    similarity = resolve_similarity(n, getattr(sreq.params, "similarity", "exact"))
    if similarity == "cluster":
        similarity = "fast"  # IVF is single-device; realized mode keys the sig
    y_hash = OscillinkLattice._hash_anchors(Y)
    token = compute_graph_token(
        y_hash, k_eff, 1.0, bool(sreq.params.deterministic_k), sreq.params.neighbor_seed
    )
    if similarity != "exact":
        token = hashlib.sha256(f"{token}:{similarity}".encode()).hexdigest()
    B = (
        np.array(sreq.gates, dtype=np.float32)
        if sreq.gates is not None
        else np.ones(n, dtype=np.float32)
    )
    psi_sig = (
        np.array(sreq.psi, dtype=np.float32)
        if sreq.psi is not None
        else np.zeros(d, dtype=np.float32)
    )
    sig = compute_state_sig(
        psi_sig,
        B,
        [
            float(eff_params["lamG"]),
            float(eff_params["lamC"]),
            float(eff_params["lamQ"]),
            float(sreq.params.lamP) if sreq.chain else 0.0,
        ],
        bool(sreq.chain),
        len(sreq.chain) if sreq.chain else 0,
        k_eff,
        bool(sreq.params.deterministic_k),
        token,
    )
    return sig, k_eff


def sharded_settle(
    sreq,
    eff_params: dict,
    *,
    include_receipt: Optional[bool] = None,
    alpha: float = 0.5,
    Y: Optional[np.ndarray] = None,
    mesh: Mesh,
) -> dict[str, Any]:
    """Serve the settle on the sharded tier over ``mesh`` (the service's;
    `mesh_for` takes the shards that divide N); returns the response body
    pieces {state_sig, receipt, bundle, settle_stats, t_ms, k_eff,
    mesh_devices}.  Pass ``Y`` when the caller already parsed the request
    matrix."""
    from ..parallel.serve import sharded_serve

    if Y is None:
        Y = np.array(sreq.Y, dtype=np.float32)
    n, d = Y.shape
    k_eff = min(int(eff_params["kneighbors"]), max(1, n - 1))
    psi = np.array(sreq.psi, dtype=np.float32) if sreq.psi is not None else None
    gates = np.array(sreq.gates, dtype=np.float32) if sreq.gates is not None else None
    # the same 400s the device path raises from _build_lattice — without
    # them a bad shape becomes a jit-time 500 after quota was charged
    if psi is not None and psi.shape != (d,):
        raise ApiError(400, "psi dimension mismatch")
    if gates is not None and gates.shape != (n,):
        raise ApiError(400, "gates length mismatch")
    if sreq.chain:
        if len(sreq.chain) < 2:
            raise ApiError(400, "chain must have >=2 nodes")
        if min(sreq.chain) < 0 or max(sreq.chain) >= n:
            raise ApiError(400, "chain indices out of bounds")
    similarity = resolve_similarity(n, getattr(sreq.params, "similarity", "exact"))
    if similarity == "cluster":
        # the sharded tiers have no IVF path yet — realize as the fast scan
        # (and hash THAT into the signature so sharded and single-device
        # cluster requests, whose graphs differ, never share cache keys)
        similarity = "fast"

    want_receipt = (
        sreq.options.include_receipt if include_receipt is None else include_receipt
    )
    t0 = time.perf_counter()
    out = sharded_serve(
        mesh_for(n, mesh),
        Y,
        psi,
        gates,
        k=k_eff,
        lamG=eff_params["lamG"],
        lamC=eff_params["lamC"],
        lamQ=eff_params["lamQ"],
        dt=sreq.options.dt,
        settle_tol=sreq.options.tol,
        settle_iters=sreq.options.max_iters,
        similarity=similarity,
        bundle_k=sreq.options.bundle_k,
        alpha=alpha,
        chain=sreq.chain,
        lamP=sreq.params.lamP,
    )
    t_ms = 1000.0 * (time.perf_counter() - t0)

    state_sig, _ = request_state_sig(sreq, eff_params, Y)

    receipt = None
    if want_receipt:
        # the null cap as the device route reads it, kept to the highest z
        # by a stable sort: this tier's N is where uncapped null lists are
        # megabytes of JSON
        nulls = out["null_points"]
        cap = _null_cap_env()
        if 0 < cap < len(nulls):
            nulls = sorted(nulls, key=lambda e: -e["z"])[:cap]
        s = get_settings()
        receipt = receipt_body(
            deltaH_total=out["deltaH"],
            sums=(out["coh_drop_sum"], out["anchor_pen_sum"], out["query_term_sum"]),
            cg_iters=out["settle_iters"], residual=out["settle_res"], t_ms=t_ms,
            null_points=nulls, null_points_summary=null_summary(nulls, len(out["null_points"])),
            ustar_converged=out["ustar_converged"], ustar_res=out["ustar_res"],
            ustar_iters=out["ustar_iters"], last_settle_ms=t_ms, deltaH_mode="standard",
            n_edges=out["n_edges"], gates=gates if gates is not None else np.ones(n, np.float32),
            state_sig=state_sig, backend="sharded", mesh_devices=out["mesh_devices"],
            secret=s.receipt_secret if s.enable_signature and s.receipt_secret else None,
        )

    stats = {"iters": out["settle_iters"], "res": out["settle_res"], "t_ms": t_ms}
    return {
        "state_sig": state_sig,
        "receipt": receipt,
        "bundle": out["bundle"],
        "settle_stats": stats,
        "t_ms": t_ms,
        "k_eff": k_eff,
        "mesh_devices": out["mesh_devices"],
    }
