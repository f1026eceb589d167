"""The receipt's wire format, signing and verification (host-side,
hardware independent).

The port's own copy of ``oscillink_tpu/core/receipts.py`` (that package
imports JAX on import, so the port cannot reuse it).  HMAC-SHA256 over
canonical (sorted-keys) JSON payloads, constant-time compare.  It must stay
wire-compatible: a receipt signed by either package verifies in the other.

It also assembles the receipts that the lattice, the service's native route
and its mesh route return (`receipt_body`, `chain_receipt_body`): one key
order for every route, which is the JAX package's.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
from typing import Any, Optional, Sequence

import numpy as np

__all__ = [
    "canonical_json",
    "sign_payload",
    "verify_receipt",
    "verify_receipt_mode",
    "sign_component",
    "verify_component",
    "null_summary",
    "receipt_body",
    "chain_receipt_body",
]


def _as_bytes(secret: bytes | str) -> bytes:
    return secret.encode("utf-8") if isinstance(secret, str) else secret


def canonical_json(payload: dict) -> bytes:
    return json.dumps(payload, sort_keys=True).encode("utf-8")


def sign_payload(payload: dict, secret: bytes | str) -> str:
    """Hex HMAC-SHA256 of the canonical JSON encoding of ``payload``."""
    return hmac.new(_as_bytes(secret), canonical_json(payload), hashlib.sha256).hexdigest()


def _candidate_secrets(
    block: dict, secret: "bytes | str | dict[str, bytes | str]"
) -> list:
    """Resolve the secret(s) to try: a plain secret is tried as-is; a
    {kid: secret} rotation map narrows to the block's kid when stamped,
    else tries every mapped secret (rotation-safe, like the Stripe
    webhook verify)."""
    if not isinstance(secret, dict):
        return [secret]
    kid = block.get("kid")
    if kid is not None:
        s = secret.get(kid)
        return [s] if s is not None else []
    return list(secret.values())


def verify_receipt(
    receipt: dict, secret: "bytes | str | dict[str, bytes | str]"
) -> bool:
    """Verify a signed receipt's meta.signature block. Never raises.

    ``secret`` may be a single secret or a {kid: secret} rotation map
    (reference roadmap: multi-secret receipt signing with key ids)."""
    try:
        block = receipt.get("meta", {}).get("signature")
        if not block or block.get("algorithm") != "HMAC-SHA256":
            return False
        payload = block.get("payload")
        claimed = block.get("signature")
        if payload is None or claimed is None:
            return False
        return any(
            hmac.compare_digest(sign_payload(payload, s), str(claimed))
            for s in _candidate_secrets(block, secret)
        )
    except Exception:
        return False


def verify_receipt_mode(
    receipt: dict,
    secret: "bytes | str | dict[str, bytes | str]",
    require_mode: Optional[str] = None,
    minimal_subset: bool = False,
    required_sig_v: Optional[int] = None,
) -> tuple[bool, Optional[dict]]:
    """Mode-aware verification (reference receipts.py:113-179).

    * ``require_mode`` in {'minimal', 'extended', None}: fail when the signed
      payload's mode differs.
    * ``required_sig_v``: fail when payload['sig_v'] differs.
    * ``minimal_subset``: for an 'extended' payload whose full signature does
      not match, retry against the minimal-subset payload {sig_v, mode:
      'minimal', state_sig, deltaH_total} — accepted only when require_mode is
      None or 'minimal'.

    Returns (ok, signed_payload_or_none).
    """
    try:
        block = receipt.get("meta", {}).get("signature")
        if not block or block.get("algorithm") != "HMAC-SHA256":
            return False, None
        payload = block.get("payload")
        sig_hex = block.get("signature")
        if payload is None or sig_hex is None:
            return False, None
        mode = payload.get("mode")
        if require_mode and mode != require_mode:
            return False, None
        if required_sig_v is not None and payload.get("sig_v") != required_sig_v:
            return False, None
        candidates = _candidate_secrets(block, secret)
        if any(
            hmac.compare_digest(sign_payload(payload, s), str(sig_hex))
            for s in candidates
        ):
            return True, payload
        if minimal_subset and mode == "extended":
            minimal_payload: dict[str, Any] = {
                "sig_v": payload.get("sig_v"),
                "mode": "minimal",
                "state_sig": payload.get("state_sig"),
                "deltaH_total": payload.get("deltaH_total"),
            }
            ok = any(
                hmac.compare_digest(sign_payload(minimal_payload, s), str(sig_hex))
                for s in candidates
            )
            if ok and require_mode in (None, "minimal"):
                return True, minimal_payload
        return False, None
    except Exception:
        return False, None


def sign_component(payload: dict, secret: bytes | str) -> dict:
    """Signature block for a composition-tier component receipt (shard /
    super / composed — SCALING.md section 6: each shard produces an
    independently verifiable receipt).  Same HMAC-SHA256-over-canonical-JSON
    contract as the lattice receipt's meta.signature block; attached at the
    component's top level as ``receipt["signature"]``."""
    return {
        "algorithm": "HMAC-SHA256",
        "payload": payload,
        "signature": sign_payload(payload, secret),
    }


def verify_component(receipt: dict, secret: bytes | str) -> bool:
    """Verify a composition component receipt signed by `sign_component`.
    Never raises; also checks that the signed payload's scalar fields match
    the receipt's own (a tampered receipt with an intact signed payload
    fails)."""
    try:
        block = receipt.get("signature")
        if not block or block.get("algorithm") != "HMAC-SHA256":
            return False
        payload = block.get("payload")
        claimed = block.get("signature")
        if payload is None or claimed is None:
            return False
        if not hmac.compare_digest(sign_payload(payload, secret), str(claimed)):
            return False
        return all(receipt.get(k) == v for k, v in payload.items())
    except Exception:
        return False


def _null_cap_env() -> int:
    """``OSCILLINK_RECEIPT_NULL_CAP``: the most null points a receipt lists
    (0, unset or garbage: no cap).  Each route that caps applies it its own
    way."""
    try:
        return int(os.getenv("OSCILLINK_RECEIPT_NULL_CAP", "0").strip())
    except ValueError:
        return 0


def null_summary(null_points: list, total: Optional[int] = None) -> dict[str, Any]:
    """``meta.null_points_summary`` for ``null_points`` listed out of
    ``total`` flagged rows (None: every flagged row is listed)."""
    total = len(null_points) if total is None else int(total)
    return {
        "total_null_points": total,
        "returned_null_points": len(null_points),
        "null_cap_applied": total > len(null_points),
    }


def receipt_body(
    *, deltaH_total: float, sums: Sequence[float], cg_iters: int, residual: float, t_ms: float,
    null_points: list, ustar_converged: bool, ustar_res: float, ustar_iters: int,
    last_settle_ms: float, n_edges: int, gates: np.ndarray, state_sig: str,
    secret: Optional[bytes | str] = None, ustar_cached: bool = False, ustar_solves: int = 1,
    ustar_cache_hits: int = 0, ustar_solve_ms: float = 0.0, graph_build_ms: float = 0.0,
    receipt_detail: str = "full", null_points_summary: Optional[dict] = None,
    deltaH_mode: Optional[str] = None, similarity: Optional[str] = None,
    similarity_recall_target: Optional[float] = None, similarity_info: Optional[dict] = None,
    window_precision: Optional[str] = None, backend: Optional[str] = None,
    mesh_devices: Optional[int] = None, kid: Optional[str] = None,
    extended: Optional[dict] = None, dynamics: Optional[dict] = None,
) -> dict[str, Any]:
    """The receipt of a settled lattice: ΔH, the three energy sums
    (coherence drop, anchor penalty, query term), the settle's iterations,
    residual and time, the null points, and ``meta``.

    N is the length of ``gates`` (the host gate vector); ``avg_degree`` and
    ``edge_density`` come from ``n_edges`` and N.  The keys of ``meta``
    whose argument is None are left out.  ``null_points_summary`` defaults
    to every flagged row listed (`null_summary`).  With a ``secret``,
    ``meta.signature`` signs the minimal payload {sig_v, mode, state_sig,
    deltaH_total}, or with ``extended`` (the lattice's params and graph)
    the extended payload, which adds U*'s iterations, residual and
    convergence; ``kid`` stamps the block with its key id."""
    from .. import __version__

    n = len(gates)
    meta: dict[str, Any] = {
        "ustar_cached": bool(ustar_cached),
        "ustar_solves": int(ustar_solves),
        "ustar_cache_hits": int(ustar_cache_hits),
        "ustar_converged": bool(ustar_converged),
        "ustar_res": float(ustar_res),
        "ustar_iters": int(ustar_iters),
        "ustar_solve_ms": float(ustar_solve_ms),
        "graph_build_ms": float(graph_build_ms),
        "last_settle_ms": float(last_settle_ms),
        "deltaH_mode": deltaH_mode,
        "avg_degree": float(n_edges / max(n, 1)),
        "edge_density": float(n_edges / max(n * (n - 1), 1)),
        "similarity": similarity,
        "similarity_recall_target": similarity_recall_target,
        "similarity_info": similarity_info,
        "window_precision": window_precision,
        "gates_min": float(np.min(gates)),
        "gates_max": float(np.max(gates)),
        "gates_mean": float(np.mean(gates)),
        "gates_uniform": bool(np.allclose(gates, gates[0])),
        "state_sig": state_sig,
        "receipt_detail": receipt_detail,
        "backend": backend,
        "mesh_devices": mesh_devices,
        "null_points_summary": null_points_summary or null_summary(null_points),
    }
    meta = {k: v for k, v in meta.items() if v is not None}
    if secret is not None:
        payload = {
            "sig_v": 1,
            "mode": "minimal" if extended is None else "extended",
            "state_sig": state_sig,
            "deltaH_total": float(deltaH_total),
        }
        if extended is not None:
            payload.update(
                ustar_iters=meta["ustar_iters"],
                ustar_res=meta["ustar_res"],
                ustar_converged=meta["ustar_converged"],
                **extended,
            )
        meta["signature"] = sign_component(payload, secret)
        if kid is not None:
            meta["signature"]["kid"] = kid
    if dynamics is not None:
        meta["dynamics"] = dynamics
    coh_sum, anchor_sum, query_sum = sums
    return {
        "version": str(__version__),
        "deltaH_total": float(deltaH_total),
        "coh_drop_sum": float(coh_sum),
        "anchor_pen_sum": float(anchor_sum),
        "query_term_sum": float(query_sum),
        "cg_iters": int(cg_iters),
        "residual": float(residual),
        "t_ms": float(t_ms),
        "null_points": null_points,
        "meta": meta,
    }


def chain_receipt_body(
    chain: Sequence[int],
    z_struct: Sequence[float],
    z_path: Sequence[float],
    r_struct: Sequence[float],
    r_path: Sequence[float],
    gain: float,
    z_th: float,
) -> dict[str, Any]:
    """The chain receipt from the per-edge z-scores and residuals of
    ``chain``'s consecutive edges: each edge, the weakest link (the first
    edge of largest max(z_struct, z_path)), the verdict that no edge's
    larger z-score exceeds ``z_th``, and the coherence gain."""
    edges: list[dict[str, Any]] = []
    worst = (-1, -1.0, [-1, -1])
    for a in range(len(chain) - 1):
        i, j = int(chain[a]), int(chain[a + 1])
        edge = {"k": a, "edge": [i, j], "z_struct": float(z_struct[a]), "z_path": float(z_path[a]),
                "r_struct": float(r_struct[a]), "r_path": float(r_path[a])}
        edges.append(edge)
        zmax = max(edge["z_struct"], edge["z_path"])
        if zmax > worst[1]:
            worst = (a, zmax, [i, j])
    return {
        "verdict": all(max(e["z_struct"], e["z_path"]) <= float(z_th) for e in edges),
        "weakest_link": {"k": worst[0], "edge": worst[2], "zscore": worst[1]},
        "coherence_gain": float(gain),
        "edges": edges,
    }
