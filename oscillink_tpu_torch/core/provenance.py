"""Structured provenance diff between two lattices (reference core/provenance.py:11-55).

The port's own copy of ``oscillink_tpu/core/provenance.py``: it reads the
lattices' coefficients, shapes, chains, query, gates and
`adjacency_fingerprint`, so it gives the JAX package's dict for the same
lattices."""

from __future__ import annotations

import hashlib
from typing import TYPE_CHECKING, Any, Dict

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from .lattice import OscillinkLattice

__all__ = ["compare_provenance"]


def _hash_array(arr: np.ndarray, round_decimals: int = 6) -> str:
    r = np.round(np.asarray(arr, dtype=float), round_decimals)
    return hashlib.sha256(r.tobytes()).hexdigest()


def compare_provenance(a: "OscillinkLattice", b: "OscillinkLattice") -> Dict[str, Any]:
    """Diff the core provenance inputs of two lattices.

    Compares params, shape, adjacency fingerprint (same 2048-edge subset hash
    used in the state signature), chain presence/length, and rounded psi /
    gate hashes.
    """
    pa = {"lamG": a.lamG, "lamC": a.lamC, "lamQ": a.lamQ, "lamP": a.lamP}
    pb = {"lamG": b.lamG, "lamC": b.lamC, "lamQ": b.lamQ, "lamP": b.lamP}

    out: Dict[str, Any] = {
        "same": True,
        "params_equal": pa == pb,
        "shape_equal": (a.N, a.D) == (b.N, b.D),
        "adj_equal": a.adjacency_fingerprint() == b.adjacency_fingerprint(),
        "chain_equal": (a._chain_nodes is not None) == (b._chain_nodes is not None)
        and (len(a._chain_nodes or []) == len(b._chain_nodes or [])),
        "psi_equal": _hash_array(a.psi) == _hash_array(b.psi),
        "gates_equal": _hash_array(a.B_diag) == _hash_array(b.B_diag),
    }
    out["same"] = all(v for k, v in out.items() if k.endswith("_equal"))
    if not out["same"]:
        out["detail"] = {
            "params_a": pa,
            "params_b": pb,
            "shape_a": (a.N, a.D),
            "shape_b": (b.N, b.D),
        }
    return out
