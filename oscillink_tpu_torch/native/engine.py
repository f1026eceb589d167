"""ctypes binding and first-use build of the native C++ lattice engine.

Port of ``oscillink_tpu/native/engine.py``.  ``engine.cpp`` beside this
file is a byte-identical copy of the JAX package's, built the same way:
``g++ -O3 -ffp-contract=off`` (FMA contraction off, so receipt values do
not depend on the machine that compiled the library) with
``-march=$OSCILLINK_NATIVE_MARCH`` (``native`` by default, empty to omit),
retried without ``-march`` when that fails.  The library goes into the
kernels' build directory (`ops.kernels.build.BUILD_DIR`, which
``OSCILLINK_COMPILE_CACHE_DIR`` repoints), or into
``OSCILLINK_NATIVE_CACHE`` when that is set, named by a hash of the source
and the flags, and is compiled to a temporary name and renamed into place.

One difference from the JAX binding: a failed build raises
`NativeBuildError` with the compiler's message (and every later call in the
process raises it again without rebuilding), where the JAX package returns
None and its service routes the request to the device without a word.
`native_available()` answers False in that case.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np

from ..core.receipts import chain_receipt_body
from ..ops.kernels import build as _kbuild

__all__ = ["NativeBuildError", "NativeEngine", "load_engine", "native_available"]

_SRC = Path(__file__).with_name("engine.cpp")
_LOCK = threading.Lock()
# loaded libraries and build failures, by (library path, compiler)
_LIBS: dict[tuple[str, str], ctypes.CDLL] = {}
_FAILED: dict[tuple[str, str], "NativeBuildError"] = {}


class NativeBuildError(RuntimeError):
    """The native engine could not be compiled or loaded."""


def _base_flags() -> list[str]:
    # -ffp-contract=off: keep FMA contraction off even under -march so the
    # engine's accumulation semantics (and hence receipt values) don't
    # depend on which machine compiled the cached .so
    return ["-O3", "-std=c++17", "-shared", "-fPIC", "-funroll-loops",
            "-ffp-contract=off"]


def _march() -> str:
    # vectorize for the serving host by default (the library is built for
    # the machine that compiles it); OSCILLINK_NATIVE_MARCH="" opts out, or
    # names an arch
    return os.getenv("OSCILLINK_NATIVE_MARCH", "native")


def _cxx() -> str:
    return os.getenv("CXX", "g++")


def _lib_path(flags: list[str]) -> Path:
    key = hashlib.sha256(_SRC.read_bytes() + "\0".join(flags).encode())
    cache_dir = Path(os.getenv("OSCILLINK_NATIVE_CACHE") or _kbuild.BUILD_DIR)
    return cache_dir / f"oscnative_{key.hexdigest()[:16]}.so"


def _compile(flags: list[str]) -> Path:
    """The library for ``flags``, compiled unless it exists.  Raises
    NativeBuildError with the compiler's output."""
    return compile_library(_SRC, flags, _lib_path(flags))


def compile_library(src: Path, flags: list[str], lib: Path) -> Path:
    """``lib``, compiled from ``src`` by ``$CXX`` with ``flags`` unless it
    exists.  Raises NativeBuildError with the compiler's output."""
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    # compile to a temp path and rename: an interrupted g++ would otherwise
    # leave a truncated library that every later process finds, and the
    # rename makes concurrent builders race-safe
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_cxx(), *flags, str(src), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except subprocess.CalledProcessError as e:
        tmp.unlink(missing_ok=True)
        out = (e.stderr or b"").decode(errors="replace").strip()[-2000:]
        raise NativeBuildError(
            f"{' '.join(cmd[:1] + flags)} exited {e.returncode}: {out or 'no output'}"
        ) from None
    except (OSError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"{' '.join(cmd[:1] + flags)}: {e}") from None
    os.replace(tmp, lib)
    return lib


def _bind(dll: ctypes.CDLL) -> ctypes.CDLL:
    i32 = ctypes.c_int32
    f32 = ctypes.c_float
    pf = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    pi = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    pfo = np.ctypeslib.ndpointer(np.float32, flags=("C_CONTIGUOUS", "WRITEABLE"))
    pio = np.ctypeslib.ndpointer(np.int32, flags=("C_CONTIGUOUS", "WRITEABLE"))
    dll.osc_build_graph.restype = i32
    dll.osc_build_graph.argtypes = [pf, i32, i32, i32, f32, pio, pfo, pfo]
    dll.osc_build_graph_from_sims.restype = i32
    dll.osc_build_graph_from_sims.argtypes = [pf, i32, i32, f32, pio, pfo, pfo]
    dll.osc_solve_ustar.restype = i32
    dll.osc_solve_ustar.argtypes = [
        pi, pf, pf, pf, pf, pf, i32, i32, i32, f32, f32, f32, f32, i32, pfo,
        ctypes.POINTER(f32),
    ]
    dll.osc_settle.restype = i32
    dll.osc_settle.argtypes = [
        pi, pf, pf, pf, pf, pf, pf, i32, i32, i32, f32, f32, f32, f32, f32,
        i32, pfo, ctypes.POINTER(f32),
    ]
    dll.osc_deltaH.restype = f32
    dll.osc_deltaH.argtypes = [pi, pf, pf, pf, pf, pf, i32, i32, i32, f32, f32, f32]
    dll.osc_deltaH_chain.restype = f32
    dll.osc_deltaH_chain.argtypes = [
        pi, pf, pf, pf, pf, pf, i32, i32, i32, f32, f32, f32, f32, i32, pi, pi, pf,
    ]
    pu8 = np.ctypeslib.ndpointer(np.uint8, flags=("C_CONTIGUOUS", "WRITEABLE"))
    dll.osc_solve_ustar_chain.restype = i32
    dll.osc_solve_ustar_chain.argtypes = [
        pi, pf, pf, pf, pf, pf, i32, i32, i32, f32, f32, f32, f32, i32,
        pi, pi, pf, f32, i32, pfo, ctypes.POINTER(f32),
    ]
    dll.osc_settle_chain.restype = i32
    dll.osc_settle_chain.argtypes = [
        pi, pf, pf, pf, pf, pf, pf, i32, i32, i32, f32, f32, f32, f32, i32,
        pi, pi, pf, f32, f32, i32, pfo, ctypes.POINTER(f32),
    ]
    dll.osc_per_node.restype = None
    dll.osc_per_node.argtypes = [
        pi, pf, pf, pf, pf, pf, pf, i32, i32, i32, f32, f32, f32, pfo, pfo, pfo,
    ]
    dll.osc_null_points.restype = i32
    dll.osc_null_points.argtypes = [
        pi, pf, pf, pf, i32, i32, i32, f32, f32, pio, pfo, pfo, pu8,
    ]
    dll.osc_diffusion_solve.restype = i32
    dll.osc_diffusion_solve.argtypes = [
        pi, pf, pf, pf, i32, i32, f32, f32, i32, pfo, ctypes.POINTER(f32),
    ]
    return dll


def load_engine() -> ctypes.CDLL:
    """The engine's library, built at first use (with ``-march``, then
    without).  Raises NativeBuildError when neither build succeeds or the
    library does not load; a failure is remembered for its library path
    and compiler, so later calls raise it again at once."""
    if not _SRC.is_file():
        raise NativeBuildError(f"native engine source {_SRC} is missing")
    march = _march()
    attempts = ([_base_flags() + [f"-march={march}"]] if march else []) + [_base_flags()]
    key = (str(_lib_path(attempts[0])), _cxx())
    with _LOCK:
        if key in _LIBS:
            return _LIBS[key]
        if key in _FAILED:
            raise _FAILED[key]
        errors = []
        for flags in attempts:
            try:
                lib = _compile(flags)
            except NativeBuildError as e:
                errors.append(str(e))
                continue
            try:
                dll = _bind(ctypes.CDLL(str(lib)))
            except OSError as e:
                # a corrupt library: delete it so the next process rebuilds
                lib.unlink(missing_ok=True)
                errors.append(f"{lib.name} did not load ({e}); removed")
                continue
            _LIBS[key] = dll
            return dll
        _FAILED[key] = NativeBuildError("native engine build failed: " + "; ".join(errors))
        raise _FAILED[key]


def native_available() -> bool:
    """Whether the engine builds and loads here."""
    try:
        load_engine()
    except NativeBuildError:
        return False
    return True


class _HostPath(NamedTuple):
    src: np.ndarray
    dst: np.ndarray
    w: np.ndarray
    wn: np.ndarray


def _host_path_graph(n: int, chain, weights=None) -> _HostPath:
    """The chain prior's edge list on the host (`ops.path.build_path_graph`,
    built on the CPU)."""
    import torch

    from ..ops.path import build_path_graph

    pg = build_path_graph(n, chain, weights, device=torch.device("cpu"))
    return _HostPath(*(t.numpy() for t in (pg.src, pg.dst, pg.w, pg.wn)))


class NativeEngine:
    """Host-side lattice: build + settle + U* + deltaH for small N."""

    def __init__(
        self,
        Y: np.ndarray,
        kneighbors: int = 6,
        row_cap_val: float = 1.0,
        lamG: float = 1.0,
        lamC: float = 0.5,
        lamQ: float = 4.0,
    ):
        self._lib = lib = load_engine()
        self.Y = np.ascontiguousarray(Y, dtype=np.float32)
        self.N, self.D = self.Y.shape
        self.k = min(int(kneighbors), max(1, self.N - 1))
        self.lamG, self.lamC, self.lamQ = float(lamG), float(lamC), float(lamQ)
        self.idx = np.zeros((self.N, self.k), dtype=np.int32)
        self.w = np.zeros((self.N, self.k), dtype=np.float32)
        self.sqrt_deg = np.zeros(self.N, dtype=np.float32)
        if self.N > 192:
            # BLAS similarity + C++ selection: sgemm runs ~10x the scalar
            # loop's flops/s at mid-size N
            Yn = self.Y / (np.linalg.norm(self.Y, axis=1, keepdims=True) + 1e-12)
            S = np.ascontiguousarray(Yn @ Yn.T, dtype=np.float32)
            self.n_edges = int(
                lib.osc_build_graph_from_sims(
                    S, self.N, self.k, np.float32(row_cap_val),
                    self.idx, self.w, self.sqrt_deg,
                )
            )
        else:
            self.n_edges = int(
                lib.osc_build_graph(
                    self.Y, self.N, self.D, self.k, np.float32(row_cap_val),
                    self.idx, self.w, self.sqrt_deg,
                )
            )
        self.U = self.Y.copy()
        self.psi = np.zeros(self.D, dtype=np.float32)
        self.B = np.ones(self.N, dtype=np.float32)
        self.lamP = 0.0
        self._path_src = np.zeros(0, dtype=np.int32)
        self._path_dst = np.zeros(0, dtype=np.int32)
        self._path_wn = np.zeros(0, dtype=np.float32)
        self._path_w = np.zeros(0, dtype=np.float32)
        self._chain_nodes: Optional[list] = None
        # U* / per-node caches, invalidated on any state change (psi, gates,
        # chain) — mirrors the lattice's signature-keyed U* cache
        # (core/lattice.py solve_Ustar); without them the serving flow paid
        # for THREE CG solves per request (receipt, per-node, bundle)
        self._ustar_cache: dict = {}
        self._pernode_cache: dict = {}

    def _invalidate(self) -> None:
        self._ustar_cache.clear()
        self._pernode_cache.clear()

    def set_query(self, psi: np.ndarray, gates: Optional[np.ndarray] = None) -> None:
        psi = np.ascontiguousarray(psi, dtype=np.float32)
        if psi.shape != (self.D,):
            # the C engine reads psi[0..D): a short buffer is an
            # out-of-bounds heap read, not a wrong answer
            raise ValueError(f"psi must have shape ({self.D},), got {psi.shape}")
        self.psi = psi
        self._invalidate()
        if gates is not None:
            gates = np.ascontiguousarray(gates, dtype=np.float32)
            if gates.shape != (self.N,):
                raise ValueError(
                    f"gates must have shape ({self.N},), got {gates.shape}"
                )
            self.B = gates

    def diffusion_gates(
        self,
        psi: Optional[np.ndarray] = None,
        *,
        beta: float = 1.0,
        gamma: float = 0.1,
        tol: float = 1e-4,
        max_iters: int = 256,
        apply: bool = False,
    ) -> np.ndarray:
        """Screened-diffusion gates over THIS engine's graph.

        Host-side counterpart of `OscillinkLattice.diffusion_gates`
        (preprocess/diffusion.py; reference diffusion.py:35-163): solve
        (L_sym + gamma I) h = beta * max(0, cos(Y, psi)) with single-RHS
        Jacobi-CG over the engine's k-sparse graph, min-max normalize with
        the uniform-ones fallback, clip to [0, 1].  ``psi`` defaults to the
        current query; ``apply=True`` installs the gates as B."""
        if gamma <= 0:
            raise ValueError("gamma must be > 0 for SPD")
        psi_h = (
            self.psi
            if psi is None
            else np.ascontiguousarray(psi, dtype=np.float32)
        )
        if psi_h.shape != (self.D,):
            raise ValueError(f"psi must have shape ({self.D},), got {psi_h.shape}")
        Yn = self.Y / (np.linalg.norm(self.Y, axis=1, keepdims=True) + 1e-12)
        psi_n = psi_h / (np.linalg.norm(psi_h) + 1e-12)
        s = np.ascontiguousarray(
            beta * np.maximum(0.0, Yn @ psi_n), dtype=np.float32
        )
        h = np.zeros(self.N, dtype=np.float32)
        res = ctypes.c_float(0.0)
        self._lib.osc_diffusion_solve(
            self.idx, self.w, self.sqrt_deg, s, self.N, self.k,
            np.float32(gamma), np.float32(tol), np.int32(max_iters),
            h, ctypes.byref(res),
        )
        if not np.all(np.isfinite(h)):
            h = np.ones(self.N, dtype=np.float32)
        else:
            h_min, h_max = float(h.min()), float(h.max())
            if h_max - h_min < 1e-12:
                h = np.ones(self.N, dtype=np.float32)
            else:
                h = ((h - h_min) / (h_max - h_min)).astype(np.float32)
        h = np.clip(h, 0.0, 1.0).astype(np.float32)
        if apply:
            self.B = np.ascontiguousarray(h)
            self._invalidate()
        return h

    def add_chain(self, chain, lamP: float = 0.2, weights=None) -> None:
        """Chain prior (reference add_chain semantics; ops/path.py build)."""
        pg = _host_path_graph(self.N, chain, weights)
        self._path_src = np.ascontiguousarray(pg.src, dtype=np.int32)
        self._path_dst = np.ascontiguousarray(pg.dst, dtype=np.int32)
        self._path_wn = np.ascontiguousarray(pg.wn, dtype=np.float32)
        self._path_w = np.ascontiguousarray(pg.w, dtype=np.float32)
        self._chain_nodes = [int(c) for c in chain]
        self.lamP = float(lamP)
        self._invalidate()

    def chain_receipt(self, chain, z_th: float = 2.5) -> dict:
        """Per-chain-edge z-scores + verdict (reference lattice.py:466-528;
        same math as ops/receipts.py:chain_edge_stats, host numpy).  Uses
        the INSTALLED path graph whenever one exists (even when ``chain``
        differs from the installed chain), falling back to an unweighted
        path over ``chain`` only when no chain is installed — the exact
        contract of the device lattice (core/lattice.py chain_receipt:
        ``pg = self._path if self._path is not None else ...``); pinned by
        the mismatched-chain parity test in tests/test_torch_native_engine.py."""
        chain = [int(c) for c in chain]
        if len(chain) < 2:
            raise ValueError("chain must contain at least two indices")
        if min(chain) < 0 or max(chain) >= self.N:
            raise ValueError("chain indices out of bounds")
        Ustar, _, _ = self.solve_ustar()
        n = self.N
        inv_sd = (1.0 / (self.sqrt_deg + 1e-12)).astype(np.float32)
        Un = Ustar * inv_sd[:, None]

        # structural residual row moments over dense-N columns
        d2 = np.sum((Un[:, None, :] - Un[self.idx]) ** 2, axis=2)
        R = self.lamC * self.w * d2
        mu = R.sum(axis=1) / n
        var = np.maximum((R * R).sum(axis=1) / n - mu * mu, 0.0)
        sigma = np.sqrt(var) + 1e-12

        # path-residual row moments
        if len(self._path_src):
            src, dst, pw = self._path_src, self._path_dst, self._path_w
        else:
            pg = _host_path_graph(self.N, chain)
            src = np.asarray(pg.src, dtype=np.int32)
            dst = np.asarray(pg.dst, dtype=np.int32)
            pw = np.asarray(pg.w, dtype=np.float32)
        lamC_p = max(self.lamC, 1e-6)
        dsq_path = np.sum((Un[src] - Un[dst]) ** 2, axis=1)
        Rp = (lamC_p * pw * dsq_path).astype(np.float64)
        off_diag = np.where(src == dst, 0.0, Rp)
        s1 = np.zeros(n, np.float64)
        np.add.at(s1, src, Rp)
        np.add.at(s1, dst, off_diag)
        s2 = np.zeros(n, np.float64)
        np.add.at(s2, src, Rp * Rp)
        np.add.at(s2, dst, off_diag * off_diag)
        mu_p = s1 / n
        var_p = np.maximum(s2 / n - mu_p * mu_p, 0.0)
        sig_p = np.sqrt(var_p) + 1e-12

        ci = np.array(chain[:-1], dtype=np.int64)
        cj = np.array(chain[1:], dtype=np.int64)
        d2_c = np.sum((Un[ci] - Un[cj]) ** 2, axis=1)
        hit = self.idx[ci] == cj[:, None]
        w_c = np.sum(np.where(hit, self.w[ci], 0.0), axis=1)
        r_struct = self.lamC * w_c * d2_c
        z_struct = (r_struct - mu[ci]) / sigma[ci]
        key_i = np.minimum(ci, cj)
        key_j = np.maximum(ci, cj)
        hit_p = (src[None, :] == key_i[:, None]) & (dst[None, :] == key_j[:, None])
        wp_c = np.sum(np.where(hit_p, pw[None, :], 0.0), axis=1)
        r_path = lamC_p * wp_c * d2_c
        z_path = (r_path - mu_p[ci]) / sig_p[ci]

        Ynorm = self.Y / (self.sqrt_deg + 1e-12)[:, None]
        ydiff2 = np.sum((Ynorm[ci] - Ynorm[cj]) ** 2, axis=1)
        gain = np.sum(0.5 * self.lamC * np.maximum(w_c, 0.0) * (ydiff2 - d2_c))
        return chain_receipt_body(chain, z_struct, z_path, r_struct, r_path, gain, z_th)

    def clear_chain(self) -> None:
        self.lamP = 0.0
        self._path_src = np.zeros(0, dtype=np.int32)
        self._path_dst = np.zeros(0, dtype=np.int32)
        self._path_wn = np.zeros(0, dtype=np.float32)
        self._path_w = np.zeros(0, dtype=np.float32)
        self._chain_nodes = None
        self._invalidate()

    def settle(self, dt=1.0, max_iters=12, tol=1e-3):
        out = np.zeros_like(self.U)
        res = ctypes.c_float(0.0)
        if self.lamP > 0 and len(self._path_src):
            iters = self._lib.osc_settle_chain(
                self.idx, self.w, self.sqrt_deg, self.U, self.Y, self.psi,
                self.B, self.N, self.k, self.D, np.float32(self.lamG),
                np.float32(self.lamC), np.float32(self.lamQ),
                np.float32(self.lamP), np.int32(len(self._path_src)),
                self._path_src, self._path_dst, self._path_wn,
                np.float32(dt), np.float32(tol), np.int32(max_iters),
                out, ctypes.byref(res),
            )
        else:
            iters = self._lib.osc_settle(
                self.idx, self.w, self.sqrt_deg, self.U, self.Y, self.psi, self.B,
                self.N, self.k, self.D, np.float32(self.lamG), np.float32(self.lamC),
                np.float32(self.lamQ), np.float32(dt), np.float32(tol),
                np.int32(max_iters), out, ctypes.byref(res),
            )
        self.U = out
        return {"iters": int(iters), "res": float(res.value)}

    def solve_ustar(self, tol=1e-4, max_iters=64, use_cache: bool = True):
        key = (float(tol), int(max_iters))
        if use_cache and key in self._ustar_cache:
            return self._ustar_cache[key]
        out = np.zeros_like(self.Y)
        res = ctypes.c_float(0.0)
        if self.lamP > 0 and len(self._path_src):
            iters = self._lib.osc_solve_ustar_chain(
                self.idx, self.w, self.sqrt_deg, self.Y, self.psi, self.B,
                self.N, self.k, self.D, np.float32(self.lamG),
                np.float32(self.lamC), np.float32(self.lamQ),
                np.float32(self.lamP), np.int32(len(self._path_src)),
                self._path_src, self._path_dst, self._path_wn,
                np.float32(tol), np.int32(max_iters), out, ctypes.byref(res),
            )
        else:
            iters = self._lib.osc_solve_ustar(
                self.idx, self.w, self.sqrt_deg, self.Y, self.psi, self.B,
                self.N, self.k, self.D, np.float32(self.lamG), np.float32(self.lamC),
                np.float32(self.lamQ), np.float32(tol), np.int32(max_iters),
                out, ctypes.byref(res),
            )
        result = (out, int(iters), float(res.value))
        if use_cache:
            # the cached buffer is handed to every caller: freeze it so an
            # in-place mutation raises instead of corrupting later receipts
            out.flags.writeable = False
            self._ustar_cache[key] = result
        return result

    def deltaH(self, U: np.ndarray, Ustar: np.ndarray) -> float:
        Uc = np.ascontiguousarray(U, dtype=np.float32)
        Us = np.ascontiguousarray(Ustar, dtype=np.float32)
        if self.lamP > 0 and len(self._path_src):
            return float(
                self._lib.osc_deltaH_chain(
                    self.idx, self.w, self.sqrt_deg, Uc, Us, self.B,
                    self.N, self.k, self.D, np.float32(self.lamG),
                    np.float32(self.lamC), np.float32(self.lamQ),
                    np.float32(self.lamP), np.int32(len(self._path_src)),
                    self._path_src, self._path_dst, self._path_wn,
                )
            )
        return float(
            self._lib.osc_deltaH(
                self.idx, self.w, self.sqrt_deg, Uc, Us,
                self.B, self.N, self.k, self.D,
                np.float32(self.lamG), np.float32(self.lamC), np.float32(self.lamQ),
            )
        )

    def per_node(self, Ustar: np.ndarray):
        cached = self._pernode_cache.get("entry")
        # identity check holds a reference to the keyed array, so a freed
        # id can never alias a new allocation
        if cached is not None and cached[0] is Ustar:
            return cached[1]
        coh = np.zeros(self.N, dtype=np.float32)
        anchor = np.zeros(self.N, dtype=np.float32)
        query = np.zeros(self.N, dtype=np.float32)
        self._lib.osc_per_node(
            self.idx, self.w, self.sqrt_deg, self.Y,
            np.ascontiguousarray(Ustar, dtype=np.float32), self.B, self.psi,
            self.N, self.k, self.D, np.float32(self.lamG), np.float32(self.lamC),
            np.float32(self.lamQ), coh, anchor, query,
        )
        # keyed by Ustar object identity: the cached-U* path hands the same
        # array back, so receipt + bundle share one computation; a mutated
        # in-place array would be a caller bug (none mutate)
        self._pernode_cache = {"entry": (Ustar, (coh, anchor, query))}
        return coh, anchor, query

    def null_points(self, Ustar: np.ndarray, z_th: float = 3.0):
        j = np.zeros(self.N, dtype=np.int32)
        z = np.zeros(self.N, dtype=np.float32)
        r = np.zeros(self.N, dtype=np.float32)
        flag = np.zeros(self.N, dtype=np.uint8)
        self._lib.osc_null_points(
            self.idx, self.w, self.sqrt_deg,
            np.ascontiguousarray(Ustar, dtype=np.float32), self.N, self.k,
            self.D, np.float32(self.lamC), np.float32(z_th), j, z, r, flag,
        )
        from .listing import list_flagged  # listing.py imports this module

        return list_flagged(flag, j, z, r)

    def bundle(
        self, k: int = 8, alpha: float = 0.5, *, diversify: bool = True
    ) -> list[dict]:
        """Bundle picks (host numpy; small N by construction).

        ``diversify=True`` is the MMR contract; ``diversify=False`` is the
        pure-relevance rerank mode — top-k by score with lowest-index
        tie-break, matching the device lattice's bundle
        (core/lattice.py bundle)."""
        Ustar, _, _ = self.solve_ustar()
        u_norm = np.linalg.norm(Ustar, axis=1, keepdims=True) + 1e-12
        psi_n = self.psi / (np.linalg.norm(self.psi) + 1e-12)
        align = (Ustar / u_norm) @ psi_n
        coh, _, _ = self.per_node(Ustar)
        sigma = float(np.std(coh)) + 1e-12
        z = (coh - float(np.mean(coh))) / sigma
        score = alpha * z + (1 - alpha) * align
        k_eff = min(k, self.N)
        if diversify:
            Yn = self.Y / (np.linalg.norm(self.Y, axis=1, keepdims=True) + 1e-12)
            from ..ops.graph import mmr_select_np

            chosen = mmr_select_np(Yn, score.astype(np.float32), k_eff)
        else:
            chosen = np.argsort(-score, kind="stable")[:k_eff]
        return [
            {"id": int(i), "score": float(score[i]), "align": float(align[i])}
            for i in chosen
        ]

    def bundle_batch(
        self,
        psis: np.ndarray,
        gates: Optional[np.ndarray] = None,
        k: int = 8,
        alpha: float = 0.5,
        *,
        diffusion: Optional[dict] = None,
    ) -> list[list[dict]]:
        """Bundles for Q queries over this engine's shared graph — the host
        counterpart of `OscillinkLattice.bundle_batch`.  ``gates`` is an
        optional [Q, N] block; ``diffusion`` (dict of beta/gamma/tol/
        max_iters) derives gates per query instead, mirroring the device
        batch's `diffusion_gates_batch` semantics.  The graph is built
        once (ctor); each query pays one stationary solve."""
        psis = np.asarray(psis, dtype=np.float32)
        out: list[list[dict]] = []
        for qi in range(psis.shape[0]):
            psi = np.ascontiguousarray(psis[qi])
            if diffusion is not None:
                self.set_query(psi)
                self.diffusion_gates(
                    beta=float(diffusion.get("beta", 1.0)),
                    gamma=float(diffusion.get("gamma", 0.1)),
                    tol=float(diffusion.get("tol", 1e-4)),
                    max_iters=int(diffusion.get("max_iters", 256)),
                    apply=True,
                )
            else:
                g_i = (
                    np.ascontiguousarray(gates[qi], dtype=np.float32)
                    if gates is not None
                    else np.ones(self.N, dtype=np.float32)
                )
                self.set_query(psi, gates=g_i)
            out.append(self.bundle(k=k, alpha=alpha))
        return out

    def dense_adjacency(self) -> np.ndarray:
        A = np.zeros((self.N, self.N), dtype=np.float32)
        for i in range(self.N):
            for a in range(self.k):
                if self.w[i, a] > 0:
                    A[i, self.idx[i, a]] = self.w[i, a]
        return A
