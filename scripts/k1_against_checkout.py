"""Kernel K1 without ``src`` against another checkout's K1 on the card, bit
for bit.

    python3 scripts/k1_against_checkout.py --repo PATH

Compiles PATH's ``oscillink_tpu_torch/csrc/spmv.cu`` with this checkout's
``nvcc`` command (`build.nvcc_command`) into a temporary directory, then
launches this checkout's wrapper, ``lap_matvec_cuda(idx, wn, X,
slab_cols=...)``, and the other library's entry on the same inputs: its
``oscillink_spmv_gather_src`` with the source X, or, in a checkout from
before K1 took a source, its ``oscillink_spmv_gather``.  The inputs are
random graphs (ids uniform in [0, N), weights U[0, 0.2)) at the corpus
(131072 x 768 x k8) and 1M (1,000,000 x 768 x k8) shapes and at odd ones
(4099 x 97 x 5, 333 x 130 x 1, 1000 x 64 x 40), each at the slab plan's
width and at D.  Prints one JSON line (the card, every case's shape, slab
width and whether the outputs are bit-equal) and exits 1 if any differ.
Needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from oscillink_tpu_torch.ops.kernels import build as kbuild  # noqa: E402
from oscillink_tpu_torch.ops.kernels import spmv  # noqa: E402

SHAPES = ((131072, 768, 8), (1_000_000, 768, 8), (4099, 97, 5), (333, 130, 1), (1000, 64, 40))
SCALARS = [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]


def _other_launcher(path: str):
    """The other library's K1 as ``f(idx, wn, X, slab) -> out``."""
    lib = ctypes.CDLL(path)
    two_source = hasattr(lib, "oscillink_spmv_gather_src")
    fn = lib.oscillink_spmv_gather_src if two_source else lib.oscillink_spmv_gather
    fn.argtypes = [ctypes.c_void_p] * (5 if two_source else 4) + SCALARS
    fn.restype = ctypes.c_int

    def launch(idx, wn, X, slab: int) -> torch.Tensor:
        out = torch.empty_like(X)
        ptrs = [idx.data_ptr(), wn.data_ptr(), X.data_ptr()]
        ptrs += [X.data_ptr(), out.data_ptr()] if two_source else [out.data_ptr()]
        rc = fn(*ptrs, idx.shape[0], idx.shape[1], X.shape[1], slab,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out

    return launch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", required=True, help="the other checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_against_checkout: no CUDA card", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "spmv_other.so")
        src = os.path.join(args.repo, "oscillink_tpu_torch", "csrc", "spmv.cu")
        subprocess.run(kbuild.nvcc_command(src, so), check=True, capture_output=True, text=True)
        other = _other_launcher(so)
        gen = torch.Generator(device="cuda").manual_seed(0)
        cases, ok = [], True
        for n, d, k in SHAPES:
            idx = torch.randint(0, n, (n, k), generator=gen, device="cuda", dtype=torch.int32)
            wn = 0.2 * torch.rand((n, k), generator=gen, device="cuda")
            X = torch.randn((n, d), generator=gen, device="cuda")
            plan = spmv.slab_plan(n, d, k, spmv.device_l2_bytes(0))
            for slab in sorted({plan, d}):
                equal = torch.equal(spmv.lap_matvec_cuda(idx, wn, X, slab_cols=slab),
                                    other(idx, wn, X, slab))
                ok &= equal
                cases.append({"n": n, "d": d, "k": k, "slab_cols": slab, "bit_equal": equal})
            del idx, wn, X
            torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "other": args.repo,
                      "bit_equal": ok, "cases": cases}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
