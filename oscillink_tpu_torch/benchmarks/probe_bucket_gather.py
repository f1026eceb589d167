"""Feasibility probe for the edge-centric bucket-shuffle matvec, on the card.

Port of ``benchmarks/probe_bucket_gather.py``.  The two-pass design it asks
about:

  stage 1  bucket the source rows S = 4096 at a time, gather each bucket's
           edge contributions on chip, and write them sequentially to a
           staging array in (bucket, edge) order — kernel K5,
           `oscillink_tpu_torch.ops.kernels.bucket_gather`;
  stage 2  reduce each destination row's K contributions.

Every device-memory access of stage 1 is then sequential, and the random
access stays on chip: on the TPU in VMEM, on this card in the 50 MB L2.
The probe measures stage 1 alone at the JAX probe's shape — N = 31 x 4096 =
126976 rows (the 1M/8 shard), D = 768 (``OSC_PROBE_D``), K = 8, E = N * K =
1015808 edges, isotropic random sources in bucket-major order, drawn from
numpy ``default_rng(0)`` in the JAX probe's order, so the inputs are its
own — against:

* the flat gather ``X.index_select(0, src)`` on the same edges (the
  incumbent; on the TPU the XLA gather);
* the same gather on sorted ids;
* a scatter-add stage 2, ``zeros(N, D).index_add_(0, dst, staged)``, timed
  only: its atomics make the order of the sums vary;
* ``F.embedding_bag`` with bags of one, the one library call that computes
  K5's function, and K5's plain version.

Decision rule (the JAX probe's): build the two-pass matvec only if the bucket
gather beats the flat gather by at least 2x, since stage 2 reads the staged
array once more.

Timing departs from the JAX probe on purpose.  Each time is the median over
3 groups of the CUDA-event mean of a run of calls (host ``perf_counter`` on
the CPU, where the numbers say nothing of the card).  The JAX probe timed the
slope (T24 - T4) / 20 of a ``fori_loop`` whose every step scaled X by a
factor fed back from the last result (``X * scale``): that hid the TPU's
dispatch and kept XLA from hoisting the loop body, but it added an
elementwise pass over X to every timing.  PyTorch launches each call
eagerly, so neither is needed here and the chain is left out.

    python3 -m oscillink_tpu_torch.benchmarks.probe_bucket_gather [--device cpu]

prints one JSON line and writes no file.  It runs on ``cuda`` and raises
without it unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.kernels.bucket_gather import ETILE, S, bucket_gather, bucket_gather_ref, global_rows
from ..utils.device import DeviceLike, resolve_device

__all__ = ["check_correct", "iso_case", "main", "measure", "probe_tensors", "random_case"]

K = 8
N_BUCKETS = 31
REPS = 10  # calls per timed group: 10-40 ms of card time per group at the full size
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
DECISION_RULE = ("build the two-pass matvec only if bucket_gather beats the flat gather by "
                 ">=2x (the staging round-trip costs one extra staged read later)")


def random_case(n_buckets: int, d: int, e_pad: int, seed: int = 0):
    """The JAX probe's correctness draw (``check_correct``): X [n_buckets*S, d],
    bucket-local ids uniform in [0, S) and weights in [0, 1), [E, 1] each."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n_buckets * S, d)).astype(np.float32)
    li = rng.integers(0, S, size=(n_buckets * e_pad, 1)).astype(np.int32)
    w = rng.random((n_buckets * e_pad, 1)).astype(np.float32)
    return X, li, w


def iso_case(d: int, n_buckets: int = N_BUCKETS, seed: int = 0) -> dict:
    """The JAX probe's measurement draw: N = n_buckets * S rows, E = N * K
    random sources sorted stably by bucket, read as n_buckets equal buckets
    of e_pad = S * K edges (near a bucket's edge an edge may gather from the
    wrong bucket's row: the same work, and fine for a bandwidth probe)."""
    rng = np.random.default_rng(seed)
    n = n_buckets * S
    e = n * K
    X = rng.standard_normal((n, d)).astype(np.float32)
    src = rng.integers(0, n, size=e).astype(np.int32)
    order = np.argsort(src // S, kind="stable")
    local_idx = (src[order] % S).astype(np.int32)[:, None]
    w = rng.random((e, 1)).astype(np.float32)
    return {"X": X, "local_idx": local_idx, "w": w, "src": src, "src_asc": np.sort(src),
            "dst": order // K}


def probe_tensors(device: DeviceLike, d: int, n_buckets: int = N_BUCKETS, seed: int = 0) -> dict:
    """`iso_case` on ``device``: the tensors `measure` runs on."""
    dev = resolve_device(device)
    case = iso_case(d, n_buckets, seed)
    return {**{key: torch.from_numpy(val).to(dev) for key, val in case.items()},
            "n_buckets": n_buckets}


def check_correct(device: DeviceLike = "cuda") -> float:
    """The JAX probe's check: 2 buckets, D = 128, e_pad = 2 * ETILE through
    `bucket_gather` on ``device``, held exactly to the global-index form in
    NumPy.  Returns the max abs error (0.0) or raises."""
    dev = resolve_device(device)
    n_buckets, e_pad = 2, 2 * ETILE
    X, li, w = random_case(n_buckets, 128, e_pad)
    got = bucket_gather(*(torch.from_numpy(a).to(dev) for a in (X, li, w)), n_buckets)
    glob = li[:, 0] + (np.arange(n_buckets * e_pad) // e_pad) * S
    err = float(np.abs(got.cpu().numpy() - X[glob] * w).max())
    if err != 0.0:
        raise RuntimeError(f"bucket_gather mismatch: {err}")
    return err


def time_ms(fn, device: torch.device, reps: int, groups: int = 3) -> float:
    """Median over ``groups`` of the mean time of ``reps`` calls, after one
    warm-up call: CUDA events on a card, the host clock on the CPU."""
    fn()
    out = []
    for _ in range(groups):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / reps)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            out.append(1e3 * (time.perf_counter() - t0) / reps)
    return statistics.median(out)


def _card(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"device": "cpu"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return {"device": torch.cuda.get_device_name(device), "nvidia_smi": smi}


def measure(device: DeviceLike = "cuda", d: int = 768, n_buckets: int = N_BUCKETS,
            inputs: dict | None = None) -> dict:
    """Time stage 1 and its yardsticks on ``device`` at the probe's shape
    (``d`` wide, ``n_buckets`` buckets; ``inputs`` from `probe_tensors`
    skips the draw) and apply the decision rule.  ``bound_ms`` is the
    H100's least time for K5's work: its bytes over 3.35 TB/s against its
    multiplies over 67 TFLOP/s, the larger."""
    dev = resolve_device(device)
    t = inputs if inputs is not None else probe_tensors(dev, d, n_buckets)
    X, li, w, n_buckets = t["X"], t["local_idx"], t["w"], t["n_buckets"]
    n, d = X.shape
    e = li.shape[0]
    e_pad = e // n_buckets

    def timed(fn):
        return time_ms(fn, dev, REPS)

    ms = timed(lambda: bucket_gather(X, li, w, n_buckets))
    plain_ms = timed(lambda: bucket_gather_ref(X, li, w, n_buckets))
    flat_ms = timed(lambda: X.index_select(0, t["src"]))
    sorted_ms = timed(lambda: X.index_select(0, t["src_asc"]))
    staged = bucket_gather(X, li, w, n_buckets)
    seg_ms = timed(lambda: torch.zeros(n, d, device=dev).index_add_(0, t["dst"], staged))
    glob = global_rows(li, n_buckets)
    offsets = torch.arange(e, device=dev)
    w1 = w[:, 0]

    def library():
        return F.embedding_bag(glob, X, offsets, mode="sum", per_sample_weights=w1)

    lib_diff = float((library() - staged).abs().max())
    lib_ms = timed(library)
    del staged

    gb_out, gb_x = e * d * 4 / 1e9, n * d * 4 / 1e9
    nbytes = (e * d + n * d + 2 * e) * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, e * d / F32_FLOPS
    speedup = flat_ms / ms
    return {
        "config": f"N={n} D={d} K={K} iso edges; buckets S={S} ETILE={ETILE} "
                  f"n_buckets={n_buckets} e_pad={e_pad}",
        **_card(dev),
        "bucket_gather_ms": ms,
        "bucket_gather_effective_gbps": (gb_out + gb_x) / ms * 1e3,
        "bucket_gather_plain_ms": plain_ms,
        "flat_gather_ms": flat_ms,
        "sorted_gather_ms": sorted_ms,
        "segment_sum_ms": seg_ms,
        "embedding_bag_ms": lib_ms,
        "embedding_bag_max_abs_diff": lib_diff,
        "bound_ms": 1e3 * max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "traffic_model_gb": {"staged_out": gb_out, "x_stream": gb_x,
                             "ids_weights": 2 * e * 4 / 1e9},
        "decision_rule": DECISION_RULE,
        "speedup_vs_flat_gather": speedup,
        "decision": "build" if speedup >= 2.0 else "do not build",
        "method": (f"{'CUDA-event' if dev.type == 'cuda' else 'host-clock'} median of 3 "
                   f"groups of {REPS} calls, no X * scale chain"),
    }


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    check_correct(dev)
    print("# correctness: exact", flush=True)
    d = int(os.getenv("OSC_PROBE_D", "768"))
    print(json.dumps(measure(dev, d=d)), flush=True)


if __name__ == "__main__":
    main()
