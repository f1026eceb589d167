"""Smoke run of the PyTorch port on one CUDA card (an H100 for this port).

    python3 chip_smoke.py

Builds kernels K1 (``oscillink_tpu_torch/csrc/spmv.cu``), K2, K3 and K4
(``csrc/window_spmv3f.cu``, three variants of one gather kernel), K5
(``csrc/bucket_gather.cu``), the CG's fused passes
(``csrc/cg_fused.cu``) and the edge distances (``csrc/edge_dists.cu``)
from the checkout, one ``nvcc`` per source, all started together, and holds each against its plain PyTorch version (K1
also bit-equal from launch to launch and across forced column-slab widths,
and its slab widths swept and timed in turns at the corpus shape, at
262144 and 524288 rows and at 1M rows of 768, 192 and 96 columns; K2-K4
against the one-hot form and their own gather forms, and bit-equal from
launch to launch; on a NaN and an infinity in window rows no row
references, to the gather forms' semantics).  Then it drives the paths
through the public entry points:

* the gather path (K1): quickstart and headline against the port's CPU path,
  and the 131072 x 768 x k8 corpus;
* the windowed tier (``OSCILLINK_WINDOWED_MATVEC=1``): a locality-ordered
  131072 x 768 x k8 corpus through K4, held to the gather path on the same
  corpus; a clustered corpus with stragglers through K4 (fused) and K3
  (``OSCILLINK_WINDOWED_FUSED=0``); and a D = 97 lattice through K2 and its
  straggler epilogue, each held to the port's CPU path (the straggler
  corpora with the low-coverage retry's window set to 768); the card's
  window contexts must hold no one-hot;
* the windowed tier's routing under ``auto`` (``window_routing``): the
  default environment on the locality and Gaussian corpora at 131072 and
  the locality corpus at 16384, each decision held to the rule of the
  constants in force and to the route PERF.md's sweep gives (gather: the
  card's MIN_N is never reached), its launches to that route; the unforced
  branches driven under the JAX package's values, accepted on coverage
  (locality) and on bounded stragglers (clustered) through K4 and held to
  the gather flow, refused on the Gaussian corpus, and at 16384 against
  the CPU lattice on the card's graph; and `solve_auto`
  (``window_routing_halo``): under the default environment the gather halo
  tier on the locality and clustered corpora ("low coverage", no shard plan
  built), under the JAX package's values the windowed halo tier (K3) on
  both (coverage; bounded stragglers), held to the gather halo tier on the
  same graph and, on the locality corpus, to the single-device solve on
  `solve_auto`'s own graph, with the neighbour lists that differ from a
  graph built in the original row order counted;
* the bucket-shuffle probe (K5, ``oscillink_tpu_torch.benchmarks.
  probe_bucket_gather``) at its full size, 126976 x 768 with 1015808 edges;
* the multi-query serving paths, all through K1 (held to its plain version
  at their widths first: D = 1, 16, 3, the ragged union graph and Q·D =
  6144): the batched lattice (``solve_Ustar_batch``, ``bundle_batch``)
  against the port's CPU path; the /v1/bundle batch path at the corpus
  (``diffusion_gates_batch``, ``bundle_batch`` for 8 queries) against the 8
  single solves; standalone diffusion gates (dense direct and CG) and the
  corpus lattice's ``diffusion_gates`` against the CPU; ``bundle_ragged``
  at the /v1/bundle/ragged shape against each corpus served alone; and the
  one-shot light receipt against the lattice's.  Each solve's K1 launches
  must equal 1 + its slowest lane's iterations;
* ``similarity="auto"``, the service's default, all through K1: the bf16
  scan's routes held to f64 and timed; at 131072 x 768 x k8 auto resolves
  to the fast scan, held to the exact graph of the same run (``"fastest"``
  and ``rebuild_graph(similarity="fast")`` give its bits); the blocked fast
  path (16384 x 768), the IVF build (65536 x 128) and the seeded host build
  (8192 x 128) each against the port's CPU path; the cluster tier at 524288
  x 768 x k8, accepted as IVF on the JAX package's loose study corpus, its
  tight corpus and an isotropic one built too; export and import (JSON
  state, NPZ) on the card against the CPU;
* the low-memory and column-chunked solves at the JAX package's 1M study
  shape (``million``: 1,000,000 x 768 x k8 on its loose IVF corpus, auto
  resolving to an accepted IVF build): the full flow full width, then
  settle, U* and the full receipt on the same graph under
  ``OSCILLINK_COL_CHUNKS`` = 4 and 8, held to the full-width run with the
  JAX package's bars; the classic and the low-memory CG on the same
  inputs (identical iterations, U within 1e-6 of max|U|); every step's
  peak under the working-set model's estimate, and its K1 launches equal
  to its operator applies; K1 against plain at the chunk widths 192 and
  96;
* the windowed tier under column chunks (``windowed_chunked``): the
  locality-ordered corpus at c = 2 (K4 fused, K3 unfused, at 384 columns)
  and c = 8 (K2 and its epilogue at 96) against the full-width windowed
  run, the kernels against their plain versions at those widths, and the
  straggler corpus card against CPU at each.

* the service (``oscillink_tpu_torch.service``) on the card: its warmup
  for 5000 x 768 x k8 in two fresh processes sharing an empty kernel build
  directory (``OSCILLINK_COMPILE_CACHE_DIR``: the first builds K1, the
  second loads it); the verify skill's quickstart payload through
  /v1/settle, /v1/receipt, /v1/bundle and /v1/chain/receipt; every compute
  route at the service's full size (5000 x 768 x k8: settle with a signed
  receipt and a bundle, bundle, chain receipt, settle batch of 8 queries,
  ragged bundle of 4 corpora, a diffusion-gated settle under a pro key, a
  job polled to completion, a graph-cache hit), each timed cold and once
  warm and split
  into parse, lattice and encode; each response held against the service
  on the CPU; and the quickstart /v1/settle through the aiohttp binding on
  127.0.0.1 when aiohttp is installed.
* the service's native small-N route (``native_route``) at the deploy
  image's ``OSCILLINK_NATIVE_SMALL_N=2048`` with a 2048 x 768 x k8 request
  on /v1/settle, /v1/bundle (MMR and rerank), /v1/chain/receipt and
  /v1/settle/batch: native against the same service's device route (the
  JAX package's bars) and against the native route of the service on the
  CPU (equal bodies apart from timings), warm host ms of both routes;
* the CLI (``cli_corpus``): ``settle`` with a bundle and the debug report
  on a 131072 x 768 .npz in this process against the same flow through the
  library, and ``python -m oscillink_tpu_torch.cli settle --diffusion
  --rerank`` in fresh processes on the card and on the CPU; the profiler
  (``profiling``: a Chrome trace of a corpus settle holds K1's kernel,
  ``device_memory_stats`` against ``max_memory_allocated``); text ingestion
  (``texts``: ``from_texts`` on the repo's synth3k corpus through the hash
  embeddings and the registry's LSA provider, card against CPU); and the
  checkpoint of the ``million`` lattice (``checkpoint_million``: saved,
  restored on the card with no graph build, bit-equal, the same
  iterations and ΔH).
* the mesh tiers (``oscillink_tpu_torch.parallel``), 4 shards on cuda:0 —
  a code path with real halo exchanges and per-shard launches, not a
  multi-card speed: inside ``million``, ``sharded_million`` (the
  all-gather tier's `shardmap_solve`, the PCA-bisection order, halo plan
  and `halo_solve`, and `sharded_serve(graph=)` with a bundle and a chain,
  each held to the same run's single-device U* and receipt; K1's ``src``
  form held to its plain version and timed at a 250000-row shard against
  the 1M source and at the halo frame, bit-equal to the one-source form
  where it computes the same rows); ``halo_windowed`` (131072 x 768 on the
  locality corpus through K3 a shard, 16384 x 97 through K2, against the
  gather halo tier and the single-device solve); ``solve_auto_corpus``
  (131072 x 768 x k8, a clustered and a Gaussian corpus, the tier held to
  the measured halo); ``service_sharded`` (the flagship request at
  ``OSCILLINK_SHARDED_MIN_N=4096``: settle, bundle, chain receipt and a job
  against the device route and the CPU service on 4 CPU shards); and
  ``hierarchical_streaming`` (8 shards of 16384 rows, the stream's shard
  receipts equal to the batch tier's; card against CPU at 16384, each
  shard's ΔH within 1e-5 on the card's graph).  Each
  shard apply counts its launches: K1 once (twice on the gather halo
  tier), K3 or K2 once on the windowed halo tier.

* the CG's fused passes (``csrc/cg_fused.cu``, ``cg_fused``): each held to
  its plain twin at 171332 and 522931 x 768 (the corpus cells), 500 x 768,
  4099 x 97 and 5000 x 1 (x, r, p and Ap bit-equal, column sums within one
  ulp of float64 sums, bit-equal from launch to launch) and timed against
  its byte bound; the corpus flow at 171332 x 768 x k8 through them: U* and
  a settle step twice, bit-equal, 3 + 6 launches an iteration, no classic
  iteration, the classic body's iterations and U within 1e-6.

* the edge distances (``csrc/edge_dists.cu``, ``edge_dists``): held to
  their plain version (within 1e-6 of each edge; scaled and not; at the
  plan's slab width and at 32 columns; bit-equal on a second launch) at
  1000 x 768 x k6, 5000 x 768 x k8, 4099 x 97 x k13, 3001 x 3 x k5 and
  the corpus cells' 171332 and 522931 x 768 x k8 on random graphs; a lane
  view of an [N, 8, D] block equal to its contiguous copy; one launch
  counted a call; timed against their byte bound beside the plain
  version, each call's peak allocation within the working-set model's
  term for it (``edge_dists.scratch_bytes``); their launches counted on
  the corpus flow (3 a full receipt, 2 a bundle, 1 a chain receipt, none
  a light receipt) and on the batch paths (2 a lane of ``bundle_batch``,
  2 a single bundle).

Each path runs with every launch count set to 0 just before it and read just
after.  Every check that fails raises, so the script exits non-zero; it
never falls back to the CPU.  Without CUDA it exits 1 before printing any
result.

Output: the card's name and power limit (as nvidia-smi reports them), one
JSON line per phase, the ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import contextlib
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings
from pathlib import Path

import numpy as np
import torch

from oscillink_tpu_torch import Oscillink, compute_diffusion_gates
from oscillink_tpu_torch import cli as tcli
from oscillink_tpu_torch.adapters.registry import resolve_provider
from oscillink_tpu_torch.benchmarks import probe_bucket_gather as probe
from oscillink_tpu_torch.benchmarks.window_routing import (
    clustered_corpus,
    env,
    gaussian_corpus as data,
    locality_corpus,
)
from oscillink_tpu_torch.core import lattice as tlattice
from oscillink_tpu_torch.core.lattice import _locality_order
from oscillink_tpu_torch.models import coherence as tcoh
from oscillink_tpu_torch.models import ragged as tragged
from oscillink_tpu_torch.models.batched import union_graph
from oscillink_tpu_torch.models.oneshot import settle_receipt_light
from oscillink_tpu_torch.preprocess.diffusion import diffusion_sources, screened_solve
from oscillink_tpu_torch.ops import graph as tgraph
from oscillink_tpu_torch.ops import ivf as tivf
from oscillink_tpu_torch.ops.graph import build_graph, graph_from_topk, lap_matvec, normalize_rows
from oscillink_tpu_torch.ops import solver as tsolver
from oscillink_tpu_torch.ops.kernels import bucket_gather as bg
from oscillink_tpu_torch.ops.kernels import cg_fused
from oscillink_tpu_torch.ops.kernels import edge_dists
from oscillink_tpu_torch.ops.kernels import build as kbuild
from oscillink_tpu_torch.ops.kernels import spmv
from oscillink_tpu_torch.ops.kernels import window_spmv as tw
from oscillink_tpu_torch.ops.path import build_path_graph
from oscillink_tpu_torch.ops.receipts import deltaH_tree_np
from oscillink_tpu_torch import parallel as tpar
from oscillink_tpu_torch.parallel import halo_cg as thalo
from oscillink_tpu_torch.parallel import mesh as tmesh
from oscillink_tpu_torch.parallel import serve as tserve
from oscillink_tpu_torch.parallel import sharded_build as tshbuild
from oscillink_tpu_torch.parallel import shardmap_cg as tsmcg
from oscillink_tpu_torch.core.receipts import canonical_json, verify_receipt
from oscillink_tpu_torch.service import LocalClient, create_state
from oscillink_tpu_torch.service import api as tapi
from oscillink_tpu_torch.service import config as tconfig
from oscillink_tpu_torch.service.warmup import run_warmup
from oscillink_tpu_torch.utils.debug_report import generate_debug_report
from oscillink_tpu_torch.utils.profiling import device_memory_stats, recording
from oscillink_tpu_torch.utils.profiling import trace as profiler_trace

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM bf16 tensor cores, dense
TOL = 1e-5  # kernel vs plain: same K order, the gap is FMA contraction only
# K2-K4 vs the one-hot plain versions, relative to max|plain|: the kernels'
# gather-form products differ from the one-hot form's bf16 passes by about
# 2^-16 each (csrc/window_spmv3f.cu)
WIN_TOL = 1e-5
PAP_TOL = 1e-4  # K4's column partials: sums over 384 rows, then over blocks
# K2-K4 vs their gather-form plain versions: the same products in the same
# order, relative to max|plain|; only FMA contraction differs.  K4's
# partials sum 384 rows per block in the kernel's lane-and-warp order, the
# plain version in torch.sum's.
GATHER_TOL = 1e-6
GATHER_PAP_TOL = 1e-5
LATTICE_TOL = 1e-5  # deltaH, card vs the port's CPU path
WINDOWED_VS_GATHER_TOL = 2e-3  # deltaH, windowed vs gather (tests/test_fused_windowed.py)
WIN, WIN_R, N_WIN = 384, 384, 3  # the lattice's window geometry
# key, name, wrapper, the TPU kernel it replaces; all three in WINDOW_SOURCE
WINDOW_KERNELS = (
    ("K2", "window_spmv", tw.window_spmv_cuda, "oscillink_tpu/ops/pallas/window_spmv.py:409"),
    ("K3", "window_spmv3", tw.window_spmv3_cuda, "oscillink_tpu/ops/pallas/window_spmv.py:457"),
    ("K4", "window_spmv3f", tw.window_spmv3f_cuda, "oscillink_tpu/ops/pallas/window_spmv.py:594"),
)
WINDOW_SOURCE = "oscillink_tpu_torch/csrc/window_spmv3f.cu"

QUICK = dict(n=120, d=128, k=6, chain=[2, 5, 7, 9], lamP=0.2)
HEADLINE = dict(n=5000, d=128, k=6)  # bench.py's workload
CORPUS = dict(n=131072, d=768, k=8)  # the 100k-131k x 768 x k8 corpus tier
RAGGED = dict(n=4099, d=97, k=5)
K_ONE = dict(n=333, d=130, k=1)
K_WIDE = dict(n=1000, d=64, k=40)  # more neighbours than one warp's 32 lanes
WIN_RAGGED = dict(n=4099, d=97, k=8)  # N not a multiple of 384, D not of 4
# K4's other geometries: the JAX package's W = 512 / R = 256 / 2 windows, and
# 40 slots a row (more than a warp's lanes; the lists take two row passes)
WIN_512 = dict(n=4099, d=128, k=8, W=512, R=256, n_win=2)
WIN_K40 = dict(n=4099, d=97, k=40)
STRAGGLERS = dict(n=16384, d=768, k=8)
# the low-coverage retry's window the forced straggler corpora were built
# for: the JAX package's default, which the port's card-read default (0)
# turns off
STRAGGLER_RETRY = dict(OSCILLINK_WINDOWED_LOWCOV_SMAX="768")
# the windowed tier's routing: the names it reads, the JAX package's values
# (at which its unforced branches accept on the corpora here), the small
# corpus, and what PERF.md's sweep gives each default-environment case
ROUTING_NAMES = ("OSCILLINK_WINDOWED_MATVEC", "OSCILLINK_WINDOWED_MIN_N",
                 "OSCILLINK_WINDOWED_MIN_COVERAGE", "OSCILLINK_WINDOWED_LOWCOV_SMAX",
                 "OSCILLINK_WINDOWED_FW_GB", "OSCILLINK_COL_CHUNKS")
JAX_ROUTING = dict(OSCILLINK_WINDOWED_MIN_N="32768", OSCILLINK_WINDOWED_MIN_COVERAGE="0.92",
                   OSCILLINK_WINDOWED_LOWCOV_SMAX="768")
ROUTING_SMALL = dict(n=16384, d=768, k=8)
ROUTING_EXPECT = {"locality": "small N", "gaussian": "small N", "small": "small N",
                  "locality_jax_values": "coverage", "clustered_jax_values": "bounded stragglers"}
NARROW = dict(n=8192, d=97, k=8)
# K1's slab widths swept at the corpus shape and at 262144, 524288 and 1M
# rows (D = 768, k = 8), beside D (the whole-row walk) and the plan's width
SLAB_SWEEP = (4, 8, 16, 32, 64, 128, 256)
# the size between the corpus and the cluster tier where the old plan fell
# to 8 columns: the loose study corpus, built as the service's default does
K1_SWEEP_MID = dict(n=262144, d=768, k=8, centres=1024, spread=0.6)
# forced slab widths held to the plan's bits at the small K1 shapes: 1-32
# lanes a row, widths that leave a ragged last slab, odd widths on float4 rows
SLAB_CHECK = (1, 2, 3, 4, 5, 8, 12, 16, 20, 32, 33, 64, 100)
# K5: the probe's check shape, and D = 97 (the scalar path) with e_pad = ETILE
K5_SHAPES = (("check", 2, 128, 2 * bg.ETILE), ("ragged", 3, 97, bg.ETILE))
PROBE_D = 768  # the probe's full width; its 31 buckets are probe_tensors' default
# the multi-query serving paths: the batched lattice against the CPU, the
# /v1/bundle batch path at the corpus tier (Q queries), the standalone
# diffusion gates (dense direct at N <= 4096, CG above), the
# /v1/bundle/ragged shape and the one-shot light receipt
BATCH_PARITY = dict(n=2000, d=128, k=6, q=6)
BATCH_Q = 8
DIFF_DIRECT = dict(n=4096, d=128, k=6)
DIFF_CG = dict(n=5000, d=128, k=6)
RAGGED_BATCH = dict(corpora=32, n_min=200, n_max=4000, d=768, k=6, bundle_k=8)
LANE_TOL = 1e-5  # batch vs single, card vs CPU: relative to max|U|, or absolute on gates
RAGGED_REL, RAGGED_ABS = 1e-3, 1e-4  # tests/test_ragged.py:41-44
# similarity="auto": the blocked fast path held to the CPU (auto forced to
# "fast" above 8192 rows), the cluster tier (the tight IVF study corpus), the
# IVF build held to the CPU at the default geometry (C = 1024, P = 128), and
# the row-blocked seeded host build
FAST_PARITY = dict(n=16384, d=768, k=8, fast_sim_n=8192)
CLUSTER = dict(n=524288, d=768, k=8, centres=1024, spread=0.6)
TIGHT_SPREAD = 0.35
IVF_PARITY = dict(n=65536, d=128, k=8, centres=2048)
SEEDED = dict(n=8192, d=128, k=8, seed=3)
# the low-memory and column-chunked solves: the JAX package's 1M IVF study
# shape on its "loose" corpus (benchmarks/ivf_balanced_1m.json's config),
# full width and at the chunk counts the 16 GB chip needed; the windowed
# tier chunked on the locality-ordered corpus and the straggler corpus
MILLION = dict(n=1_000_000, d=768, k=8, centres=1024, spread=0.6)
MILLION_CHUNKS = (4, 8)
FORM_TURNS = 3
FORM_TOL = 1e-6  # classic vs low-memory CG: U relative to max|U|
CHUNK_DH_REL, CHUNK_SUM_REL = 1e-5, 1e-4  # tests/test_chunked_receipts.py:65-91
WINDOWED_CHUNK_TOL = 5e-4  # U*, relative to max|U| (tests/test_window_spmv.py:189)
# (OSCILLINK_COL_CHUNKS, OSCILLINK_WINDOWED_FUSED, the kernel the chunk width takes)
WINDOWED_CHUNKED = (("2", "1", "K4"), ("2", "0", "K3"), ("8", "1", "K2"))
# the service: one request at its full size (max_nodes, service/config.py)
# with Q queries for the batch route, B corpora for the ragged one and a
# 4-node chain; warm calls timed per endpoint; every signed receipt under
# one secret
FLAGSHIP = dict(n=5000, d=768, k=8, q=8, ragged=(500, 1000, 2000, 4000), chain=[2, 5, 7, 9])
SERVICE_WARM_CALLS = 1
SERVICE_SECRET = "chip-smoke-receipt-secret"
# the service's native route at the deploy image's threshold (docs/
# CLOUD_ARCHITECTURE.md: OSCILLINK_NATIVE_SMALL_N=2048), with the largest
# request it routes; its bars against the device route are the JAX package's
# (tests/test_native_service_path.py)
NATIVE = dict(n=2048, d=768, k=8, q=8, bundle_k=8, chain=[2, 5, 7, 9], threshold="2048")
NATIVE_DH_ABS, NATIVE_DH_REL = 1e-2, 5e-3
NATIVE_Z_ABS, NATIVE_Z_REL = 2e-3, 2e-3
NATIVE_TIMING_KEYS = ("timings_ms", "t_ms", "last_settle_ms", "request_id")
SYNTH3K = os.path.join("benchmarks", "data", "beir", "synth3k")
TEXTS = dict(docs=3000, k=8, hash_dim=384, lsa_dim=64)
K1_SYMBOL = "spmv_gather_kernel"  # csrc/spmv.cu's __global__
# the mesh tiers: 4 shards on cuda:0; the JAX tests' bars (tests/
# test_shardmap_cg.py:30, test_halo_cg.py:66 and :151, test_service_sharded.py)
MESH_SHARDS = 4
CARD = torch.device("cuda", 0)  # every mesh shard's device
MESH_GATHER_TOL, MESH_HALO_TOL, WINDOWED_HALO_TOL = 2e-4, 3e-4, 5e-4
SERVICE_DEVICE_REL = 2e-3
HIER_REL = 1e-5  # per-shard ΔH: streaming vs hierarchical, card vs CPU on one graph
# per-shard ΔH, card vs the CPU's own build, where near ties put different
# neighbours in a shard's graph: set from the readings (2.47e-5 at most on the
# H100, PERF.md §7); HIER_REL holds every shard on the card's graph
HIER_TIE_REL = 1e-4
HALO_WINDOWED = dict(n=131072, d=768, k=8)
HALO_NARROW = dict(n=16384, d=97, k=8)
AUTO_MESH = dict(n=131072, d=768, k=8)
HIER = dict(n=131072, d=768, k=8, shards=8)
HIER_CPU = dict(n=16384, d=768, k=8, shards=8)
SHARDED_MIN_N = "4096"  # the service's sharded threshold below the flagship's 5000 rows
# the CG's fused passes (csrc/cg_fused.cu): the two corpus cells' shapes
# (trec_covid, beir_quora), a service request's, a width on the scalar path
# and D = 1 (a diffusion solve), each pass against its twin; the corpus
# flow at trec_covid's shape; lane splits of the residual at D = 768
CG_SHAPES = (dict(n=171332, d=768), dict(n=522931, d=768), dict(n=500, d=768),
             dict(n=4099, d=97), dict(n=5000, d=1))
CG_TIMED_N = 100_000  # shapes from this many rows are timed
CG_FLOW = dict(n=171332, d=768, k=8)
CG_LANES = (3, 768)
CG_LAMS = (1.0, 0.5, 4.0)  # λ_G, λ_C, λ_Q of the twins' checks
CG_ULPS = 1  # column sums, kernel vs torch's f64 sums: two f64 orders, one rounding to f32
CG_FORM_TOL = 1e-6  # U, fused vs classic body: relative to max|U|
# the edge distances (csrc/edge_dists.cu): timed at the two corpus cells'
# shapes (trec_covid, beir_quora), checked there and at a service request's,
# the headline's, a ragged width past one group of 8 slots and D = 3; on
# graphs of uniformly random neighbours (an unordered corpus's kNN graph has
# no locality either); the batch cell's lane view of an [N, 8, D] block
ED_TIMED = (dict(n=171332, d=768, k=8), dict(n=522931, d=768, k=8))
ED_CHECKED = (dict(n=1000, d=768, k=6), dict(n=5000, d=768, k=8), dict(n=4099, d=97, k=13),
              dict(n=3001, d=3, k=5))
ED_LANES = 8
# edge-distance calls a step makes: the bundle's coherence drop (Y and U*);
# the full receipt's energy (its coherence drop) and null points (U* alone);
# the chain receipt's residuals; the light receipt reads none
ED_PER_BUNDLE = 2
ED_CORPUS_FLOW = {"light_flow": 0, "receipt_full": 3, "bundle": ED_PER_BUNDLE,
                  "chain_receipt": 1}
ALLOC_SLACK_BYTES = 2 << 20  # two blocks' rounding by the caching allocator
ED_RTOL = 1e-6  # kernel vs plain, each edge: two f32 orders of one sum of positive terms
ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def emit(tag: str, **fields) -> None:
    """One JSON line a reading, stamped with the script's seconds so far
    (``t_s``): the gaps between lines are the phases' times."""
    print(json.dumps({"phase": tag, **fields, "t_s": time.perf_counter() - T0}), flush=True)


def sync_ms(t0: float) -> float:
    torch.cuda.synchronize()
    return 1000.0 * (time.perf_counter() - t0)


def cuda_ms(fn, reps: int, groups: int = 3) -> float:
    """Median over ``groups`` of the CUDA-event mean of ``reps`` launches."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def quick_inputs():
    """The verify-skill quickstart's inputs: Gaussian anchors from seed 0,
    psi = normalized mean of the first 20 rows."""
    rng = np.random.default_rng(0)
    Y = rng.standard_normal((QUICK["n"], QUICK["d"])).astype(np.float32)
    m = Y[:20].mean(0)
    return Y, (m / (np.linalg.norm(m) + 1e-12)).astype(np.float32)


def quickstart(device: str) -> dict:
    """The verify-skill quickstart flow on ``device``."""
    Y, psi = quick_inputs()
    lat = Oscillink(Y, kneighbors=QUICK["k"], device=device)
    lat.set_query(psi)
    lat.add_chain(QUICK["chain"], lamP=QUICK["lamP"])
    st = lat.settle(max_iters=12, tol=1e-3)
    rec = lat.receipt()
    # the fixed-order f64 deltaH must equal the NumPy specification bit for bit
    os.environ["OSCILLINK_DETERMINISTIC_RECEIPTS"] = "1"
    try:
        det = lat.receipt()["deltaH_total"]
    finally:
        del os.environ["OSCILLINK_DETERMINISTIC_RECEIPTS"]
    g = lat.graph
    pg = build_path_graph(QUICK["n"], QUICK["chain"], device=torch.device("cpu"))
    spec = float(deltaH_tree_np(
        g.idx.cpu().numpy(), g.wn.cpu().numpy(), lat.U, lat.solve_Ustar(),
        lat.lamG, lat.lamC, lat.lamQ, lat.B_diag,
        path_src=pg.src.numpy(), path_dst=pg.dst.numpy(), path_wn=pg.wn.numpy(), lamP=lat.lamP,
    ))
    return {
        "deltaH": rec["deltaH_total"],
        "nulls": len(rec["null_points"]),
        "verdict": lat.chain_receipt(QUICK["chain"])["verdict"],
        "bundle": [b["id"] for b in lat.bundle(k=6)],
        "state_sig": rec["meta"]["state_sig"],
        "settle_iters": st["iters"],
        "ustar_iters": rec["meta"]["ustar_iters"],
        "deltaH_f64_tree": det.hex(),
        "deltaH_f64_tree_bits_equal_numpy_spec": det.hex() == spec.hex(),
    }


def flow_pass(Y, psi, k: int) -> tuple[dict, Oscillink, int]:
    """One pass of bench.py's flow, each phase timed to a device sync.
    Also returns the K1 launches counted across its settle."""
    t = {}
    t0 = time.perf_counter()
    lat = Oscillink(Y, kneighbors=k)
    lat.set_query(psi)
    lat.set_receipt_detail("light")
    t["build_ms"] = sync_ms(t0)
    before = spmv.launches
    t0 = time.perf_counter()
    lat.settle(dt=1.0, max_iters=12, tol=1e-3)
    t["settle_ms"] = sync_ms(t0)
    settle_launches = spmv.launches - before
    t0 = time.perf_counter()
    lat._solve_ustar_device()  # the device solve alone; receipt() then hits the cache
    t["ustar_ms"] = sync_ms(t0)
    t0 = time.perf_counter()
    rec = lat.receipt()
    t["receipt_light_ms"] = sync_ms(t0)
    check(np.isfinite(rec["deltaH_total"]), "deltaH is not finite")
    return t, lat, settle_launches


def headline_flow(Y, psi, k: int, device: str) -> dict:
    """bench.py's flow with a full receipt on ``device``; what the card and
    the port's CPU path must agree on."""
    lat = Oscillink(Y, kneighbors=k, device=device)
    lat.set_query(psi)
    st = lat.settle(dt=1.0, max_iters=12, tol=1e-3)
    rec = lat.receipt()
    return {
        "idx": lat.graph.idx.cpu(),
        "deltaH": rec["deltaH_total"],
        "null_edges": [p["edge"] for p in rec["null_points"]],
        "bundle": [b["id"] for b in lat.bundle(k=k)],
        "state_sig": rec["meta"]["state_sig"],
        "settle_iters": st["iters"],
        "ustar_iters": rec["meta"]["ustar_iters"],
    }


def headline_parity(Y, psi, k: int) -> dict:
    """The headline cell on the card against the port on the CPU.  N = 5000
    takes the blocked graph build, so the card's top-k tie order (stable_topk
    on CUDA torch.topk / torch.sort) is held to the CPU's; the card's full
    receipt runs the edge-distance kernel, the CPU's its plain version."""
    gpu = headline_flow(Y, psi, k, "cuda")
    cpu = headline_flow(Y, psi, k, "cpu")
    rel = abs(gpu["deltaH"] - cpu["deltaH"]) / max(abs(cpu["deltaH"]), 1e-30)
    check(torch.equal(gpu["idx"], cpu["idx"]), "headline graph idx: cuda != cpu")
    check(rel <= 1e-5, f"headline deltaH differs: {rel}")
    for key in ("null_edges", "bundle", "state_sig", "settle_iters", "ustar_iters"):
        check(gpu[key] == cpu[key], f"headline {key}: cuda != cpu")
    return {
        "idx_equal": True, "deltaH_rel": rel, "null_points": len(cpu["null_edges"]),
        "bundle": cpu["bundle"], "state_sig": cpu["state_sig"],
        "settle_iters": cpu["settle_iters"], "ustar_iters": cpu["ustar_iters"],
    }


def medians(passes: list[dict]) -> dict:
    return {key: statistics.median(p[key] for p in passes) for key in passes[0]}


def kernel_vs_plain(shape: dict, gen: torch.Generator) -> dict:
    """Build a real graph with the port at ``shape``, run K1 and its plain
    version on the same inputs, and hold them together; a second launch must
    give the same bits."""
    dev = torch.device("cuda")
    n, d, k = shape["n"], shape["d"], shape["k"]
    Y = torch.randn(n, d, generator=gen, device=dev)
    g = build_graph(Y, k)
    X = torch.randn(n, d, generator=gen, device=dev)
    out, again = lap_matvec(g, X), lap_matvec(g, X)
    ref = spmv.lap_matvec_ref(g.idx, g.wn, X)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    check(bool(torch.isfinite(out).all()), f"K1 output not finite at {shape}")
    check(torch.allclose(out, ref, rtol=TOL, atol=TOL), f"K1 != plain at {shape}: {err}")
    check(torch.equal(out, again), f"K1 differs from launch to launch at {shape}")
    # below the corpus size, forced slab widths (every lane count, ragged last
    # slabs, scalar slabs on a float4 row) must give the plan's bits
    widths = [w for w in SLAB_CHECK if w < d] if n * d < 10_000_000 else []
    for w in widths:
        check(torch.equal(spmv.lap_matvec_cuda(g.idx, g.wn, X, slab_cols=w), out),
              f"K1 at slab_cols={w} differs from the plan's width at {shape}")
    emit("kernel_vs_plain", **shape, slab_cols=k1_slab_cols(n, d, k), max_abs_err=err, tol=TOL,
         bit_equal_repeat=True, bit_equal_slab_cols=widths)
    return {"g": g, "X": X, "err": err}


def k1_slab_cols(n: int, d: int, k: int) -> int:
    """K1's slab width on this card at [n, d] with k slots (the main path's)."""
    return spmv.slab_plan(n, d, k, spmv.device_l2_bytes(0))


def turns_ms(calls: dict, reps: int) -> dict:
    """Each callable timed by `cuda_ms` in turns, forward then backward
    (a, b, ..., b, a); the two readings of each, in that order."""
    order = list(calls) + list(reversed(calls))
    out = {key: [] for key in calls}
    for key in order:
        out[key].append(cuda_ms(calls[key], reps))
    return out


def k1_slab_sweep(shape: dict, case: dict) -> dict:
    """K1 at ``shape`` with each slab width of SLAB_SWEEP and the plan's, the
    widths timed in turns on this card; each output must equal the plan's
    bit for bit (slabbing changes no element's arithmetic).  S = D is the
    whole-row walk of the kernel's first design.  Beside them, the same walk
    with one slot a row that reads the row itself: what reading X and
    writing out in slabs costs without the gathers."""
    g, X = case["g"], case["X"]
    n, d, k = shape["n"], shape["d"], shape["k"]
    plan = k1_slab_cols(n, d, k)
    widths = sorted({*(w for w in SLAB_SWEEP if w < d), d, plan})
    reps = 20 if n <= CORPUS["n"] else 5
    ref = spmv.lap_matvec_cuda(g.idx, g.wn, X)
    for w in widths:
        out = spmv.lap_matvec_cuda(g.idx, g.wn, X, slab_cols=w)
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"K1 at slab_cols={w} != the plan's ({plan}) at {shape}")
        del out
    del ref
    times = turns_ms({w: (lambda w=w: spmv.lap_matvec_cuda(g.idx, g.wn, X, slab_cols=w))
                      for w in widths}, reps)
    # the access pattern's own cost: one slot a row reading the row itself
    # (no gather traffic), at the plan's width and at S = D
    own = torch.arange(n, dtype=torch.int32, device=X.device)[:, None].contiguous()
    zero = torch.zeros(n, 1, device=X.device)
    stream = turns_ms({w: (lambda w=w: spmv.lap_matvec_cuda(own, zero, X, slab_cols=w))
                       for w in (plan, d)}, reps)
    del own, zero
    ms = {w: statistics.mean(t) for w, t in times.items()}
    fastest = min(ms, key=ms.get)
    row = {"plan_slab_cols": plan, "l2_bytes": spmv.device_l2_bytes(0),
           "l2_budget_bytes": spmv.l2_budget(spmv.device_l2_bytes(0)),
           "slab_cols_rule": spmv.SLAB_COLS, "fastest_slab_cols": fastest,
           "plan_over_fastest": ms[plan] / ms[fastest],
           "ms": {str(w): t for w, t in ms.items()},
           "turns_ms": {str(w): t for w, t in times.items()}, "bit_equal_to_plan": True,
           "stream_only_ms": {str(w): statistics.mean(t) for w, t in stream.items()}}
    row = {**shape, **row}
    emit("k1_slab_sweep", **row)
    return row


def k1_graph_sweep(shape: dict, g, seed: int) -> dict:
    """`k1_slab_sweep` on a lattice's graph ``g`` with a random X of
    ``shape``'s width."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn(g.n_nodes, shape["d"], generator=gen, device="cuda")
    row = k1_slab_sweep({key: shape[key] for key in ("n", "d", "k")}, {"g": g, "X": X})
    del X
    torch.cuda.empty_cache()
    return row


def k1_sweep_mid() -> dict:
    """K1's slab widths at 262144 x 768 x k8 on the graph that
    ``similarity="auto"`` builds there (the fast scan) from the loose study
    corpus."""
    s = K1_SWEEP_MID
    Y, _ = study_corpus(s["n"], s["d"], centres=s["centres"], spread=s["spread"])
    lat = Oscillink(Y, kneighbors=s["k"], similarity="auto")
    g = lat.graph
    del lat, Y
    return k1_graph_sweep(s, g, seed=6)


def k1_ptxas(report: dict) -> dict:
    """K1's entries of a `ptxas_report`, keyed by vector type and lanes a row."""
    out = {}
    for key, val in report.items():
        m = re.search(r"spmv_gather_kernelI(6float4|f)Li(\d+)E", key)
        if m:
            out[f"{'float4' if m.group(1) == '6float4' else 'float'},G={m.group(2)}"] = val
    return out


def ptxas_report(log_text: str) -> dict:
    """Registers and spill bytes of each kernel in an ``nvcc -Xptxas -v``
    log, keyed by its mangled name."""
    out: dict = {}
    name = None
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
    return out


def csr_of(idx: torch.Tensor, wn: torch.Tensor) -> torch.Tensor:
    """(I - Wn) as a CSR matrix: the library yardstick computes the
    operator of K1 (and of K2-K4) with one torch.sparse.mm call."""
    dev = idx.device
    n, k = idx.shape
    cols = torch.cat([torch.arange(n, device=dev)[:, None], idx.long()], dim=1)
    vals = torch.cat([torch.ones(n, 1, device=dev), -wn], dim=1)
    cols, perm = torch.sort(cols, dim=1)
    vals = torch.gather(vals, 1, perm)
    crow = torch.arange(0, n * (k + 1) + 1, k + 1, device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # CSR support is marked beta
        return torch.sparse_csr_tensor(
            crow, cols.reshape(-1), vals.reshape(-1), size=(n, n), check_invariants=False
        )


def time_kernel(shape: dict, case: dict) -> dict:
    g, X = case["g"], case["X"]
    n, d, k = shape["n"], shape["d"], shape["k"]
    reps = 200 if n * d < 10_000_000 else 20
    kernel_ms = cuda_ms(lambda: spmv.lap_matvec_cuda(g.idx, g.wn, X), reps)
    plain_ms = cuda_ms(lambda: spmv.lap_matvec_ref(g.idx, g.wn, X), max(2, reps // 10))
    A = csr_of(g.idx, g.wn)
    lib_out = torch.sparse.mm(A, X)
    lib_err = float((lib_out - lap_matvec(g, X)).abs().max())
    check(lib_err < 1e-4, f"library yardstick disagrees with K1 at {shape}: {lib_err}")
    library_ms = cuda_ms(lambda: torch.sparse.mm(A, X), reps)
    unique_bytes = (2 * n * d + 2 * n * k) * 4
    flops = 2 * n * k * d
    bound_ms = 1e3 * max(unique_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS)
    gather_ms = 1e3 * (n * k * d * 4 + unique_bytes) / HBM_BYTES_PER_S
    row = {
        **shape,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if unique_bytes / HBM_BYTES_PER_S >= flops / F32_FLOPS else "operations",
        "gather_ceiling_ms": gather_ms,
        "achieved_GBps": unique_bytes / (kernel_ms * 1e-3) / 1e9,
        "max_abs_err": case["err"],
        "library_max_abs_err": lib_err,
    }
    emit("kernel_timing", **row)
    return row


# -- the windowed tier (kernels K2-K4) ----------------------------------------


def reset_counts() -> None:
    spmv.launches = 0
    bg.launches = 0
    edge_dists.launches = 0
    for _, _, fn, _ in WINDOW_KERNELS:
        fn.launches = 0


def read_counts() -> dict:
    return {"K1": spmv.launches, **{name: fn.launches for name, _, fn, _ in WINDOW_KERNELS},
            "K5": bg.launches, "edge_dists": edge_dists.launches}


def bench_graph(n: int, k: int, seed: int = 0):
    """The JAX package's kernel-bench graph (bench.py): neighbours i +- 400
    (mod n), weights U[0, 0.1)."""
    rng = np.random.default_rng(seed)
    idx = ((np.arange(n)[:, None] + rng.integers(-400, 400, size=(n, k))) % n).astype(np.int32)
    wn = (rng.random((n, k)) * 0.1).astype(np.float32)
    return idx, wn


def window_case(shape: dict, seed: int) -> dict:
    """The bench graph at ``shape`` with its window geometry (the lattice's
    unless ``shape`` names W, R and n_win): its plan (the device builder,
    rows in their own order, a straggler cap that cannot truncate) and
    one-hots on the card (for the one-hot plain versions only), X (padding
    rows zero) and a diagonal g."""
    n, d, k = shape["n"], shape["d"], shape["k"]
    W, R, n_win = shape.get("W", WIN), shape.get("R", WIN_R), shape.get("n_win", N_WIN)
    idx, wn = bench_graph(n, k, seed)
    idx_t, wn_t = torch.from_numpy(idx).cuda(), torch.from_numpy(wn).cuda()
    # a block's padded straggler segment is at most R * k entries
    seg_bound = -(-R * k // 128) * 128
    cap = -(-(n * k + 8 * -(-n // R) + seg_bound) // 128) * 128
    plan, cov_t, n_strag_t, fits_t = tw.build_window_plan_device(
        idx_t, wn_t, torch.arange(n, device="cuda"), W, R, cap, seg_bound, n_win)
    check(bool(fits_t) and int(n_strag_t) <= cap, f"bench-graph plan refused at {shape}")
    s_max = tw.plan_s_max(plan)
    plan = tw.right_size_stragglers(plan, int(plan.strag_off[-1]), s_max)
    oh = tw.build_onehot(plan, W, s_max)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn(n, d, generator=gen, device="cuda")
    cnt = plan.strag_cnt.cpu().numpy()
    return {
        "idx": idx_t, "wn": wn_t, "plan": plan, "oh": oh, "s_max": s_max, "geo": (W, R),
        "X": X, "Xpad": tw.pad_rows(X, plan.n_pad),
        "g": 1.5 + torch.rand(plan.n_pad, 1, generator=gen, device="cuda"),
        "nnz": {"strag_w": int(torch.count_nonzero(plan.strag_w)),
                "wnl": int(torch.count_nonzero(plan.wnl)),
                "strag_seg": int(np.minimum(cnt, s_max).sum())},
        "info": {"W": W, "R": R, "n_win": n_win, **shape, "coverage": float(cov_t),
                 "s_max": s_max, "n_pad": plan.n_pad,
                 "blocks": len(cnt), "blocks_with_stragglers": int((cnt > 0).sum())},
    }


def window_calls(case: dict, tier: str) -> dict:
    """(kernel, one-hot plain, gather plain) callables of K2, K3 and K4 at
    ``tier``, each returning a tuple (K4: out and partials).  The kernels
    read the plan and no one-hot; the one-hot is stored in bf16 under
    oh16/dma16, as the CPU lattice stores it."""
    plan, oh, X, g, s_max = case["plan"], case["oh"], case["Xpad"], case["g"], case["s_max"]
    main = oh.main.to(torch.bfloat16) if tier in ("oh16", "dma16") else oh.main
    W, R = case["geo"]
    return {
        "K2": (lambda: (tw.window_spmv_cuda(plan, X, W, R, tier),),
               lambda: (tw.window_spmv_ref(plan, main, X, W, R, tier),),
               lambda: (tw.window_spmv_gather_ref(plan, X, W, R, tier),)),
        "K3": (lambda: (tw.window_spmv3_cuda(plan, X, W, R, s_max, tier),),
               lambda: (tw.window_spmv3_ref(plan, main, oh.strag, X, W, R, s_max, tier),),
               lambda: (tw.window_spmv3_gather_ref(plan, X, W, R, s_max, tier),)),
        "K4": (lambda: tw.window_spmv3f_cuda(plan, X, g, W, R, s_max, tier),
               lambda: tw.window_spmv3f_ref(plan, main, oh.strag, X, g, W, R, s_max, tier),
               lambda: tw.window_spmv3f_gather_ref(plan, X, g, W, R, s_max, tier)),
    }


def window_vs_plain(case: dict, tier: str) -> dict:
    """K2, K3, K4 (and K4's column partials) against their one-hot plain
    versions and their gather forms, and each bit-equal from launch to
    launch."""
    errs = {}
    for name, (kern, plain, gather) in window_calls(case, tier).items():
        out, again = kern(), kern()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(out, again)),
              f"{name} differs from launch to launch ({tier}, {case['info']})")
        del again
        ref, gref = plain(), gather()
        pairs = [(name, out[0], ref[0], WIN_TOL), (f"{name}_gather", out[0], gref[0], GATHER_TOL)]
        if name == "K4":
            pairs += [("K4_pap", out[1], ref[1], PAP_TOL),
                      ("K4_gather_pap", out[1], gref[1], GATHER_PAP_TOL)]
        for key, o, r, tol in pairs:
            torch.cuda.synchronize()
            err = float((o - r).abs().max())
            scale = float(r.abs().max())
            check(bool(torch.isfinite(o).all()), f"{key} output not finite ({tier}, {case['info']})")
            check(err <= tol * scale, f"{key} != plain ({tier}, {case['info']}): {err} > {tol} * {scale}")
            errs[key] = err
        del out, ref, gref
    return errs


def poisoned_case(case: dict) -> dict:
    """The case with a NaN in one row of its elected windows and an infinity
    in another, and every live slot and straggler that reads either dropped
    from the plan (rows no entry reads are taken first, real rows (< n)
    before padding ones, never a padding straggler's source), so that no
    row but the two themselves references a non-finite row."""
    plan, (W, R), n = case["plan"], case["geo"], case["info"]["n"]
    n_pad = plan.n_pad
    dev = plan.cs.device
    rows = torch.arange(n_pad, device=dev)
    read = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    held = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    cols = []
    for w in range(plan.n_windows):
        cols.append((plan.cs[w].long()[rows // R] * W)[:, None] + plan.idxl[w].long())
        read[cols[w][plan.wnl[w] != 0.0]] = True
        held[(plan.cs[w].long()[:, None] * W + torch.arange(W, device=dev)).reshape(-1)] = True
    src = plan.strag_src.long()
    read[src[plan.strag_w != 0.0]] = True
    held[src[plan.strag_w == 0.0]] = False
    cand = torch.nonzero(held)[:, 0]
    key = (read[cand].long() * 2 + (cand >= n).long()) * n_pad + cand
    bad = cand[torch.sort(key).indices[:2]]
    check(bad.numel() == 2, f"no two window rows to poison ({case['info']})")
    wnl = torch.stack([torch.where(torch.isin(cols[w], bad), 0.0, plan.wnl[w])
                       for w in range(plan.n_windows)])
    strag_w = torch.where(torch.isin(src, bad), 0.0, plan.strag_w)
    X = case["Xpad"].clone()
    X[bad[0]] = float("nan")
    X[bad[1]] = float("inf")
    dropped = {"slots": int(torch.count_nonzero(plan.wnl) - torch.count_nonzero(wnl)),
               "stragglers": int(torch.count_nonzero(plan.strag_w) - torch.count_nonzero(strag_w))}
    return {**case, "plan": plan._replace(wnl=wnl, strag_w=strag_w), "Xpad": X,
            "rows": bad, "dropped": dropped}


def window_nonfinite(case: dict) -> dict:
    """The windowed tier's NaN/Inf behaviour on the card (gather semantics)
    on `poisoned_case`'s input: K2, K3 and K4 equal their gather forms (NaN
    where they have NaN), and only the two poisoned rows' outputs are not
    finite.  The one-hot forms' non-finite rows are counted beside them:
    they spread the values to every row of each block whose windows hold
    them."""
    pc = poisoned_case(case)
    bad_rows = pc["rows"].sort().values
    out = {"rows": bad_rows.tolist(), "dropped": pc["dropped"]}
    for name, (kern, plain, gather) in window_calls(pc, "bf16x3").items():
        o, r = kern()[0], gather()[0]
        torch.cuda.synchronize()
        scale = float(r[torch.isfinite(r)].abs().max())
        check(torch.allclose(o, r, rtol=0.0, atol=GATHER_TOL * scale, equal_nan=True),
              f"{name} != its gather form on non-finite input ({case['info']})")
        bad = torch.nonzero(~torch.isfinite(o).all(dim=1))[:, 0]
        check(torch.equal(bad, bad_rows),
              f"{name}: rows {bad.tolist()[:8]} not finite, expected {bad_rows.tolist()} only")
        one_hot = plain()[0]
        out[name] = {"nonfinite_rows": int(bad.numel()),
                     "onehot_nonfinite_rows": int((~torch.isfinite(one_hot).all(dim=1)).sum())}
        del o, r, one_hot
    return out


def window_bound(case: dict, name: str) -> dict:
    """The least time for one apply of K2, K3 or K4 (``bound_ms``,
    ``bound_by``): X read once (the straggler source rows are rows of X),
    out written once, idxl, wnl and cs; K3 and K4 also the straggler
    entries of the blocks' segments and the block counts and offsets; K4
    also g and the partials; over the HBM rate.  Against it one f32
    multiply-add per live slot (K3, K4: and live straggler) and column, K4
    also the g, x ⊙ out and partial work, over the f32 peak."""
    plan, nnz = case["plan"], case["nnz"]
    n_pad, d = case["Xpad"].shape
    blocks = plan.n_blocks
    nbytes = 2 * n_pad * d * 4 + 2 * plan.idxl.numel() * 4 + plan.cs.numel() * 4
    ops = 2 * nnz["wnl"] * d
    if name != "K2":
        nbytes += nnz["strag_seg"] * 12 + 2 * blocks * 4
        ops += 2 * nnz["strag_w"] * d
    if name == "K4":
        nbytes += n_pad * 4 + blocks * d * 4
        ops += 3 * n_pad * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": nbytes}


def window_timing(case: dict) -> dict:
    """K2-K4 at the default tier (bf16x3) with CUDA events, beside their
    one-hot and gather-form plain versions, their bounds, torch.sparse.mm of
    the same operator as a CSR matrix, and K1 on the same graph (at its
    plan's slab width and at S = D, in turns)."""
    n = case["info"]["n"]
    X = case["X"]
    A = csr_of(case["idx"], case["wn"])
    lib_out = torch.sparse.mm(A, X)
    k1_out = spmv.lap_matvec_cuda(case["idx"], case["wn"], X)
    k3_out = window_calls(case, "bf16x3")["K3"][0]()[0][:n]
    torch.cuda.synchronize()
    lib_err = float((lib_out - k3_out).abs().max())
    check(lib_err <= 1e-4 * float(lib_out.abs().max()),
          f"library yardstick disagrees with K3: {lib_err}")
    library_ms = cuda_ms(lambda: torch.sparse.mm(A, X), 20)
    # K1 on the same graph at its plan's slab width and at S = D (the
    # whole-row walk), in turns; the two must give the same bits
    d = X.shape[1]
    k1_full = spmv.lap_matvec_cuda(case["idx"], case["wn"], X, slab_cols=d)
    torch.cuda.synchronize()
    check(torch.equal(k1_out, k1_full), "K1 on the bench graph: the plan's slabs != S = D")
    del k1_full
    k1_turns = turns_ms({
        "plan": lambda: spmv.lap_matvec_cuda(case["idx"], case["wn"], X),
        "full_width": lambda: spmv.lap_matvec_cuda(case["idx"], case["wn"], X, slab_cols=d),
    }, 20)
    k1_ms = statistics.mean(k1_turns["plan"])
    k1_err = float((k1_out - k3_out).abs().max())
    rows = {}
    for name, (kern, plain, gather) in window_calls(case, "bf16x3").items():
        rows[name] = {
            "ms": cuda_ms(kern, 50), "plain_ms": cuda_ms(plain, 3),
            "gather_plain_ms": cuda_ms(gather, 3), **window_bound(case, name),
            "library_ms": library_ms,
        }
    emit("window_timing", **case["info"], tier="bf16x3", k1_same_graph_ms=k1_ms,
         k1_slab_cols=k1_slab_cols(n, d, case["info"]["k"]), k1_turns_ms=k1_turns,
         k1_vs_k3_max_abs=k1_err, library_vs_k3_max_abs=lib_err, nnz=case["nnz"], **rows)
    return {"rows": rows, "k1_ms": k1_ms,
            "k1_full_width_ms": statistics.mean(k1_turns["full_width"])}


def ctx_info(lat: Oscillink) -> dict:
    """The window context's plan, geometry and coverage; the card's context
    must hold no one-hot (its kernels read the plan), the CPU's must."""
    ctx = lat._window_ctx
    check(ctx is not None, "OSCILLINK_WINDOWED_MATVEC=1 built no window context")
    on_card = lat.device.type == "cuda"
    check((ctx.oh is None) == on_card,
          f"the {lat.device.type} lattice's window context "
          f"{'holds a one-hot' if on_card else 'lacks the one-hot its plain versions read'}")
    cnt = ctx.plan.strag_cnt.cpu()
    return {
        "coverage": lat._window_coverage,
        "stragglers": int(torch.count_nonzero(ctx.plan.strag_w)),
        "blocks_with_stragglers": int(torch.count_nonzero(cnt)),
        "blocks": int(cnt.numel()),
        "W": ctx.W,
        "s_max": ctx.s_max,
        "n_pad": ctx.plan.n_pad,
        "onehot_built": ctx.oh is not None,
    }


def windowed_pass(Y, psi, k: int) -> tuple[dict, dict]:
    """One pass of the windowed main path on the card: build (graph, locality
    order, plan; no one-hots), settle, U*, light and full receipt, bundle.
    Returns the phase times and what the pass counted and produced."""
    t = {}
    t0 = time.perf_counter()
    lat = Oscillink(Y, kneighbors=k)
    lat.set_query(psi)
    lat.set_receipt_detail("light")
    t["build_ms"] = sync_ms(t0)
    info = ctx_info(lat)
    k4 = tw.window_spmv3f_cuda
    before = k4.launches
    t0 = time.perf_counter()
    lat.settle(dt=1.0, max_iters=12, tol=1e-3)
    t["settle_ms"] = sync_ms(t0)
    settle_k4 = k4.launches - before
    before = k4.launches
    t0 = time.perf_counter()
    lat._solve_ustar_device()
    t["ustar_ms"] = sync_ms(t0)
    ustar_k4 = k4.launches - before
    before = spmv.launches
    t0 = time.perf_counter()
    lat.receipt()
    t["receipt_light_ms"] = sync_ms(t0)
    lat.set_receipt_detail("full")
    t0 = time.perf_counter()
    rec = lat.receipt()
    t["receipt_full_ms"] = sync_ms(t0)
    receipt_k1 = spmv.launches - before
    t0 = time.perf_counter()
    bundle = [b["id"] for b in lat.bundle(k=8)]
    t["bundle_ms"] = sync_ms(t0)
    out = {
        **info, "settle_iters": lat.last["iters"], "ustar_iters": rec["meta"]["ustar_iters"],
        "settle_k4": settle_k4, "ustar_k4": ustar_k4, "receipt_k1": receipt_k1,
        "deltaH": rec["deltaH_total"], "null_points": len(rec["null_points"]),
        "bundle": bundle, "window_precision": rec["meta"].get("window_precision"), "lat": lat,
    }
    return t, out


def window_ctx_timing(lat: Oscillink) -> dict:
    """The window context's build on a built lattice, timed to a sync: the
    locality order alone, and the whole context (order, device plan with its
    one host read; on the card no one-hots)."""
    t = {}
    t0 = time.perf_counter()
    _locality_order(lat._Y_dev)
    t["locality_order_ms"] = sync_ms(t0)
    t0 = time.perf_counter()
    lat._maybe_build_window_ctx()
    t["window_ctx_ms"] = sync_ms(t0)
    ctx_info(lat)
    return t


def windowed_corpus() -> int:
    """The full-width windowed main path (K4) on a locality-ordered
    131072 x 768 x k8 corpus, then the gather path on the same corpus.
    Returns the K4 launches counted across the windowed run."""
    Y, psi = locality_corpus(CORPUS["n"], CORPUS["d"])
    with env(OSCILLINK_WINDOWED_MATVEC="1"):
        windowed_pass(Y, psi, CORPUS["k"])  # warm-up
        passes = [windowed_pass(Y, psi, CORPUS["k"])[0] for _ in range(2)]
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t, run = windowed_pass(Y, psi, CORPUS["k"])
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        passes.append(t)
        lat = run.pop("lat")
        U = lat.U
        ctx_t = window_ctx_timing(lat)
        del lat
    with env(OSCILLINK_WINDOWED_MATVEC="0"):
        lat = Oscillink(Y, kneighbors=CORPUS["k"])
        lat.set_query(psi)
        lat.settle(dt=1.0, max_iters=12, tol=1e-3)
        rec = lat.receipt()
        gather = {"deltaH": rec["deltaH_total"], "bundle": [b["id"] for b in lat.bundle(k=8)],
                  "settle_iters": lat.last["iters"], "ustar_iters": rec["meta"]["ustar_iters"]}
        del lat
    rel = abs(run["deltaH"] - gather["deltaH"]) / max(abs(gather["deltaH"]), 1e-30)
    emit("windowed_corpus", **CORPUS, passes=len(passes), **medians(passes), last_pass=t,
         **ctx_t, **{key: val for key, val in run.items() if key != "bundle"},
         launches=counts, max_memory_allocated_bytes=peak, bundle_ids=run["bundle"],
         gather=gather, deltaH_rel_vs_gather=rel)
    check(counts["K4"] > 0, "K4 was not launched on the windowed main path")
    check(run["settle_k4"] == run["settle_iters"] + 1,
          f"K4 launches in settle {run['settle_k4']} != r0 + {run['settle_iters']} iterations")
    check(run["ustar_k4"] == run["ustar_iters"] + 1,
          f"K4 launches in U* {run['ustar_k4']} != r0 + {run['ustar_iters']} iterations")
    check(counts["K1"] == run["receipt_k1"] == 2,
          f"K1 launches {counts['K1']} != the 2 receipts' operator applies")
    check(counts["K4"] == run["settle_k4"] + run["ustar_k4"], "K4 launched off settle and U*")
    check(U.shape == (CORPUS["n"], CORPUS["d"]) and bool(np.isfinite(U).all()),
          "windowed U not finite")
    check(np.isfinite(run["deltaH"]) and run["deltaH"] >= 0, "windowed deltaH invalid")
    check(rel <= WINDOWED_VS_GATHER_TOL, f"windowed deltaH differs from gather: {rel}")
    check(run["bundle"] == gather["bundle"], "windowed bundle ids differ from gather")
    return counts["K4"]


# -- the windowed tier's routing (``OSCILLINK_WINDOWED_MATVEC=auto``) ----------


def routing_constants() -> dict:
    """The routing constants in force: the environment's, else the port's
    card-read defaults."""
    return {"mode": os.getenv("OSCILLINK_WINDOWED_MATVEC", "auto").strip().lower(),
            "min_n": tlattice._windowed_min_n(), "min_coverage": tw.min_coverage(),
            "lowcov_smax": tw.lowcov_smax_bound()}


def routing_decision(lat: Oscillink) -> dict:
    """The lattice's routing decision, made again with a logger attached:
    the event's payload, its reason (None with the tier off, which logs
    nothing), whether a context was built."""
    events: list = []
    lat.set_logger(lambda ev, p: events.append((ev, p)))
    lat._maybe_build_window_ctx()
    lat.set_logger(None)
    check(len(events) <= 1, f"one routing event expected, got {events}")
    ev, payload = events[0] if events else (None, {})
    reason = payload.get("accepted", payload.get("reason"))
    return {**payload, "event": ev, "reason": reason, "windowed": lat._window_ctx is not None}


def rule_reason(n: int, dec: dict, c: dict) -> str:
    """The reason the constants ``c`` give a lattice of ``n`` rows whose plan
    logged ``dec``.  An overflow is the rule's only when the plan was tried
    at the last window the constants allow (384, or the retry's)."""
    if c["mode"] in ("0", "off", "false", "no"):
        return None
    if n < c["min_n"]:
        return "small N"
    last = 384 if c["lowcov_smax"] <= 384 else -(-c["lowcov_smax"] // 128) * 128
    if dec["reason"] == "straggler overflow" and dec["s_max"] == last:
        return "straggler overflow"
    if dec["coverage"] >= c["min_coverage"]:
        return "coverage"
    if 0 < c["lowcov_smax"] and dec["s_max"] <= c["lowcov_smax"]:
        return "bounded stragglers"
    return "low coverage"


def routed_flow(tag: str, Y, psi, k: int, values: dict) -> tuple[dict, Oscillink]:
    """The verify skill's flow (build, settle, U*, full receipt, bundle) under
    ``values``, the launch counts set to 0 just before it and read just
    after; the lattice's decision held to the rule of the constants in
    force, its launches to the route it took: K4 r0 + one an iteration in
    settle and U* and K1 once in the receipt where the context was accepted,
    K1 for every operator apply otherwise."""
    with env(**values):
        consts = routing_constants()
        reset_counts()
        t0 = time.perf_counter()
        lat = Oscillink(Y, kneighbors=k)
        build_ms = sync_ms(t0)
        dec = routing_decision(lat)
        lat.set_query(psi)
        t0 = time.perf_counter()
        st = lat.settle(dt=1.0, max_iters=12, tol=1e-3)
        settle_ms = sync_ms(t0)
        t0 = time.perf_counter()
        lat._solve_ustar_device()
        ustar_ms = sync_ms(t0)
        t0 = time.perf_counter()
        rec = lat.receipt()
        receipt_ms = sync_ms(t0)
        bundle = [b["id"] for b in lat.bundle(k=8)]
        counts = read_counts()
    it_s, it_u = st["iters"], rec["meta"]["ustar_iters"]
    want = rule_reason(Y.shape[0], dec, consts)
    run = {"decision": dec, "rule_reason": want, "constants": consts, "build_ms": build_ms,
           "settle_ms": settle_ms, "ustar_ms": ustar_ms, "receipt_ms": receipt_ms,
           "settle_iters": it_s, "ustar_iters": it_u, "deltaH": rec["deltaH_total"],
           "null_points": len(rec["null_points"]), "bundle": bundle, "launches": counts}
    check(dec["reason"] == want, f"{tag}: decision {dec['reason']!r}, the constants give {want!r}")
    check(np.isfinite(rec["deltaH_total"]) and rec["deltaH_total"] >= 0, f"{tag}: deltaH invalid")
    check(len(bundle) == 8 and len(set(bundle)) == 8, f"{tag}: bundle ids invalid")
    if dec["windowed"]:
        check(dec["reason"] in ("coverage", "bounded stragglers"),
              f"{tag}: auto accepted the context as {dec['reason']!r}")
        check(counts["K4"] == (it_s + 1) + (it_u + 1),
              f"{tag}: K4 launches {counts['K4']} != settle and U* applies {it_s}+1, {it_u}+1")
        check(counts["K1"] == 1, f"{tag}: K1 launches {counts['K1']} != the receipt's one apply")
    else:
        check(counts["K4"] + counts["K3"] + counts["K2"] == 0, f"{tag}: a window kernel ran")
        check(counts["K1"] == (it_s + 1) + (it_u + 1) + 1,
              f"{tag}: K1 launches {counts['K1']} != operator applies")
    return run, lat


def window_routing() -> dict:
    """``auto`` under the default environment at 131072 x 768 x k8 on the
    locality corpus (coverage 1.0) and the Gaussian corpus, and at 16384 on
    the locality corpus: each decision held to the rule and to the route
    PERF.md's sweep gives (gather everywhere: the card's MIN_N is never
    reached).  Then the unforced branches driven on the card under the JAX
    package's values (`JAX_ROUTING`): the locality corpus accepted on
    coverage, the clustered corpus on bounded stragglers, each through K4
    and held to the gather flow on the same corpus (ΔH within
    WINDOWED_VS_GATHER_TOL, bundle ids equal), the Gaussian corpus refused;
    and the smallest such lattice (16384, MIN_N lowered to it) held to the
    CPU lattice on the card's graph.  Launches counted from 0 before each
    flow."""
    default = {name: None for name in ROUTING_NAMES}
    rows: dict = {}
    Y, psi = locality_corpus(CORPUS["n"], CORPUS["d"])
    gather, lat = routed_flow("window_routing locality", Y, psi, CORPUS["k"], default)
    del lat
    rows["locality"] = gather
    drive = {**default, **JAX_ROUTING}
    win, lat = routed_flow("window_routing locality jax_values", Y, psi, CORPUS["k"], drive)
    del lat
    rows["locality_jax_values"] = win
    Yc, psic = clustered_corpus(CORPUS["n"], CORPUS["d"])
    gather_c, lat = routed_flow("window_routing clustered", Yc, psic, CORPUS["k"],
                                {**default, "OSCILLINK_WINDOWED_MATVEC": "0"})
    del lat
    rows["clustered_gather"] = gather_c
    bounded, lat = routed_flow("window_routing clustered jax_values", Yc, psic, CORPUS["k"],
                               drive)
    del lat, Yc, psic
    rows["clustered_jax_values"] = bounded
    Yg, psig = data(CORPUS["n"], CORPUS["d"])
    rows["gaussian"] = routed_flow("window_routing gaussian", Yg, psig, CORPUS["k"], default)[0]
    with env(**drive):
        lat = Oscillink(Yg, kneighbors=CORPUS["k"])
        rows["gaussian_jax_values"] = {"decision": routing_decision(lat),
                                       "constants": routing_constants()}
        rows["gaussian_jax_values"]["rule_reason"] = rule_reason(
            CORPUS["n"], rows["gaussian_jax_values"]["decision"], routing_constants())
        del lat, Yg, psig
    Ys, psis = locality_corpus(ROUTING_SMALL["n"], ROUTING_SMALL["d"],
                               clusters=ROUTING_SMALL["n"] // 8)
    rows["small"] = routed_flow("window_routing small", Ys, psis, ROUTING_SMALL["k"], default)[0]
    torch.cuda.empty_cache()
    for tag, want in ROUTING_EXPECT.items():
        check(rows[tag]["decision"]["reason"] == want,
              f"window_routing {tag}: {rows[tag]['decision']['reason']!r}, the sweep gives {want!r}")
    for tag, ref in (("locality_jax_values", gather), ("clustered_jax_values", gather_c)):
        rel = abs(rows[tag]["deltaH"] - ref["deltaH"]) / max(abs(ref["deltaH"]), 1e-30)
        rows[tag]["deltaH_rel_vs_gather"] = rel
        check(rel <= WINDOWED_VS_GATHER_TOL, f"window_routing {tag}: deltaH vs gather {rel}")
        check(rows[tag]["bundle"] == ref["bundle"], f"window_routing {tag}: bundle ids differ")
    check(rows["gaussian_jax_values"]["decision"]["reason"]
          == rows["gaussian_jax_values"]["rule_reason"], "window_routing gaussian jax_values")
    # the smallest auto-routed size, card against the CPU on the card's graph
    with env(**{**drive, "OSCILLINK_WINDOWED_MIN_N": str(ROUTING_SMALL["n"])}):
        small, lat = card_vs_cpu("window_routing_card_vs_cpu", Ys, psis, ROUTING_SMALL["k"], "K4")
        dec = routing_decision(lat)
        check(dec["reason"] == "coverage", f"window_routing_card_vs_cpu: {dec['reason']!r}")
        del lat
    for tag, row in rows.items():
        emit("window_routing", case=tag, **{key: val for key, val in row.items()
                                             if key != "bundle"})
    return {"launches": {**{tag: row["launches"] for tag, row in rows.items() if "launches" in row},
                         "card_vs_cpu": {"K4": small["launches"]}}}


def halo_rule(info: dict, c: dict) -> tuple:
    """The tier, ``window_skipped`` and reason the constants ``c`` give a
    halo-tier `solve_auto` call whose shard plans are in ``info``: where no
    plan can pass, gather as low coverage with no plan built."""
    rule = dict(forced=c["mode"] in thalo.FORCED, min_cov=c["min_coverage"],
                lowcov_bound=c["lowcov_smax"])
    if not tw.can_accept(**rule):
        return "halo-exchange", "low coverage", "low coverage"
    ok, reason = tw.accept_window_plan(info["window_coverage"], 0, True, info["window_s_max"],
                                       float("inf"), **rule)
    return ("halo-exchange-windowed", None, reason) if ok else ("halo-exchange", reason, reason)


def sorted_lists(g) -> torch.Tensor:
    """Each row's live neighbour ids, sorted, padding (-1) last."""
    ids = torch.where(g.w > 0, g.idx.long(), torch.full_like(g.idx, -1, dtype=torch.long))
    return ids.sort(dim=1, descending=True).values


def halo_graph_witness(mesh, Y: np.ndarray, psi: np.ndarray, k: int, U: np.ndarray) -> dict:
    """What the windowed halo tier's U (original row order) agrees with on
    the locality corpus, and why not with a lattice built from Y as given:
    the neighbour lists of `solve_auto`'s graph (the PCA order, the sharded
    build) that differ from `build_graph` on the same reordered Y and from
    the lattice's graph built in the original order; U against the
    single-device solve on `solve_auto`'s own graph (held at MESH_HALO_TOL)
    and, as a reading only, against the original-order lattice's U*."""
    n = Y.shape[0]
    order = tpar.pca_bisection_order(Y, levels=4, device=CARD)
    (Y_s,) = tpar.apply_order(order, Y)[:1]
    g = tshbuild.build_graph_sharded(mesh, Y_s, k, similarity="auto")
    Yd = torch.from_numpy(Y_s).to(CARD)
    sim = tgraph.resolve_similarity(n, "auto")
    g1 = tgraph.build_graph(Yd, k, similarity=sim)
    lat = Oscillink(Y, kneighbors=k, similarity="auto", device=CARD)
    lat.set_query(psi)
    g_lat = permuted_graph(lat.graph, order)
    ids = sorted_lists(g)
    out = {"similarity": sim,
           "lists_differ_vs_build_graph": int((ids != sorted_lists(g1)).any(1).sum()),
           "lists_differ_vs_lattice": int((ids != sorted_lists(g_lat)).any(1).sum())}
    lam = tcoh.EnergyParams.make(1.0, 0.5, 4.0, 0.0, device=CARD)
    U1, it1, _ = tcoh.solve_stationary(g, None, Yd, torch.from_numpy(psi).to(CARD),
                                       torch.ones(n, device=CARD), lam, tol=1e-4, max_iters=64)
    out["vs_own_graph"] = hold_mesh_u("window_routing_halo locality own graph", U[order], U1,
                                      MESH_HALO_TOL)
    out["own_graph_iters"] = int(it1)
    U_lat = lat._solve_ustar_device(tol=1e-4, max_iters=64)
    ref = U_lat.index_select(0, torch.from_numpy(order).to(CARD))
    got = torch.from_numpy(np.ascontiguousarray(U[order])).to(CARD)
    out["vs_lattice_rel"] = float((got - ref).abs().max()) / float(ref.abs().max())
    del g, g1, g_lat, lat, Yd, U1, U_lat, ref, got
    return out


def window_routing_halo() -> dict:
    """`solve_auto` at 131072 x 768 x k8 on 4 shards, on the locality corpus
    (shard coverage 1.0) and the clustered corpus (about 0.5, a 640-row
    straggler window).  Under the default environment no plan can pass the
    rule, so both take the gather halo tier as "low coverage" and build no
    shard plan.  Under the JAX package's values (`JAX_ROUTING`) the
    unforced branch accepts on coverage (locality) and on bounded stragglers
    (clustered).  Each tier and ``window_skipped`` held to `halo_rule`; the
    launches to the tier (K3 and K1 once a shard an apply windowed, K1 twice
    gathered); the windowed U to the gather halo tier's on the same order
    and graph, and on the locality corpus to the single-device solve on the
    same graph (`halo_graph_witness`)."""
    mesh = card_mesh()
    n, d, k = AUTO_MESH["n"], AUTO_MESH["d"], AUTO_MESH["k"]
    default = {name: None for name in ROUTING_NAMES}
    rows = {}
    for tag, (Y, psi) in (("locality", locality_corpus(n, d)),
                          ("clustered", clustered_corpus(n, d))):
        outs = {}
        for case, values, expect in ((tag, default, "halo-exchange"),
                                     (f"{tag}_jax_values", {**default, **JAX_ROUTING},
                                      "halo-exchange-windowed")):
            with env(**values):
                consts = routing_constants()
                st = mesh_step(lambda: tpar.solve_auto(mesh, Y, psi, k=k))
            U, info = st.pop("out")
            tier, skipped, reason = halo_rule(info, consts)
            check(info["tier"] == tier == expect and info["window_skipped"] == skipped,
                  f"window_routing_halo {case}: tier {info['tier']} skipped "
                  f"{info['window_skipped']!r}, the rule gives {tier} {skipped!r}, "
                  f"the sweep {expect}")
            if values is default:
                check(info["window_coverage"] is None,
                      f"window_routing_halo {case}: shard plans built where none can pass")
            applies = MESH_SHARDS * (info["iters"] + 1)
            if tier == "halo-exchange-windowed":
                check(st["launches"]["K3"] == applies and st["launches"]["K1"] == applies,
                      f"window_routing_halo {case}: launches {st['launches']}")
            else:
                check(st["launches"]["K1"] == 2 * applies and st["launches"]["K3"] == 0,
                      f"window_routing_halo {case}: launches {st['launches']}")
            outs[case] = U
            rows[case] = {**info, "rule_reason": reason, "constants": consts, **st}
        # the gather halo tier on the same order and graph (the reorder and
        # the build are the same calls on the same Y)
        U_g, U_w = outs[tag], outs[f"{tag}_jax_values"]
        rel = float(np.abs(U_w - U_g).max() / np.abs(U_g).max())
        it_g, it_w = rows[tag]["iters"], rows[f"{tag}_jax_values"]["iters"]
        check(rel <= WINDOWED_HALO_TOL and abs(it_w - it_g) <= 1,
              f"window_routing_halo {tag}: windowed vs gather halo tier {rel}, "
              f"iterations {it_w} vs {it_g}")
        rows[f"{tag}_jax_values"].update(windowed_vs_gather=rel, gather_iters=it_g)
        if tag == "locality":
            rows[f"{tag}_jax_values"]["graph_witness"] = halo_graph_witness(mesh, Y, psi, k, U_w)
        for case in (tag, f"{tag}_jax_values"):
            emit("window_routing_halo", case=case, **AUTO_MESH, shards=MESH_SHARDS, **rows[case])
        del outs, U_g, U_w, Y, psi
        torch.cuda.empty_cache()
    return {"launches": {case: {key: r["launches"][key] for key in ("K1", "K3")}
                         for case, r in rows.items()}}


def windowed_flow(lat: Oscillink, psi) -> dict:
    """A forced-windowed lattice: settle, U*, full receipt, bundle; settle
    and U* timed to a sync (one pass, the kernels warm from the phases
    before)."""
    info = ctx_info(lat)
    lat.set_query(psi)
    t0 = time.perf_counter()
    st = lat.settle(dt=1.0, max_iters=12, tol=1e-3)
    settle_ms = sync_ms(t0)
    t0 = time.perf_counter()
    lat._solve_ustar_device()  # the device solve alone; receipt() then hits the cache
    ustar_ms = sync_ms(t0)
    rec = lat.receipt()
    return {
        **info, "settle_ms": settle_ms, "ustar_ms": ustar_ms,
        "deltaH": rec["deltaH_total"], "null_points": len(rec["null_points"]),
        "bundle": [b["id"] for b in lat.bundle(k=8)], "state_sig": rec["meta"]["state_sig"],
        "settle_iters": st["iters"], "ustar_iters": rec["meta"]["ustar_iters"],
        "window_precision": rec["meta"].get("window_precision"),
    }


def near_tie_witness(Y: np.ndarray, idx_card: np.ndarray, idx_cpu: np.ndarray) -> dict:
    """Where the card's top-k and the CPU's differ, the f64 similarities of
    the two neighbours in each differing slot.  Each slot holds the row's
    k-th order statistic of its f32 similarities on both sides, so when the
    two differ only by rounding, the f64 gap is at most twice the sum of the
    two sides' worst f32 errors: 8 * gamma_(D+2) for unit rows (dot product
    and row norm on each side, gamma_n = n u / (1 - n u), u = 2^-24).
    A wrong neighbour lies far outside that; ulps are reported too."""
    rows, slots = np.nonzero(idx_card != idx_cpu)
    out = {"slots_differ": int(rows.size), "slots": int(idx_card.size)}
    d = Y.shape[1]
    nu = (d + 2) * 2.0**-24
    out["gap_bound"] = 8 * nu / (1 - nu)
    if rows.size == 0:
        return {**out, "max_gap": 0.0, "max_gap_ulps": 0.0}
    Yn = Y.astype(np.float64)
    Yn /= np.linalg.norm(Yn, axis=1, keepdims=True) + 1e-12
    s_card = np.einsum("ij,ij->i", Yn[rows], Yn[idx_card[rows, slots]])
    s_cpu = np.einsum("ij,ij->i", Yn[rows], Yn[idx_cpu[rows, slots]])
    gap = np.abs(s_card - s_cpu)
    ulp = np.spacing(np.maximum(np.abs(s_card), np.abs(s_cpu)).astype(np.float32))
    return {**out, "max_gap": float(gap.max()), "max_gap_ulps": float((gap / ulp).max())}


def card_vs_cpu(tag: str, Y, psi, k: int, kernel: str) -> tuple[dict, Oscillink]:
    """The forced-windowed flow on the card, launch counts set to 0 just
    before it and read just after, held to the port's CPU path on the card's
    graph.  cuBLAS and the CPU's BLAS round the f32 similarities differently,
    so near-tied neighbours can swap slots between the two builds: the phase
    counts those slots, holds their f64 gap to the rounding bound
    (`near_tie_witness`), and then compares the windowed tier on one graph."""
    reset_counts()
    t0 = time.perf_counter()
    lat = Oscillink(Y, kneighbors=k)
    gpu = windowed_flow(lat, psi)
    wall_ms = sync_ms(t0)
    counts = read_counts()
    ties = near_tie_witness(
        Y, lat.graph.idx.cpu().numpy(), build_graph(torch.from_numpy(Y), k).idx.numpy())
    lat_cpu = Oscillink(Y, kneighbors=k, device="cpu", graph=lat.graph)
    cpu = windowed_flow(lat_cpu, psi)
    del lat_cpu
    rel = abs(gpu["deltaH"] - cpu["deltaH"]) / max(abs(cpu["deltaH"]), 1e-30)
    emit(tag, cuda={key: val for key, val in gpu.items() if key != "bundle"}, cuda_wall_ms=wall_ms,
         cpu_settle_iters=cpu["settle_iters"], cpu_ustar_iters=cpu["ustar_iters"],
         bundle_ids=gpu["bundle"], launches=counts, deltaH_rel=rel,
         graph_build_cuda_vs_cpu=ties)
    check(ties["max_gap"] <= ties["gap_bound"],
          f"{tag}: the card's graph and the CPU's differ beyond rounding: {ties}")
    check(counts[kernel] > 0, f"{kernel} was not launched on the {tag} path")
    check(rel <= LATTICE_TOL, f"{tag} deltaH differs: {rel}")
    for key in ("null_points", "bundle", "state_sig", "settle_iters", "ustar_iters",
                "window_precision", "coverage", "stragglers", "s_max"):
        check(gpu[key] == cpu[key], f"{tag} {key}: cuda {gpu[key]} vs cpu {cpu[key]}")
    return {"launches": counts[kernel], **gpu}, lat


# -- the multi-query serving paths (kernel K1 at their shapes) -------------------


def queries(Y: np.ndarray, q: int) -> np.ndarray:
    """Q query vectors: the normalized means of rows 32i .. 32i + 31."""
    m = Y[: 32 * q].reshape(q, 32, -1).mean(axis=1)
    return (m / (np.linalg.norm(m, axis=1, keepdims=True) + 1e-12)).astype(np.float32)


def k1_device_ms(g, X, reps: int = 50) -> float:
    """K1's own device time per launch at (g, X), separated from the host's
    per-call cost, which bounds back-to-back calls of a small apply: CUDA
    events around ``reps`` launches queued behind a spin kernel, so the
    card runs them back to back and the span holds every launch.  Fails
    if the host had not queued them all before the spin ended."""
    spmv.lap_matvec_cuda(g.idx, g.wn, X)
    torch.cuda.synchronize()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    marks[0].record()
    torch.cuda._sleep(50_000_000)  # about 25 ms at the H100's clocks
    marks[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        spmv.lap_matvec_cuda(g.idx, g.wn, X)
    host_ms = 1000.0 * (time.perf_counter() - t0)
    marks[2].record()
    torch.cuda.synchronize()
    spin_ms = marks[0].elapsed_time(marks[1])
    check(host_ms < spin_ms, f"K1 device time: queuing took {host_ms} ms, the spin {spin_ms} ms")
    return marks[1].elapsed_time(marks[2]) / reps


def k1_case(shape: dict, g, X) -> dict:
    """K1 against its plain version on (g, X), rtol/atol TOL and bit-equal
    from launch to launch; then `time_kernel`'s times and bytes bound, and
    the kernel's own device time back to back (`k1_device_ms`)."""
    out, again = lap_matvec(g, X), lap_matvec(g, X)
    ref = spmv.lap_matvec_ref(g.idx, g.wn, X)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    check(bool(torch.isfinite(out).all()), f"K1 output not finite at {shape}")
    check(torch.allclose(out, ref, rtol=TOL, atol=TOL), f"K1 != plain at {shape}: {err}")
    check(torch.equal(out, again), f"K1 differs from launch to launch at {shape}")
    del out, again, ref
    n, k = g.idx.shape
    row = time_kernel({**shape, "n": n, "d": X.shape[1], "k": k,
                       "slab_cols": k1_slab_cols(n, X.shape[1], k)}, {"g": g, "X": X, "err": err})
    return {**row, "device_ms": k1_device_ms(g, X)}


def ragged_inputs() -> tuple[list, list]:
    """The /v1/bundle/ragged shape: corpora of N_i spread evenly from n_min
    to n_max, Gaussian rows (`data`), one query each."""
    r = RAGGED_BATCH
    sizes = np.linspace(r["n_min"], r["n_max"], r["corpora"]).astype(int)
    pairs = [data(int(n), r["d"], seed=100 + i) for i, n in enumerate(sizes)]
    return [Y for Y, _ in pairs], [p for _, p in pairs]


def ragged_union(corpora: list, k: int):
    """The union graph `bundle_ragged` builds for one k-group on the card:
    corpora zero-padded to its bucket, each graph built alone."""
    n_pad = -(-max(len(c) for c in corpora) // tragged._BUCKET) * tragged._BUCKET
    Ys = torch.zeros((len(corpora), n_pad, corpora[0].shape[1]), device="cuda")
    for i, c in enumerate(corpora):
        Ys[i, : len(c)] = torch.from_numpy(c).cuda()
    return union_graph([build_graph(Y, k) for Y in Ys])


def k1_narrow(corpus_g, ragged_g) -> list:
    """K1 at the serving paths' new widths: the corpus graph at D = 1 (one
    diffusion solve), D = BATCH_Q (the batched diffusion solve) and D = 16,
    the 4099-row graph at D = 3, and the ragged phase's union graph at
    D = 768."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for graph, g, d in (("corpus", corpus_g, 1), ("corpus", corpus_g, BATCH_Q),
                        ("corpus", corpus_g, 16), ("ragged_4099", ragged_g, 3)):
        X = torch.randn(g.n_nodes, d, generator=gen, device="cuda")
        rows.append(k1_case({"graph": graph}, g, X))
    gu = ragged_union(ragged_inputs()[0], RAGGED_BATCH["k"])
    X = torch.randn(gu.n_nodes, RAGGED_BATCH["d"], generator=gen, device="cuda")
    rows.append(k1_case({"graph": "ragged_union"}, gu, X))
    emit("k1_narrow", rows=rows, tol=TOL, bit_equal_repeat=True)
    return rows


def batched_parity() -> dict:
    """`solve_Ustar_batch` and `bundle_batch` on the card, launch counts set
    to 0 just before and read just after, against the port's CPU path on
    the card's graph: identical per-query iterations and bundle ids, U*
    within LANE_TOL of max|U|.  Two of the queries carry gates in [0, 1],
    so the lanes stop at different counts."""
    n, d, k, q = (BATCH_PARITY[key] for key in ("n", "d", "k", "q"))
    Y, _ = data(n, d, seed=3)
    psis = queries(Y, q)
    rng = np.random.default_rng(3)
    gates = np.ones((q, n), dtype=np.float32)
    gates[1], gates[4] = rng.random(n), rng.random(n)
    lat = Oscillink(Y, kneighbors=k)
    reset_counts()
    t0 = time.perf_counter()
    U = lat.solve_Ustar_batch(psis, gates)
    ustar_ms = sync_ms(t0)
    iters = lat.last_ustar_batch["iters"]
    t0 = time.perf_counter()
    bundles = [[b["id"] for b in qb] for qb in lat.bundle_batch(psis, gates, k=8)]
    bundle_ms = sync_ms(t0)
    counts = read_counts()
    bundle_iters = lat.last_ustar_batch["iters"]
    cpu = Oscillink(Y, kneighbors=k, device="cpu", graph=lat.graph)
    U_cpu = cpu.solve_Ustar_batch(psis, gates)
    cpu_iters = cpu.last_ustar_batch["iters"]
    cpu_bundles = [[b["id"] for b in qb] for qb in cpu.bundle_batch(psis, gates, k=8)]
    err = float(np.abs(U - U_cpu).max())
    scale = float(np.abs(U_cpu).max())
    emit("batched_parity", **BATCH_PARITY, iters=iters, cpu_iters=cpu_iters, launches=counts,
         max_abs_err=err, max_abs_U=scale, ustar_ms=ustar_ms, bundle_ms=bundle_ms,
         bundle_ids=bundles)
    check(U.shape == (q, n, d) and bool(np.isfinite(U).all()), "batched U* invalid")
    check(len(set(iters)) > 1, f"the batch's lanes all stopped together: {iters}")
    check(iters == cpu_iters, f"batched iterations: cuda {iters} vs cpu {cpu_iters}")
    check(bundle_iters == iters, f"bundle_batch iterations {bundle_iters} != U* batch {iters}")
    check(err <= LANE_TOL * scale, f"batched U*: cuda vs cpu {err} > {LANE_TOL} * {scale}")
    check(bundles == cpu_bundles, "batched bundle ids: cuda != cpu")
    check(counts["K1"] == 2 * (1 + max(iters)),
          f"K1 launches {counts['K1']} != 2 solves x (1 + {max(iters)})")
    check(counts["edge_dists"] == ED_PER_BUNDLE * q,
          f"edge_dists launches in bundle_batch {counts['edge_dists']} != {ED_PER_BUNDLE} x {q}")
    return {"launches": counts["K1"], "iters": iters, "edge_dists": counts["edge_dists"]}


def batched_corpus() -> dict:
    """The /v1/bundle batch path at the corpus tier: the corpus lattice,
    `diffusion_gates_batch` and `bundle_batch` for BATCH_Q queries, each
    timed to a sync with the launch counts set to 0 just before it; U* of
    the batch (`solve_Ustar_batch`) against the Q single solves on the card
    (identical iterations, U* within LANE_TOL of max|U|, identical bundle
    ids); the single diffusion solve (K1 at D = 1) against the CPU on the
    card's graph; then K1 at the batch's [N, Q·D] width."""
    n, d, k = CORPUS["n"], CORPUS["d"], CORPUS["k"]
    Y, _ = data(n, d)
    psis = queries(Y, BATCH_Q)
    t = {}
    t0 = time.perf_counter()
    lat = Oscillink(Y, kneighbors=k)
    t["build_ms"] = sync_ms(t0)
    launches = {}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    G = lat.diffusion_gates_batch(psis)
    t["gates_ms"] = sync_ms(t0)
    launches["gates"] = read_counts()["K1"]
    gate_iters = lat.last_gates["iters"]
    reset_counts()
    t0 = time.perf_counter()
    U = lat.solve_Ustar_batch(psis, G)
    t["ustar_ms"] = sync_ms(t0)
    launches["ustar"] = read_counts()["K1"]
    peak = torch.cuda.max_memory_allocated()
    iters = lat.last_ustar_batch["iters"]
    reset_counts()
    t0 = time.perf_counter()
    bundles = [[b["id"] for b in qb] for qb in lat.bundle_batch(psis, G, k=8)]
    t["bundle_ms"] = sync_ms(t0)
    launches["bundle"] = read_counts()["K1"]
    ed_launches = {"bundle_batch": edge_dists.launches, "bundle": []}
    bundle_iters = lat.last_ustar_batch["iters"]
    check(U.shape == (BATCH_Q, n, d) and bool(np.isfinite(U).all()), "corpus batch U* invalid")
    # the single-query path, one query at a time
    single_ms, single_iters, errs = [], [], []
    for qi in range(BATCH_Q):
        t0 = time.perf_counter()
        lat.set_query(psis[qi], gates=G[qi])
        Uq = lat._solve_ustar_device()
        before = edge_dists.launches
        ids = [b["id"] for b in lat.bundle(k=8)]
        ed_launches["bundle"].append(edge_dists.launches - before)
        single_ms.append(sync_ms(t0))
        single_iters.append(lat.last_ustar["iters"])
        errs.append(float((torch.from_numpy(U[qi]).cuda() - Uq).abs().max() / Uq.abs().max()))
        check(ids == bundles[qi], f"corpus batch bundle {qi}: {bundles[qi]} vs single {ids}")
    del U, Uq
    # every lane of the batched gates against its single diffusion solve on
    # the card (K1 at D = 1): gates within LANE_TOL, identical iterations
    gates_single_ms, single_gate_iters, lane_errs, gate_launches = [], [], [], []
    for qi in range(BATCH_Q):
        reset_counts()
        t0 = time.perf_counter()
        h = lat.diffusion_gates(psis[qi])
        gates_single_ms.append(sync_ms(t0))
        gate_launches.append(read_counts()["K1"])
        single_gate_iters.append(lat.last_gates["iters"])
        lane_errs.append(float(np.abs(h - G[qi]).max()))
        if qi == 0:
            h0 = h
    t["gates_single_ms"] = gates_single_ms
    launches["gates_single"] = gate_launches
    # one single solve against the CPU on the card's graph
    cpu = Oscillink(Y, kneighbors=k, device="cpu", graph=lat.graph)
    h_cpu = cpu.diffusion_gates(psis[0])
    cpu_gate_iters = cpu.last_gates["iters"]
    del cpu
    gate_err = float(np.abs(h0 - h_cpu).max())
    emit("batched_corpus", **CORPUS, queries=BATCH_Q, **t, single_query_ms=single_ms,
         batch_ms_per_query=(t["gates_ms"] + t["bundle_ms"]) / BATCH_Q,
         single_ms_per_query=statistics.mean(single_ms), max_memory_allocated_bytes=peak,
         iters=iters, single_iters=single_iters, gate_iters=gate_iters,
         single_gate_iters=single_gate_iters, cpu_gate_iters=cpu_gate_iters, launches=launches,
         edge_dists_launches=ed_launches, U_rel_err=errs, gates_cuda_vs_cpu=gate_err,
         gates_batch_vs_single=lane_errs, bundle_ids=bundles)
    check(iters == single_iters, f"corpus batch iterations {iters} != single {single_iters}")
    check(bundle_iters == iters, f"bundle_batch iterations {bundle_iters} != U* batch {iters}")
    check(max(errs) <= LANE_TOL, f"corpus batch U* vs single: {max(errs)}")
    check(gate_iters == single_gate_iters,
          f"corpus gate iterations: batch {gate_iters} != single {single_gate_iters}")
    check(launches["gates"] == 1 + max(gate_iters),
          f"K1 launches in the batched gates {launches['gates']} != 1 + {max(gate_iters)}")
    check(launches["ustar"] == 1 + max(iters),
          f"K1 launches in the batched U* {launches['ustar']} != 1 + {max(iters)}")
    check(launches["bundle"] == 1 + max(iters),
          f"K1 launches in bundle_batch {launches['bundle']} != 1 + {max(iters)}")
    check(ed_launches["bundle_batch"] == ED_PER_BUNDLE * BATCH_Q
          and ed_launches["bundle"] == [ED_PER_BUNDLE] * BATCH_Q,
          f"edge_dists launches {ed_launches}: {ED_PER_BUNDLE} a bundle, "
          f"{ED_PER_BUNDLE} x {BATCH_Q} a bundle_batch")
    check(gate_launches == [1 + it for it in single_gate_iters],
          f"K1 launches in the single gate solves {gate_launches} != 1 + {single_gate_iters}")
    check(cpu_gate_iters == single_gate_iters[0],
          f"corpus gate iterations: cuda {single_gate_iters[0]} vs cpu {cpu_gate_iters}")
    check(gate_err <= LANE_TOL, f"corpus diffusion gates: cuda vs cpu {gate_err}")
    check(max(lane_errs) <= LANE_TOL,
          f"corpus diffusion gates: batch lanes vs single solves {lane_errs}")
    # K1 at the batch's width: the [N, Q·D] view of the solve's blocks
    gen = torch.Generator(device="cuda").manual_seed(4)
    X = torch.randn(n, BATCH_Q * d, generator=gen, device="cuda")
    row = k1_case({"graph": "corpus", "queries": BATCH_Q}, lat.graph, X)
    del lat, X
    torch.cuda.empty_cache()
    return {"launches": launches, "edge_dists": ed_launches, "k1_row": row, "ms": t}


def diffusion_standalone() -> dict:
    """`compute_diffusion_gates` on the card against the CPU: dense direct
    at 4096 x 128 and CG (K1 at D = 1) at 5000 x 128, after checking that
    the card's and the CPU's graph builds agree slot for slot.  Launch
    counts set to 0 just before each card run and read just after."""
    out = {}
    for shape, method in ((DIFF_DIRECT, "direct"), (DIFF_CG, "cg")):
        n, d, k = shape["n"], shape["d"], shape["k"]
        Y, psi = data(n, d, seed=5)
        g = build_graph(torch.from_numpy(Y).cuda(), k)
        cpu_idx = build_graph(torch.from_numpy(Y), k).idx.numpy()
        ties = near_tie_witness(Y, g.idx.cpu().numpy(), cpu_idx)
        check(ties["slots_differ"] == 0, f"diffusion {method}: card and CPU graphs differ: {ties}")
        compute_diffusion_gates(Y, psi, kneighbors=k, method=method)  # warm
        reset_counts()
        t0 = time.perf_counter()
        h = compute_diffusion_gates(Y, psi, kneighbors=k, method=method)
        ms = sync_ms(t0)
        k1 = read_counts()["K1"]
        h_cpu = compute_diffusion_gates(Y, psi, kneighbors=k, method=method, device="cpu")
        err = float(np.abs(h - h_cpu).max())
        iters = None
        if method == "cg":
            s = diffusion_sources(torch.from_numpy(Y).cuda(), psi[None], 1.0)[:, 0]
            iters = screened_solve(g, s, 0.1, 1e-4, 256)[1]
        out[method] = {**shape, "ms": ms, "launches": k1, "iters": iters, "max_abs_err": err}
        check(h.shape == (n,) and bool(np.isfinite(h).all()), f"diffusion {method}: gates invalid")
        check(err <= LANE_TOL, f"diffusion {method}: cuda vs cpu {err}")
        check(k1 == (0 if iters is None else 1 + iters),
              f"diffusion {method}: K1 launches {k1}, iterations {iters}")
    emit("diffusion", **out)
    return out


def ragged_phase() -> dict:
    """`bundle_ragged` at the /v1/bundle/ragged shape, launch counts set to
    0 just before and read just after, against each corpus served alone by
    a lattice on the card (tests/test_ragged.py's bar).  One k-group: its
    K1 launches are the settle's 1 + max iterations plus the U* solve's."""
    r = RAGGED_BATCH
    corpora, psis = ragged_inputs()
    kw = dict(kneighbors=r["k"], bundle_k=r["bundle_k"])
    tragged.bundle_ragged(corpora, psis, **kw)  # warm
    reset_counts()
    t0 = time.perf_counter()
    res = tragged.bundle_ragged(corpora, psis, **kw)
    ms = sync_ms(t0)
    k1 = read_counts()["K1"]
    worst = {"score_rel": 0.0, "align_rel": 0.0}
    same_iters = 0
    t0 = time.perf_counter()
    for c, p, out in zip(corpora, psis, res):
        lat = Oscillink(c, kneighbors=r["k"])
        lat.set_query(p)
        st = lat.settle(max_iters=12, tol=1e-3)
        ref = lat.bundle(k=r["bundle_k"])
        same_iters += int(st["iters"] == out["iters"])
        check([e["id"] for e in out["bundle"]] == [e["id"] for e in ref],
              f"ragged bundle of the {len(c)}-row corpus differs from serving it alone")
        for got, want in zip(out["bundle"], ref):
            for key in ("score", "align"):
                gap = abs(got[key] - want[key])
                check(gap <= max(RAGGED_REL * abs(want[key]), RAGGED_ABS),
                      f"ragged {key} of the {len(c)}-row corpus: {got[key]} vs {want[key]}")
                worst[f"{key}_rel"] = max(worst[f"{key}_rel"], gap / max(abs(want[key]), 1e-30))
    alone_ms = sync_ms(t0)
    settle_iters, ustar_iters = [o["iters"] for o in res], [o["ustar_iters"] for o in res]
    expect = (1 + max(settle_iters)) + (1 + max(ustar_iters))
    emit("ragged", **r, ms=ms, served_alone_ms=alone_ms, k_groups=1,
         launches_per_k_group=[k1], settle_iters=settle_iters, ustar_iters=ustar_iters,
         same_iters_as_alone=same_iters, worst_rel=worst)
    check(k1 == expect, f"ragged K1 launches {k1} != {expect} (two solves, 1 + max each)")
    return {"launches": k1, "ms": ms}


def oneshot_phase() -> dict:
    """`settle_receipt_light` at the headline shape, launch counts set to 0
    just before and read just after, against the lattice's light receipt on
    the card: ΔH within LATTICE_TOL, identical iterations and edge count."""
    Y, psi = data(HEADLINE["n"], HEADLINE["d"])
    k = HEADLINE["k"]
    settle_receipt_light(Y, psi, kneighbors=k)  # warm
    runs = []
    for _ in range(3):
        reset_counts()
        t0 = time.perf_counter()
        out = settle_receipt_light(Y, psi, kneighbors=k)
        runs.append(sync_ms(t0))
        k1 = read_counts()["K1"]
    lat = Oscillink(Y, kneighbors=k)
    lat.set_query(psi)
    lat.set_receipt_detail("light")
    st = lat.settle(dt=1.0, max_iters=12, tol=1e-3)
    rec = lat.receipt()
    rel = abs(out["deltaH_total"] - rec["deltaH_total"]) / max(abs(rec["deltaH_total"]), 1e-30)
    emit("oneshot", **HEADLINE, ms=statistics.median(runs), runs_ms=runs, launches=k1,
         deltaH_rel=rel, **out)
    check(rel <= LATTICE_TOL, f"one-shot deltaH differs from the lattice's: {rel}")
    check(out["settle_iters"] == st["iters"] and out["ustar_iters"] == rec["meta"]["ustar_iters"],
          "one-shot iterations differ from the lattice's")
    check(out["edge_count"] == lat._n_edges // 2, "one-shot edge count differs")
    check(k1 == out["settle_iters"] + out["ustar_iters"] + 3,
          f"one-shot K1 launches {k1} != two solves (1 + iterations each) + deltaH")
    return {"launches": k1, "ms": statistics.median(runs)}


# -- the bucket-shuffle probe (kernel K5) ---------------------------------------


def k5_vs_plain(X, li, w, n_buckets: int, tag: str) -> float:
    """K5 against its plain version on the same inputs: bit-equal, since
    each element is one multiply on both sides."""
    out = bg.bucket_gather_cuda(X, li, w, n_buckets)
    ref = bg.bucket_gather_ref(X, li, w, n_buckets)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    check(torch.equal(out, ref), f"K5 != plain at {tag} (must be bit-equal): max abs {err}")
    return err


def bucket_gather_phase() -> dict:
    """K5 held bit-equal to its plain version at the probe's check shape, a
    ragged one and the full probe shape; then the port's probe at full size,
    every launch count set to 0 just before it and read just after.
    Returns K5's entry of the kernels line."""
    t0 = time.perf_counter()
    errs = {}
    for tag, n_buckets, d, e_pad in K5_SHAPES:
        X, li, w = (torch.from_numpy(a).cuda() for a in probe.random_case(n_buckets, d, e_pad))
        errs[tag] = k5_vs_plain(X, li, w, n_buckets, tag)
    errs["probe_check"] = probe.check_correct("cuda")
    inputs = probe.probe_tensors("cuda", PROBE_D)
    errs["probe"] = k5_vs_plain(inputs["X"], inputs["local_idx"], inputs["w"],
                                inputs["n_buckets"], "probe shape")
    reset_counts()
    res = probe.measure("cuda", inputs=inputs)
    counts = read_counts()
    del inputs
    emit("bucket_gather", max_abs_err=errs, launches=counts, phase_s=sync_ms(t0) / 1e3, **res)
    check(counts["K5"] > 0, "K5 was not launched on the probe path")
    check(res["embedding_bag_max_abs_diff"] <= 1e-6,
          f"library yardstick disagrees with K5: {res['embedding_bag_max_abs_diff']}")
    return {
        "name": "bucket_gather",
        "route": "cuda",
        "source": "oscillink_tpu_torch/csrc/bucket_gather.cu",
        "replaces": "benchmarks/probe_bucket_gather.py:65",
        "launches": counts["K5"],
        "max_abs_err": max(errs.values()),
        "ms": res["bucket_gather_ms"],
        "plain_ms": res["bucket_gather_plain_ms"],
        "bound_ms": res["bound_ms"],
        "bound_by": res["bound_by"],
        "library_ms": res["embedding_bag_ms"],
        "shape": res["config"],
        "effective_GBps": res["bucket_gather_effective_gbps"],
        "library_max_abs_err": res["embedding_bag_max_abs_diff"],
        "probe_decision": res["decision"],
    }


# -- similarity="auto": the fast scan, the IVF build, seeded builds, state ------


def scan_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The bf16 scan as a TF32 matmul of the bf16 values (exact in TF32's
    10-bit mantissa), TF32 allowed inside the call only."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return a.float() @ b.float().T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# the ways to compute the bf16 scan with f32 sums on the card: the port's
# (`graph.scan_bf16`, a bf16 GEMM with an f32 output) and two alternatives
SCAN_ROUTES = {
    "mm_out_dtype": tgraph.scan_bf16,
    "tf32": scan_tf32,
    "f32": lambda a, b: a.float() @ b.float().T,
}


def scan_routes() -> dict:
    """The bf16 scan's routes on one corpus row block, [1024, 768] against
    all 131072 rows, each held to the f64 product of the same bf16 values
    within the f32 summation bound gamma_D (unit rows) and timed by CUDA
    events; TF32 must be off again afterwards.  The port's route
    (`graph.scan_bf16`) must be the fastest."""
    n, d = CORPUS["n"], CORPUS["d"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    Yb = normalize_rows(torch.randn(n, d, generator=gen, device="cuda")).to(torch.bfloat16)
    a = Yb[:1024]
    ref = a.double() @ Yb.double().T
    nu = d * 2.0**-24
    bound = 1.01 * nu / (1 - nu)
    # bytes: both operands read once, the f32 block written once; operations
    # at the bf16 tensor-core peak
    bytes_moved = (a.numel() + Yb.numel()) * 2 + 1024 * n * 4
    bound_ms = 1e3 * max(bytes_moved / HBM_BYTES_PER_S, 2.0 * 1024 * n * d / BF16_FLOPS)
    routes = {}
    for name, fn in SCAN_ROUTES.items():
        S = fn(a, Yb)
        err = float((S.double() - ref).abs().max())
        routes[name] = {"dtype": str(S.dtype), "max_abs_err": err,
                        "ms": cuda_ms(lambda fn=fn: fn(a, Yb), reps=20)}
        check(S.dtype == torch.float32, f"bf16 scan route {name} gave {S.dtype}")
        check(err <= bound, f"bf16 scan route {name}: {err} > {bound}")
        del S
    emit("bf16_scan_routes", shape=f"[1024, {d}] x [{n}, {d}] bf16 -> f32", bound_ms=bound_ms,
         err_bound=bound, route_taken="mm_out_dtype", routes=routes)
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 left on after the scan routes")
    check(min(routes, key=lambda r: routes[r]["ms"]) == "mm_out_dtype",
          f"the port's bf16 scan route is not the fastest: {routes}")
    del ref, Yb, a
    torch.cuda.empty_cache()
    return routes


def lattice_flow(lat: Oscillink, psi, chain=(2, 5, 7, 9)) -> dict:
    """Settle, U*, full receipt, bundle and chain receipt on a built
    lattice, each timed to a sync; what the card and the CPU must agree
    on, and the K1 launches the flow must make (r0 + one per iteration in
    settle and U*, one in the full receipt, none in bundle and chain
    receipt, which reuse the cached U*)."""
    lat.set_query(psi)
    t = {}
    t0 = time.perf_counter()
    st = lat.settle(dt=1.0, max_iters=12, tol=1e-3)
    t["settle_ms"] = sync_ms(t0)
    t0 = time.perf_counter()
    lat._solve_ustar_device()
    t["ustar_ms"] = sync_ms(t0)
    t0 = time.perf_counter()
    rec = lat.receipt()
    t["receipt_full_ms"] = sync_ms(t0)
    t0 = time.perf_counter()
    bundle = [b["id"] for b in lat.bundle(k=8)]
    verdict = lat.chain_receipt(list(chain))["verdict"]
    t["bundle_chain_ms"] = sync_ms(t0)
    check(np.isfinite(rec["deltaH_total"]) and rec["deltaH_total"] >= 0, "deltaH invalid")
    check(len(bundle) == 8 and len(set(bundle)) == 8, "bundle ids invalid")
    return {
        "ms": t, "deltaH": rec["deltaH_total"], "null_points": len(rec["null_points"]),
        "bundle": bundle, "state_sig": rec["meta"]["state_sig"], "chain_verdict": verdict,
        "settle_iters": st["iters"], "ustar_iters": rec["meta"]["ustar_iters"],
        "applies": (st["iters"] + 1) + (rec["meta"]["ustar_iters"] + 1) + 1,
        "similarity": rec["meta"]["similarity"],
        "recall_target": rec["meta"]["similarity_recall_target"],
        "similarity_info": rec["meta"].get("similarity_info"),
    }


def graph_agreement(g, ref) -> dict:
    """Rows whose idx equal the reference graph's, and the weights held to
    rtol 1e-5, atol 1e-6 (tests/test_fast_similarity.py's bar) on the rows
    whose neighbourhood agrees: a row's capped weights depend on the mutual
    tests and row sums of its neighbours, so the bar skips rows within two
    hops (either direction, either graph) of a row whose idx differ; their
    count and largest weight difference are reported."""
    differ = ~(g.idx == ref.idx).all(dim=1)
    near = differ.clone()
    for _ in range(2):
        grown = near.clone()
        for idx in (g.idx.long(), ref.idx.long()):
            grown |= near[idx].any(dim=1)  # rows that list a marked row
            grown[idx[near].reshape(-1)] = True  # rows a marked row lists
        near = grown
    keep = ~near[:, None] & (g.w > 0) & (ref.w > 0)
    return {"rows_identical": float((~differ).double().mean()),
            "rows_within_two_hops": int(near.sum()),
            "w_within_bar": bool(torch.allclose(g.w[keep], ref.w[keep], rtol=1e-5, atol=1e-6)),
            "w_max_abs_diff_held": float((g.w[keep] - ref.w[keep]).abs().max()),
            "w_max_abs_diff_near": float((g.w - ref.w)[near].abs().max()) if bool(near.any()) else 0.0}


def fast_stage_ms(Y: torch.Tensor, k: int) -> dict:
    """The fast build's stages summed over its row blocks, each stage
    bracketed by CUDA events: the bf16 scan, the candidate top-k (4k a row;
    its tie check reads one flag to the host), the f32 rescore, the final
    top-k over the candidates; then `graph_from_topk` once."""
    n = Y.shape[0]
    Yn = normalize_rows(Y)
    Yb = Yn.to(torch.bfloat16)
    kc = min(4 * k, n - 1)
    names = ("scan", "candidate_topk", "rescore", "final_topk")
    ms = dict.fromkeys(names, 0.0)
    vals = torch.empty((n, k), device=Y.device)
    idx = torch.empty((n, k), dtype=torch.int32, device=Y.device)
    for r0 in range(0, n, tgraph.DEFAULT_BLOCK_ROWS):
        r1 = min(r0 + tgraph.DEFAULT_BLOCK_ROWS, n)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        S = tgraph.scan_bf16(Yb[r0:r1], Yb)
        rows = torch.arange(r1 - r0, device=Y.device)
        S[rows, rows + r0] = -torch.inf
        ev[1].record()
        cand = tgraph.stable_topk(S, kc)[1]
        ev[2].record()
        exact = torch.bmm(Yn[cand], Yn[r0:r1, :, None])[:, :, 0]
        exact = torch.where(cand == (rows + r0)[:, None], -torch.inf, exact)
        ev[3].record()
        v, sel = tgraph.stable_topk(exact, k)
        vals[r0:r1], idx[r0:r1] = v, torch.gather(cand, 1, sel).to(torch.int32)
        ev[4].record()
        ev[4].synchronize()
        for i, name in enumerate(names):
            ms[name] += ev[i].elapsed_time(ev[i + 1])
    t0 = time.perf_counter()
    graph_from_topk(vals, idx)
    ms["graph_from_topk"] = sync_ms(t0)
    return ms


def auto_corpus() -> dict:
    """The service's default request at the corpus tier: `similarity="auto"`
    at 131072 x 768 x k8 resolves to "fast".  Build, settle, U*, full
    receipt, bundle and chain receipt with the launch counts set to 0 just
    before and read just after; the fast graph held to the exact graph of
    the same run (the recall contract: rows with identical idx >= 0.99, and
    the weights bar); `"fastest"` built once (the same function off the
    TPU); `rebuild_graph(similarity="fast")` on the exact lattice gives the
    auto lattice's graph bit for bit."""
    n, d, k = CORPUS["n"], CORPUS["d"], CORPUS["k"]
    Y, psi = data(n, d)
    t = {}
    t0 = time.perf_counter()
    exact = Oscillink(Y, kneighbors=k)
    t["exact_build_ms"] = sync_ms(t0)
    exact_run = lattice_flow(exact, psi)
    t0 = time.perf_counter()
    Oscillink(Y, kneighbors=k, similarity="auto")  # first fast build: cuBLAS bf16 warm-up
    t["fast_first_build_ms"] = sync_ms(t0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    lat = Oscillink(Y, kneighbors=k, similarity="auto")
    t["build_ms"] = sync_ms(t0)
    run = lattice_flow(lat, psi)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 left on after the fast build")
    agree = graph_agreement(lat.graph, exact.graph)
    t0 = time.perf_counter()
    fastest = Oscillink(Y, kneighbors=k, similarity="fastest")
    t["fastest_build_ms"] = sync_ms(t0)
    fastest_same = all(torch.equal(a, b) for a, b in zip(fastest.graph, lat.graph))
    del fastest
    stages = fast_stage_ms(lat._Y_dev, k)
    exact.rebuild_graph(similarity="fast")
    rebuilt_same = all(torch.equal(a, b) for a, b in zip(exact.graph, lat.graph))
    rel = abs(run["deltaH"] - exact_run["deltaH"]) / max(abs(exact_run["deltaH"]), 1e-30)
    emit("auto_corpus", **CORPUS, **t, fast_stages_ms=stages, flow_ms=run["ms"],
         exact_flow_ms=exact_run["ms"],
         speedup_build=t["exact_build_ms"] / t["build_ms"], similarity=run["similarity"],
         recall_target=run["recall_target"], graph_vs_exact=agree,
         deltaH=run["deltaH"], deltaH_exact=exact_run["deltaH"], deltaH_rel_vs_exact=rel,
         settle_iters=run["settle_iters"], ustar_iters=run["ustar_iters"],
         exact_iters=[exact_run["settle_iters"], exact_run["ustar_iters"]],
         null_points=run["null_points"], bundle_ids=run["bundle"],
         bundle_ids_exact=exact_run["bundle"], chain_verdict=run["chain_verdict"],
         launches=counts, operator_applies=run["applies"], max_memory_allocated_bytes=peak,
         fastest_graph_equals_fast=fastest_same, rebuild_fast_bit_equal=rebuilt_same)
    check(lat._similarity == "fast" and run["similarity"] == "fast",
          f"auto resolved to {lat._similarity} at N = {n}")
    check(run["recall_target"] == 0.99, f"fast recall target {run['recall_target']}")
    check(agree["rows_identical"] >= 0.99, f"fast vs exact rows identical {agree}")
    check(agree["w_within_bar"], f"fast vs exact weights beyond the bar: {agree}")
    check(counts["K1"] == run["applies"],
          f"auto corpus K1 launches {counts['K1']} != operator applies {run['applies']}")
    check(fastest_same, "fastest's graph differs from fast's (the same function off the TPU)")
    check(rebuilt_same, "rebuild_graph(similarity='fast') differs from the auto build")
    del lat, exact
    torch.cuda.empty_cache()
    return {"launches": counts["K1"], "ms": t}


def fast_parity() -> dict:
    """The blocked fast path at 16384 x 768 (OSCILLINK_FAST_SIM_N=8192 makes
    auto take it) on the card, launch counts set to 0 just before and read
    just after, against the port on the CPU: idx identical except near-tie
    slots (`near_tie_witness`); then the CPU lattice on the card's graph:
    deltaH within 1e-5 relative, identical null count, bundle ids,
    state_sig and iterations."""
    n, d, k = FAST_PARITY["n"], FAST_PARITY["d"], FAST_PARITY["k"]
    Y, psi = data(n, d, seed=1)
    with env(OSCILLINK_FAST_SIM_N=str(FAST_PARITY["fast_sim_n"])):
        reset_counts()
        lat = Oscillink(Y, kneighbors=k, similarity="auto")
        gpu = lattice_flow(lat, psi)
        counts = read_counts()
        cpu_g = build_graph(torch.from_numpy(Y), k, similarity="fast")
        ties = near_tie_witness(Y, lat.graph.idx.cpu().numpy(), cpu_g.idx.numpy())
        lat_cpu = Oscillink(Y, kneighbors=k, similarity="auto", device="cpu", graph=lat.graph)
        cpu = lattice_flow(lat_cpu, psi)
    rel = abs(gpu["deltaH"] - cpu["deltaH"]) / max(abs(cpu["deltaH"]), 1e-30)
    emit("fast_parity", **FAST_PARITY, cuda_ms=gpu["ms"], graph_build_cuda_vs_cpu=ties,
         deltaH_rel=rel, launches=counts, similarity=gpu["similarity"],
         **{key: gpu[key] for key in ("null_points", "bundle", "state_sig", "settle_iters",
                                      "ustar_iters")})
    check(gpu["similarity"] == "fast", f"auto at N = {n} resolved to {gpu['similarity']}")
    check(ties["max_gap"] <= ties["gap_bound"], f"fast_parity graphs differ beyond rounding: {ties}")
    check(counts["K1"] == gpu["applies"], f"fast_parity K1 {counts['K1']} != {gpu['applies']}")
    check(rel <= LATTICE_TOL, f"fast_parity deltaH differs: {rel}")
    for key in ("null_points", "bundle", "state_sig", "settle_iters", "ustar_iters"):
        check(gpu[key] == cpu[key], f"fast_parity {key}: cuda {gpu[key]} vs cpu {cpu[key]}")
    return {"launches": counts["K1"]}


def study_corpus(n: int, d: int, seed: int = 0, centres: int = 1024, spread: float = 0.35):
    """The JAX package's IVF study corpora (benchmarks/
    probe_ivf_balanced_1m.py:31-41): Gaussian centres, rows = a uniformly
    drawn centre + spread * noise ("tight": 1024 centres, 0.35; "loose":
    0.6), made with numpy from the seed."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((centres, d), dtype=np.float32)
    assign = rng.integers(0, centres, size=n)
    Y = centers[assign]
    Y += np.float32(spread) * rng.standard_normal((n, d), dtype=np.float32)
    m = Y[:32].mean(axis=0)
    return Y, (m / (np.linalg.norm(m) + 1e-12)).astype(np.float32)


def ivf_stage_ms(Y: torch.Tensor, k: int) -> dict:
    """The IVF build's stages at the lattice's geometry, each timed to a
    sync: the clusterability pre-gate, the k-means (the Lloyd loop of
    `ivf_topk`: its bf16 scans and `_lloyd_update`s), the whole of
    `ivf_topk` (k-means, balance rounds, buckets, per-cluster scan,
    patches), `_sample_quality` and `graph_from_topk`."""
    n, d = Y.shape
    C = 1024
    P = tivf._round_up(int(2.0 * n / C), 128)
    t = {}
    t0 = time.perf_counter()
    tivf._clusterability(Y)
    t["clusterability_ms"] = sync_ms(t0)
    t0 = time.perf_counter()
    Yn = normalize_rows(Y)
    Yb = Yn.to(torch.bfloat16)
    cent = normalize_rows(Yn[:: max(n // C, 1)][:C])
    for _ in range(6):
        cent = tivf._lloyd_update(tgraph.scan_bf16(Yb, cent.to(torch.bfloat16)), Yn, cent, C, d)
    t["kmeans_ms"] = sync_ms(t0)
    del Yn, Yb, cent
    t0 = time.perf_counter()
    vals, idx, ovf, _ = tivf.ivf_topk(Y, k, n_clusters=C, bucket_cap=P, m_probe=8)
    t["ivf_topk_ms"] = sync_ms(t0)
    t["scan_ms"] = t["ivf_topk_ms"] - t["kmeans_ms"]
    t0 = time.perf_counter()
    tivf._sample_quality(Y, vals, idx, k)
    t["sample_quality_ms"] = sync_ms(t0)
    t0 = time.perf_counter()
    graph_from_topk(vals, idx)
    t["graph_from_topk_ms"] = sync_ms(t0)
    t["scan_group_clusters"] = tivf._scan_group_size(C, P, 8 * P)
    return t


def cluster_corpus() -> dict:
    """The cluster tier: `similarity="auto"` at 524288 x 768 x k8 resolves
    to "cluster".  On the JAX package's "loose" study corpus (1024 centres,
    spread 0.6; overflow 0 in its 1M study, benchmarks/ivf_balanced_1m.json)
    the IVF build must be accepted ("ivf", overflow 0, recall estimate >=
    0.9 or sim-gap p99 <= 0.01); settle, U*, full receipt, bundle and chain
    receipt run with the launch counts set to 0 just before and read just
    after, and the build's stages are timed apart.  Then two builds only:
    the "tight" study corpus (spread 0.35), reported as the gate decides it
    (its 1M study recorded 7 overflow rows, and any overflow row sends the
    build to the fast scan), and an isotropic corpus, which must fall back
    at the pre-gate."""
    n, d, k = CLUSTER["n"], CLUSTER["d"], CLUSTER["k"]
    t0 = time.perf_counter()
    Y, psi = study_corpus(n, d, centres=CLUSTER["centres"], spread=CLUSTER["spread"])
    data_s = time.perf_counter() - t0
    # the stages once before the lattice's build (the first IVF build of the
    # process) and once after it
    Yd = torch.from_numpy(Y).cuda()
    stages_first = ivf_stage_ms(Yd, k)
    del Yd
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    lat = Oscillink(Y, kneighbors=k, similarity="auto")
    build_ms = sync_ms(t0)
    del Y
    run = lattice_flow(lat, psi)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    info = run["similarity_info"]
    U = lat.U
    check(U.shape == (n, d) and bool(np.isfinite(U).all()), "cluster corpus U not finite")
    del U
    Yd, g = lat._Y_dev, lat.graph
    del lat
    torch.cuda.empty_cache()
    sweep = k1_graph_sweep(CLUSTER, g, seed=7)
    del g
    stages = ivf_stage_ms(Yd, k)
    del Yd
    torch.cuda.empty_cache()
    emit("cluster_corpus", **CLUSTER, data_s=data_s, build_ms=build_ms,
         stages_first_ms=stages_first, stages_ms=stages,
         flow_ms=run["ms"], similarity=run["similarity"], recall_target=run["recall_target"],
         similarity_info=info, deltaH=run["deltaH"], settle_iters=run["settle_iters"],
         ustar_iters=run["ustar_iters"], null_points=run["null_points"],
         bundle_ids=run["bundle"], chain_verdict=run["chain_verdict"], launches=counts,
         operator_applies=run["applies"], max_memory_allocated_bytes=peak)
    check(run["similarity"] == "cluster", f"auto at N = {n} resolved to {run['similarity']}")
    check(info["mode"] == "ivf", f"the loose corpus fell back: {info}")
    check(info["overflow_patched"] == 0, f"IVF overflow {info['overflow_patched']}")
    check(info["recall_estimate"] >= 0.9 or info["sim_gap_p99"] <= 0.01, f"IVF quality {info}")
    check(counts["K1"] == run["applies"],
          f"cluster corpus K1 launches {counts['K1']} != operator applies {run['applies']}")
    # the tight study corpus, build only: accepted, or sent to the fast scan
    # by overflow rows
    Y, _ = study_corpus(n, d, centres=CLUSTER["centres"], spread=TIGHT_SPREAD)
    t0 = time.perf_counter()
    tight = Oscillink(Y, kneighbors=k, similarity="auto")
    tight_ms = sync_ms(t0)
    tight_info = tight._similarity_info
    del tight, Y
    torch.cuda.empty_cache()
    emit("cluster_tight", **{**CLUSTER, "spread": TIGHT_SPREAD}, build_ms=tight_ms,
         similarity_info=tight_info)
    check(tight_info["mode"] == "ivf" or "overflow" in tight_info["reason"],
          f"tight corpus: {tight_info}")
    # the isotropic corpus of the same shape: the pre-gate falls back to the
    # fast scan without paying the cluster scan
    Y, _ = data(n, d, seed=2)
    Yi = torch.from_numpy(Y).cuda()
    t0 = time.perf_counter()
    obs, null = (float(v) for v in torch.stack(tivf._clusterability(Yi)).tolist())
    pregate_ms = sync_ms(t0)
    del Yi
    t0 = time.perf_counter()
    iso = Oscillink(Y, kneighbors=k, similarity="auto")
    iso_ms = sync_ms(t0)
    iso_info = iso._similarity_info
    del iso, Y
    torch.cuda.empty_cache()
    emit("cluster_isotropic", n=n, d=d, k=k, build_ms=iso_ms, pregate_ms=pregate_ms,
         fallback_build_ms=iso_ms - pregate_ms, clusterability=obs, clusterability_null=null,
         similarity_info=iso_info)
    check(iso_info["mode"] == "fallback-fast", f"isotropic corpus: {iso_info}")
    check("clusterability" in iso_info["reason"], f"isotropic fallback reason: {iso_info}")
    return {"launches": counts["K1"], "build_ms": build_ms, "sweep": sweep}


def ivf_parity() -> dict:
    """The IVF build on the card against the port on the CPU, on a tight
    corpus of 2048 centres at 65536 x 128 and the default geometry (C =
    1024, P = 128, m = 8; with 1024 centres 8 rows overflow their buckets
    in both packages, the JAX package's too, and both fall back):
    the same info keys and mode, floats within 1e-5, identical idx on >=
    0.999 of rows, a second card build bit-equal to the first; then the
    CPU lattice on the card's graph: deltaH within 1e-5 relative."""
    n, d, k = IVF_PARITY["n"], IVF_PARITY["d"], IVF_PARITY["k"]
    Y, psi = study_corpus(n, d, seed=3, centres=IVF_PARITY["centres"])
    Yd = torch.from_numpy(Y).cuda()
    g, info = tivf.build_graph_ivf(Yd, k)
    g2, _ = tivf.build_graph_ivf(Yd, k)
    repeat_equal = all(torch.equal(a, b) for a, b in zip(g, g2))
    del g2, Yd
    g_cpu, info_cpu = tivf.build_graph_ivf(torch.from_numpy(Y), k)
    rows = float((g.idx.cpu() == g_cpu.idx).all(dim=1).double().mean())
    floats = {key: abs(val - info_cpu[key]) for key, val in info.items()
              if isinstance(val, float)}
    with env(OSCILLINK_CLUSTER_SIM_N=str(n)):
        reset_counts()
        lat = Oscillink(Y, kneighbors=k, similarity="auto")
        gpu = lattice_flow(lat, psi)
        counts = read_counts()
        graph_same = all(torch.equal(a, b) for a, b in zip(lat.graph, g))
        lat_cpu = Oscillink(Y, kneighbors=k, similarity="auto", device="cpu", graph=lat.graph)
        cpu = lattice_flow(lat_cpu, psi)
    rel = abs(gpu["deltaH"] - cpu["deltaH"]) / max(abs(cpu["deltaH"]), 1e-30)
    emit("ivf_parity", **IVF_PARITY, info_cuda=info, info_cpu=info_cpu, float_diffs=floats,
         rows_identical=rows, repeat_bit_equal=repeat_equal, lattice_graph_equal=graph_same,
         deltaH_rel=rel, launches=counts, similarity=gpu["similarity"],
         **{key: gpu[key] for key in ("null_points", "bundle", "state_sig", "settle_iters",
                                      "ustar_iters")})
    check(info["mode"] == info_cpu["mode"] == "ivf", f"ivf_parity modes {info} vs {info_cpu}")
    check(list(info) == list(info_cpu), "ivf_parity info keys differ")
    check(all(v <= 1e-5 for v in floats.values()), f"ivf_parity info floats: {floats}")
    check(rows >= 0.999, f"ivf_parity rows identical {rows}")
    check(repeat_equal, "two IVF builds on the card differ")
    check(graph_same, "the lattice's cluster graph differs from build_graph_ivf's")
    check(counts["K1"] == gpu["applies"], f"ivf_parity K1 {counts['K1']} != {gpu['applies']}")
    check(rel <= LATTICE_TOL, f"ivf_parity deltaH differs: {rel}")
    for key in ("null_points", "bundle", "state_sig", "settle_iters", "ustar_iters"):
        check(gpu[key] == cpu[key], f"ivf_parity {key}: cuda {gpu[key]} vs cpu {cpu[key]}")
    return {"launches": counts["K1"]}


def seeded_and_state(tmp_dir: str) -> dict:
    """`neighbor_seed` at N = 8192 (the row-blocked host build): the card
    and the CPU give identical idx, w and state_sig.  Then on the card
    `export_state` -> `from_state` and `save_state(npz)` -> `from_npz`:
    identical state_sig and deltaH within 1e-5 relative of each other and
    of the CPU's import of the same state."""
    n, d, k = SEEDED["n"], SEEDED["d"], SEEDED["k"]
    Y, psi = data(n, d, seed=4)
    reset_counts()
    t0 = time.perf_counter()
    lat = Oscillink(Y, kneighbors=k, neighbor_seed=SEEDED["seed"])
    build_ms = sync_ms(t0)
    gpu = lattice_flow(lat, psi)
    counts = read_counts()
    cpu_lat = Oscillink(Y, kneighbors=k, neighbor_seed=SEEDED["seed"], device="cpu")
    cpu = lattice_flow(cpu_lat, psi)
    same = {name: torch.equal(a.cpu(), b) for name, a, b in
            zip(("idx", "w", "wn", "sqrt_deg"), lat.graph, cpu_lat.graph)}
    t0 = time.perf_counter()
    state = lat.export_state()
    export_ms = sync_ms(t0)
    path = os.path.join(tmp_dir, "state.npz")
    lat.save_state(path, format="npz")
    t0 = time.perf_counter()
    imports = {"from_state": Oscillink.from_state(state)}
    import_ms = sync_ms(t0)
    imports["from_npz"] = Oscillink.from_npz(path)
    imports["from_state_cpu"] = Oscillink.from_state(state, device="cpu")
    imports["from_npz_cpu"] = Oscillink.from_npz(path, device="cpu")
    runs = {}
    for name, other in imports.items():
        other.settle(dt=1.0, max_iters=12, tol=1e-3)
        rec = other.receipt()
        runs[name] = {"state_sig": rec["meta"]["state_sig"], "deltaH": rec["deltaH_total"],
                      "similarity_info": rec["meta"].get("similarity_info")}
    rels = {name: abs(r["deltaH"] - gpu["deltaH"]) / abs(gpu["deltaH"]) for name, r in runs.items()}
    emit("seeded_and_state", **SEEDED, build_ms=build_ms, cuda_flow_ms=gpu["ms"],
         graph_cuda_equals_cpu=same, state_sig=gpu["state_sig"], launches=counts,
         export_ms=export_ms, import_ms=import_ms, imports=runs, imports_deltaH_rel=rels,
         exported_keys=sorted(state))
    check(all(same.values()), f"seeded graph: cuda vs cpu {same}")
    for key in ("state_sig", "null_points", "bundle", "settle_iters", "ustar_iters"):
        check(gpu[key] == cpu[key], f"seeded {key}: cuda {gpu[key]} vs cpu {cpu[key]}")
    check(counts["K1"] == gpu["applies"], f"seeded K1 {counts['K1']} != {gpu['applies']}")
    # the JSON state carries A_sparse (N > 2048) and installs it; the NPZ
    # carries no adjacency there, and its import rebuilds the seeded graph,
    # whose token is the original's
    check("A_sparse" in state and runs["from_state"]["similarity_info"] == {"mode": "imported"},
          f"from_state at N = {n}: {runs['from_state']}")
    for name in ("from_state", "from_npz"):
        check(runs[name]["state_sig"] == runs[f"{name}_cpu"]["state_sig"],
              f"{name}: cuda and cpu imports differ in state_sig")
    check(runs["from_npz"]["state_sig"] == gpu["state_sig"], "from_npz state_sig != the original's")
    check(max(rels.values()) <= LATTICE_TOL, f"imported deltaH differ: {rels}")
    return {"launches": counts["K1"]}


# -- the low-memory and column-chunked solves ---------------------------------


CHUNK_SOLVES = ("solve_stationary", "settle_step", "solve_stationary_windowed",
                "solve_stationary_windowed_fused", "settle_step_windowed",
                "settle_step_windowed_fused")


@contextlib.contextmanager
def chunk_iters():
    """Record the iteration count of every per-chunk solve: the chunked
    loops of `models.coherence` look their per-chunk solve up by name at
    each call, so wrapping those names sees each chunk (and nothing of a
    full-width solve, which the lattice calls through its own names)."""
    saved = {name: getattr(tcoh, name) for name in CHUNK_SOLVES}
    seen: list = []

    def wrap(fn):
        def solve(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen.append(out[1])
            return out
        return solve

    for name, fn in saved.items():
        setattr(tcoh, name, wrap(fn))
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(tcoh, name, fn)


def measured_step(fn) -> dict:
    """``fn`` run to a sync with the launch counts set to 0 and the peak
    counter reset just before: its ms, the per-chunk iterations it made,
    the bytes allocated before it and its ``max_memory_allocated``, and the
    launches it made."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_counts()
    with chunk_iters() as chunks:
        t0 = time.perf_counter()
        out = fn()
        ms = sync_ms(t0)
    return {"out": out, "ms": ms, "chunk_iters": list(chunks), "before": before,
            "peak": torch.cuda.max_memory_allocated(),
            "peak_reserved": torch.cuda.max_memory_reserved(), "launches": read_counts()}


def solve_steps(lat: Oscillink, kernel: str = "K1") -> dict:
    """Settle, U* and the full receipt on a built lattice, each a
    `measured_step`; each solve's ``kernel`` launches must equal its
    operator applies (r0 + one an iteration, summed over its chunks) and
    the receipt's K1 launches its column chunks.  Returns the steps and
    the receipt."""
    resident = lat._resident_blocks()
    settle = measured_step(lambda: lat.settle(dt=1.0, max_iters=12, tol=1e-3))
    settle.update(iters=lat.last["iters"], resident=resident)
    resident = lat._resident_blocks()
    ustar = measured_step(lambda: lat._solve_ustar_device())
    ustar.update(iters=lat.last_ustar["iters"], resident=resident)
    resident = lat._resident_blocks()
    receipt = measured_step(lat.receipt)
    receipt["resident"] = resident
    rec = receipt.pop("out")
    for name, step in (("settle", settle), ("ustar", ustar)):
        step.pop("out")
        its = step["chunk_iters"] or [step["iters"]]
        step["applies"] = sum(it + 1 for it in its)
        check(max(its) == step["iters"], f"{name}: chunk iterations {its} vs {step['iters']}")
        check(step["launches"][kernel] == step["applies"],
              f"{name}: {kernel} launches {step['launches'][kernel]} != operator applies "
              f"{step['applies']} (chunks {step['chunk_iters']})")
    check(rec["meta"]["ustar_cached"], "the receipt solved U* again")
    check(rec["meta"]["ustar_iters"] == ustar["iters"] and rec["cg_iters"] == settle["iters"],
          "the receipt's iterations are not the maxima over chunks")
    cc = lat._auto_col_chunks()
    check(receipt["launches"]["K1"] == cc,
          f"receipt: K1 launches {receipt['launches']['K1']} != its {cc} column chunks")
    return {"settle": settle, "ustar": ustar, "receipt": receipt, "rec": rec}


def receipt_values(rec: dict) -> dict:
    return {"deltaH": rec["deltaH_total"], "coh_drop_sum": rec["coh_drop_sum"],
            "anchor_pen_sum": rec["anchor_pen_sum"], "query_term_sum": rec["query_term_sum"],
            "null_points": len(rec["null_points"])}


def hold_chunked_receipt(tag: str, got: dict, ref: dict) -> dict:
    """The JAX package's bars for a chunked run against the full-width one
    (tests/test_chunked_receipts.py:65-91)."""
    rel = abs(got["deltaH"] - ref["deltaH"]) / max(abs(ref["deltaH"]), 1e-30)
    check(rel <= CHUNK_DH_REL, f"{tag}: deltaH differs from full width by {rel}")
    for key in ("coh_drop_sum", "anchor_pen_sum", "query_term_sum"):
        diff = abs(got[key] - ref[key])
        check(diff <= max(CHUNK_SUM_REL * abs(ref[key]), CHUNK_SUM_REL),
              f"{tag}: {key} {got[key]} vs full width {ref[key]}")
    check(got["null_points"] == ref["null_points"], f"{tag}: null points differ")
    return {"deltaH_rel": rel}


def step_row(step: dict, block: int) -> dict:
    """What a step reports: ms, iterations, launches, peak GB and its live
    blocks (the peak less what was allocated when it started, in [N, D]
    blocks)."""
    out = {key: step[key] for key in ("ms", "chunk_iters", "launches") if key in step}
    for key in ("iters", "applies", "resident"):
        if key in step:
            out[key] = step[key]
    out.update(peak_gb=step["peak"] / 1e9, before_gb=step["before"] / 1e9,
               peak_reserved_gb=step["peak_reserved"] / 1e9,
               live_blocks=(step["peak"] - step["before"]) / block)
    return out


def model_check(checks: list, tag: str, n: int, d: int, k: int, route: str, resident: int,
                col_chunks: int, step: dict, donated: bool = False,
                form: str | None = None) -> None:
    """The working-set model's estimate for a run configuration, with the
    full-width blocks held when it ran (the lattice's `_resident_blocks`
    and any the script holds) and the CG form it ran in (None: the one the
    lattice picked), must be at least its measured peak; recorded now,
    held at the end of the phase."""
    est = tlattice.working_set_bytes(n, d, k, route, resident, col_chunks, donated, form)
    checks.append({"tag": tag, "route": route, "resident": resident, "col_chunks": col_chunks,
                   "donated": donated, "form": form, "estimate_gb": est / 1e9,
                   "peak_gb": step["peak"] / 1e9, "ok": est >= step["peak"]})


def first_chunked_n(d: int, k: int, capacity: int, routes: list) -> int:
    """The least N (to 1024 rows) at which `auto_col_chunks` takes c > 1."""
    lo, hi = 1024, 1 << 28
    while hi - lo > 1024:
        mid = (lo + hi) // 2
        if tlattice.auto_col_chunks(mid, d, k, capacity, routes) > 1:
            hi = mid
        else:
            lo = mid
    return hi


def model_decisions(lat: Oscillink, capacity: int) -> dict:
    """The models' decisions at this lattice's size on this card, and what
    the card holds outside the caching allocator (the CUDA context)."""
    n, d, k = lat.N, lat.D, lat._kneighbors
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    return {
        "total_memory": capacity,
        "outside_allocator_bytes": total - free - torch.cuda.memory_reserved(),
        "col_chunks": lat._auto_col_chunks(),
        "col_chunks_gather_settle": lat._auto_col_chunks_gather(2),
        "col_chunks_gather_ustar": lat._auto_col_chunks_gather(1),
        "lowmem_solve_bytes": tcoh.LOWMEM_SOLVE_BYTES,
        "lowmem_at_this_n": tcoh._pick_cg(lat._Y_dev) is tcoh.cg_solve_lowmem,
        # the gather solves with Y, U and the U* cache held, the most the
        # lattice holds beside them
        "first_chunked_n_gather": first_chunked_n(d, k, capacity, [("settle", 3), ("ustar", 3)]),
        "first_chunked_n_receipt": first_chunked_n(d, k, capacity, [("receipt", 3)]),
        "n": n,
    }


def cg_form(lat: Oscillink, form: str, fn):
    """``fn`` with the solves' CG form forced: "classic" or "lowmem"."""
    saved = tcoh.LOWMEM_SOLVE_BYTES
    tcoh.LOWMEM_SOLVE_BYTES = 0 if form == "lowmem" else 1 << 62
    try:
        return fn()
    finally:
        tcoh.LOWMEM_SOLVE_BYTES = saved


def million() -> dict:
    """The JAX package's 1M study shape: 1,000,000 x 768 x k8 on the loose
    IVF study corpus.  ``similarity="auto"`` must resolve to "cluster" and
    the IVF build be accepted with overflow 0.  The whole flow full width
    (settle, U*, full receipt, bundle, chain receipt), then settle, U* and
    the full receipt again on the same graph from the same start under
    OSCILLINK_COL_CHUNKS = 4 and 8, each held to the full-width run; then
    the classic and the low-memory CG on the same inputs (identical
    iterations, U within FORM_TOL of max|U|; U* timed in turns).  K1's
    launches are counted from 0 before each step and must equal its
    operator applies; every step's peak must lie under the working-set
    model's estimate.  Last, K1 against its plain version at the chunk
    widths on this graph."""
    n, d, k = MILLION["n"], MILLION["d"], MILLION["k"]
    block = n * d * 4
    t0 = time.perf_counter()
    Y, psi = study_corpus(n, d, centres=MILLION["centres"], spread=MILLION["spread"])
    data_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    reset_counts()
    t0 = time.perf_counter()
    lat = Oscillink(Y, kneighbors=k, similarity="auto")
    build_ms = sync_ms(t0)
    del Y
    lat.set_query(psi)
    info = lat._similarity_info
    check(lat._similarity == "cluster", f"auto at N = {n} resolved to {lat._similarity}")
    check(info["mode"] == "ivf" and info["overflow_patched"] == 0, f"1M IVF build: {info}")
    capacity = torch.cuda.get_device_properties(0).total_memory
    decisions = model_decisions(lat, capacity)
    checks: list = []
    cc0 = lat._auto_col_chunks()
    full = solve_steps(lat)
    t0 = time.perf_counter()
    bundle = [b["id"] for b in lat.bundle(k=8)]
    chain = lat.chain_receipt([2, 5, 7, 9])
    bundle_chain_ms = sync_ms(t0)
    ref = receipt_values(full["rec"])
    emit("million_full", **MILLION, data_s=data_s, build_ms=build_ms, similarity_info=info,
         decisions=decisions, bundle_chain_ms=bundle_chain_ms, receipt_values=ref,
         **{key: step_row(full[key], block) for key in ("settle", "ustar", "receipt")})
    check(lat._U_dev.shape == (n, d) and bool(torch.isfinite(lat._U_dev).all()),
          "1M U not finite")
    check(np.isfinite(ref["deltaH"]) and ref["deltaH"] >= 0, "1M deltaH invalid")
    check(len(bundle) == 8 and len(set(bundle)) == 8, "1M bundle ids invalid")
    for route in ("settle", "ustar", "receipt"):
        model_check(checks, f"full_{route}", n, d, k, route, full[route]["resident"], cc0,
                    full[route])
    runs = {"full": {key: step_row(full[key], block) for key in ("settle", "ustar", "receipt")}}
    runs["full"].update(receipt_values=ref, bundle_ids=bundle, bundle_chain_ms=bundle_chain_ms,
                        chain_verdict=chain["verdict"], col_chunks=cc0)
    # the chunked runs on the same graph, U reset to the fresh lattice's Y
    for c in MILLION_CHUNKS:
        lat._U_dev = lat._Y_dev
        lat._invalidate_cache()
        with env(OSCILLINK_COL_CHUNKS=str(c)):
            steps = solve_steps(lat)
            ids = [b["id"] for b in lat.bundle(k=8)]
        got = receipt_values(steps["rec"])
        for route in ("settle", "ustar", "receipt"):
            model_check(checks, f"c{c}_{route}", n, d, k, route, steps[route]["resident"], c,
                        steps[route])
        runs[f"c{c}"] = {key: step_row(steps[key], block) for key in ("settle", "ustar", "receipt")}
        runs[f"c{c}"].update(receipt_values=got, bundle_ids=ids)
        emit("million_chunked", col_chunks=c, **runs[f"c{c}"])
        runs[f"c{c}"].update(hold_chunked_receipt(f"million c={c}", got, ref))
        check(ids == bundle, f"million c={c}: bundle ids {ids} vs full width {bundle}")
        del steps
    # the two CG forms on the same inputs: the settle from the fresh start
    # (U is Y), the settle from a settled U (which the low-memory form then
    # writes in place) and U*; the classic result is held while the
    # low-memory form runs, one more resident block
    U_start = lat._U_dev  # settled, by the c = 8 run
    lat._invalidate_cache()
    forms: dict = {"classic": {}, "lowmem": {}}
    form_errs = {}
    # resident [N, D] blocks of each measurement: Y and the held start U;
    # the settled settle's own U copy
    base = {"settle_fresh": 2, "settle_settled": 3, "ustar": 2}
    for key, res in base.items():
        vals = {}
        for form in ("classic", "lowmem"):
            if key == "settle_fresh":
                lat._U_dev = lat._Y_dev
            elif key == "settle_settled":
                lat._U_dev = U_start.clone()  # held by the lattice alone: the donated route
            else:
                lat._U_dev = U_start
            if key == "ustar":
                st = cg_form(lat, form, lambda: measured_step(
                    lambda: lat._solve_ustar_device(use_cache=False)))
                st["iters"] = lat.last_ustar["iters"]
                vals[form] = st.pop("out")
            else:
                st = cg_form(lat, form, lambda: measured_step(
                    lambda: lat.settle(dt=1.0, max_iters=12, tol=1e-3)))
                st["iters"] = lat.last["iters"]
                st.pop("out")
                vals[form] = lat._U_dev
            lat._U_dev = U_start
            check(st["launches"]["K1"] == st["iters"] + 1,
                  f"{form} {key}: K1 launches {st['launches']['K1']} != {st['iters']} + 1")
            donated = key == "settle_settled" and form == "lowmem"
            model_check(checks, f"{form}_{key}", n, d, k, "ustar" if key == "ustar" else "settle",
                        res + (form == "lowmem"), 1, st, donated=donated, form=form)
            forms[form][key] = st
        scale = float(vals["classic"].abs().max())
        form_errs[key] = float((vals["classic"] - vals["lowmem"]).abs().max()) / scale
        del vals
        emit("million_forms", step=key, rel_err=form_errs[key],
             **{form: step_row(forms[form][key], block) for form in forms})
        check(forms["classic"][key]["iters"] == forms["lowmem"][key]["iters"],
              f"{key}: classic {forms['classic'][key]['iters']} vs low-memory "
              f"{forms['lowmem'][key]['iters']} iterations")
        check(form_errs[key] <= FORM_TOL, f"{key}: classic vs low-memory U {form_errs[key]}")
    # U* in turns, classic and low-memory, on the same inputs
    lat._invalidate_cache()
    turn_ms: dict = {"classic": [], "lowmem": []}
    for _ in range(FORM_TURNS):
        for form in ("classic", "lowmem"):
            t0 = time.perf_counter()
            cg_form(lat, form, lambda: lat._solve_ustar_device(use_cache=False))
            turn_ms[form].append(sync_ms(t0))
    # the checkpoint: saved from this lattice, restored once it is freed
    saved = checkpoint_save(lat)
    # the mesh tiers' references on this graph (the lattice's last use)
    refs = mesh_references(lat)
    # K1 against its plain version at the chunk widths on this graph
    g = lat.graph
    del lat, U_start
    torch.cuda.empty_cache()
    ckpt = checkpoint_restore(saved, g, full, ref)
    del saved
    torch.cuda.empty_cache()
    # the mesh tiers on this graph, 4 shards on the card (sharded_million)
    sharded = sharded_million(**refs)
    del refs
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(5)
    k1_rows, chunk_sweeps = [], []
    for c in MILLION_CHUNKS:
        X = torch.randn(n, d // c, generator=gen, device="cuda")
        k1_rows.append(k1_case({"case": f"million_chunk_c{c}"}, g, X))
        chunk_sweeps.append(k1_slab_sweep({"n": n, "d": d // c, "k": k}, {"g": g, "X": X}))
        del X
    # K1 at full width on this graph against its plain version and
    # torch.sparse.mm, then its slab widths swept
    X = torch.randn(n, d, generator=gen, device="cuda")
    k1_full = k1_case({"case": "million_full_width"}, g, X)
    sweep = k1_slab_sweep({"n": n, "d": d, "k": k}, {"g": g, "X": X})
    del X, g
    torch.cuda.empty_cache()
    emit("million", **MILLION, decisions=decisions, form_rel_err=form_errs,
         ustar_turns_ms=turn_ms,
         ustar_median_ms_in_turns={form: statistics.median(turn_ms[form]) for form in turn_ms},
         model_checks=checks, k1_chunk_widths=k1_rows, k1_full_width=k1_full)
    for row in checks:
        check(row["ok"], f"working-set model under the measured peak: {row}")
    launches = {f"{run}_{key}": runs[run][key]["launches"]["K1"]
                for run in runs for key in ("settle", "ustar", "receipt")}
    return {"launches": launches, "k1_rows": k1_rows, "k1_full": k1_full, "sweep": sweep,
            "chunk_sweeps": chunk_sweeps, "checkpoint": ckpt, "sharded": sharded}


def window_chunk_kernels(lat: Oscillink, widths: dict) -> list:
    """K4 (fused, at a multiple of 128), K3 and K2 (K2 alone, without its
    epilogue) against their gather-form plain versions on a lattice's
    window context at the chunk widths ``widths`` ({kernel: D/c}), timed
    beside the plain version, with their bounds."""
    ctx = lat._window_ctx
    plan, W, s_max = ctx.plan, ctx.W, ctx.s_max
    R = plan.n_pad // plan.n_blocks
    cnt = plan.strag_cnt.cpu().numpy()
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for key, width in widths.items():
        X = tw.pad_rows(torch.randn(lat.N, width, generator=gen, device="cuda"), plan.n_pad)
        g = 1.5 + torch.rand(plan.n_pad, 1, generator=gen, device="cuda")
        calls = {
            "K2": (lambda: (tw.window_spmv_cuda(plan, X, W, R, "bf16x3"),),
                   lambda: (tw.window_spmv_gather_ref(plan, X, W, R, "bf16x3"),)),
            "K3": (lambda: (tw.window_spmv3_cuda(plan, X, W, R, s_max, "bf16x3"),),
                   lambda: (tw.window_spmv3_gather_ref(plan, X, W, R, s_max, "bf16x3"),)),
            "K4": (lambda: tw.window_spmv3f_cuda(plan, X, g, W, R, s_max, "bf16x3"),
                   lambda: tw.window_spmv3f_gather_ref(plan, X, g, W, R, s_max, "bf16x3")),
        }[key]
        out, ref = calls[0](), calls[1]()
        torch.cuda.synchronize()
        errs = []
        for o, r, tol in zip(out, ref, (GATHER_TOL, GATHER_PAP_TOL)):
            err = float((o - r).abs().max())
            check(bool(torch.isfinite(o).all()) and err <= tol * float(r.abs().max()),
                  f"{key} at D = {width} != its gather plain version: {err}")
            errs.append(err)
        case = {"plan": plan, "Xpad": X, "nnz": {
            "strag_w": int(torch.count_nonzero(plan.strag_w)),
            "wnl": int(torch.count_nonzero(plan.wnl)),
            "strag_seg": int(np.minimum(cnt, s_max).sum())}}
        rows.append({"kernel": key, "d": width, "n_pad": plan.n_pad, "max_abs_err": errs[0],
                     **({"pap_max_abs_err": errs[1]} if key == "K4" else {}),
                     "ms": cuda_ms(calls[0], 20), "plain_ms": cuda_ms(calls[1], 3),
                     **window_bound(case, key)})
        del X, g, out, ref
    return rows


def windowed_chunked() -> dict:
    """The windowed tier under column chunks (OSCILLINK_WINDOWED_MATVEC=1).
    On the locality-ordered 131072 x 768 x k8 corpus: the full-width
    windowed settle, U* and full receipt, then the same from the same start
    on the same context rebuilt under OSCILLINK_COL_CHUNKS = 2 (K4 fused,
    K3 unfused, at D/c = 384) and 8 (K2 and its epilogue at 96); U* held
    to the full-width run within WINDOWED_CHUNK_TOL of max|U|, each
    solve's launches equal to its operator applies, the receipt's K1
    launches its chunks.  The kernels against their plain versions at the
    chunk widths.  Then the straggler corpus card against CPU at c = 2
    (fused, unfused) and c = 8, held to the lattice bar."""
    n, d, k = CORPUS["n"], CORPUS["d"], CORPUS["k"]
    block = n * d * 4
    Y, psi = locality_corpus(n, d)
    out: dict = {"launches": {}}
    with env(OSCILLINK_WINDOWED_MATVEC="1", OSCILLINK_WINDOWED_FUSED="1"):
        lat = Oscillink(Y, kneighbors=k)
        lat.set_query(psi)
        check(lat._window_fullwidth and lat._auto_col_chunks() == 1,
              "the windowed corpus should solve full width on the card")
        full = solve_steps(lat, "K4")
        checks: list = []
        for route in ("settle", "ustar", "receipt"):
            model_check(checks, f"windowed_full_{route}", n, d, k,
                        "receipt" if route == "receipt" else "windowed",
                        full[route]["resident"], 1, full[route])
        Ustar_ref = lat._Ustar_cache_dev
        scale = float(Ustar_ref.abs().max())
        runs = {"full": {key: step_row(full[key], block) for key in ("settle", "ustar", "receipt")}}
        runs["full"]["receipt_values"] = receipt_values(full["rec"])
    for cc, fused, kernel in WINDOWED_CHUNKED:
        with env(OSCILLINK_WINDOWED_MATVEC="1", OSCILLINK_WINDOWED_FUSED=fused,
                 OSCILLINK_COL_CHUNKS=cc):
            lat._maybe_build_window_ctx()
            check(not lat._window_fullwidth and lat._window_ctx.oh is None,
                  f"c = {cc}: the forced context should solve chunked, with no one-hot")
            lat._U_dev = lat._Y_dev
            lat._invalidate_cache()
            steps = solve_steps(lat, kernel)
            for route in ("settle", "ustar", "receipt"):
                # the full-width U* is held beside the lattice's blocks
                model_check(checks, f"windowed_c{cc}_fused{fused}_{route}", n, d, k,
                            "receipt" if route == "receipt" else "windowed",
                            steps[route]["resident"] + 1, int(cc), steps[route])
            err = float((lat._Ustar_cache_dev - Ustar_ref).abs().max()) / scale
            check(err <= WINDOWED_CHUNK_TOL, f"windowed c={cc} fused={fused}: U* {err}")
            tag = f"c{cc}_fused{fused}"
            runs[tag] = {key: step_row(steps[key], block) for key in ("settle", "ustar", "receipt")}
            runs[tag].update(kernel=kernel, ustar_rel_err=err,
                             receipt_values=receipt_values(steps["rec"]))
            out["launches"][tag] = {kernel: steps["settle"]["launches"][kernel]
                                    + steps["ustar"]["launches"][kernel],
                                    "K1": steps["receipt"]["launches"]["K1"]}
            del steps
    del Ustar_ref
    with env(OSCILLINK_WINDOWED_MATVEC="1"):
        lat._maybe_build_window_ctx()  # OSCILLINK_COL_CHUNKS unset: full width again
    rows = window_chunk_kernels(lat, {"K4": d // 2, "K3": d // 2, "K2": d // 8})
    k1_row = k1_case({"case": "windowed_chunk_c2"}, lat.graph,
                     torch.randn(n, d // 2, device="cuda"))
    del lat
    torch.cuda.empty_cache()
    emit("windowed_chunked", **CORPUS, runs=runs, kernels_at_chunk_widths=rows,
         k1_chunk_width=k1_row, model_checks=checks)
    for row in checks:
        check(row["ok"], f"working-set model under the measured peak: {row}")
    out["rows"], out["k1_row"] = rows, k1_row
    # the straggler corpus, card against CPU on the card's graph
    Y, psi = clustered_corpus(STRAGGLERS["n"], STRAGGLERS["d"])
    for cc, fused, kernel in WINDOWED_CHUNKED:
        with env(OSCILLINK_WINDOWED_MATVEC="1", OSCILLINK_WINDOWED_FUSED=fused,
                 OSCILLINK_COL_CHUNKS=cc, **STRAGGLER_RETRY):
            run, lat = card_vs_cpu(f"windowed_stragglers_c{cc}_fused{fused}", Y, psi,
                                   STRAGGLERS["k"], kernel)
            check(not lat._window_fullwidth, f"stragglers c = {cc}: the context solved full width")
            out["launches"][f"stragglers_c{cc}_fused{fused}"] = {kernel: run["launches"]}
            del lat
    return out


# -- the service layer: the port's /v1 routes through K1 ----------------------

# the keys of a service response the bars hold, card against CPU (besides
# deltaH_total, the null-point lists' lengths and the bundles' ids)
DIGEST_KEYS = ("state_sig", "verdict", "backend", "cg_iters", "ustar_iters", "iters",
               "graph_cache", "cache", "queries", "corpora", "N", "D", "kneighbors_effective")


def service_digest(body, path: str = "") -> dict:
    """What the bars compare in a service response, keyed by its path in
    the JSON: state signatures, ΔH, null-point counts, bundle ids, chain
    verdicts, iteration counts, backends and cache statuses."""
    out = {}
    if isinstance(body, dict):
        for key, val in body.items():
            where = f"{path}.{key}"
            if key == "deltaH_total":
                out[where] = float(val)
            elif key == "null_points" and isinstance(val, list):
                out[where] = len(val)
            elif key == "bundle" and isinstance(val, list):
                out[where] = [e["id"] for e in val]
            elif key == "bundles" and isinstance(val, list):
                out[where] = [[e["id"] for e in b] for b in val]
            elif key in DIGEST_KEYS and not isinstance(val, (dict, list)):
                out[where] = val
            else:
                out.update(service_digest(val, where))
    elif isinstance(body, list):
        for i, val in enumerate(body):
            out.update(service_digest(val, f"{path}[{i}]"))
    return out


def signed_receipts(body) -> list:
    if isinstance(body, dict):
        found = [body] if "deltaH_total" in body and isinstance(body.get("meta"), dict) else []
        return found + [r for val in body.values() for r in signed_receipts(val)]
    if isinstance(body, list):
        return [r for val in body for r in signed_receipts(val)]
    return []


def hold_service(tag: str, card: dict, cpu: dict, sig_equal: bool = True,
                 backend: str = "device") -> dict:
    """The card's response against the CPU service's on the same request:
    every digest field identical (``state_sig`` only when ``sig_equal``),
    ΔH within LATTICE_TOL relative, ``meta.backend`` ``backend``; each signed
    receipt verifies, and two receipts whose signed payloads are
    byte-identical carry the same signature."""
    dc, dp = service_digest(card), service_digest(cpu)
    check(set(dc) == set(dp), f"{tag}: response fields {sorted(set(dc) ^ set(dp))}")
    rel = 0.0
    for where, want in dp.items():
        if where.endswith("deltaH_total"):
            gap = abs(dc[where] - want) / max(abs(want), 1e-30)
            rel = max(rel, gap)
            check(gap <= LATTICE_TOL, f"{tag}: {where} card {dc[where]} vs CPU {want}")
        elif where.endswith("state_sig"):
            check((dc[where] == want) == sig_equal, f"{tag}: {where} card {dc[where]} vs CPU {want}")
        else:
            check(dc[where] == want, f"{tag}: {where} card {dc[where]} vs CPU {want}")
    for where, val in dc.items():
        if where.endswith(".backend"):
            check(val == backend, f"{tag}: {where} is {val}")
    pairs = list(zip(signed_receipts(card), signed_receipts(cpu)))
    same_payload = 0
    for rc, rp in pairs:
        sc, sp = rc["meta"].get("signature"), rp["meta"].get("signature")
        check((sc is None) == (sp is None), f"{tag}: one receipt signed, the other not")
        if sc is None:
            continue
        check(verify_receipt(rc, SERVICE_SECRET) and verify_receipt(rp, SERVICE_SECRET),
              f"{tag}: a signed receipt does not verify")
        if canonical_json(sc["payload"]) == canonical_json(sp["payload"]):
            same_payload += 1
            check(sc["signature"] == sp["signature"], f"{tag}: same payload, other signature")
    return {"deltaH_rel": rel, "fields_held": len(dp),
            "signed_receipts": sum("signature" in r["meta"] for r, _ in pairs),
            "same_signed_payload": same_payload}


# The service's parse spans (`service/api.py`) by step: the JSON decode
# (`ApiRequest.json`), the pydantic validation (`_parse`) and the numpy
# conversion of the payload's arrays (`_np_array_or_400`).
PARSE_STEPS = {"json": "service.decode", "validate": "service.validate", "numpy": "service.arrays"}


@contextlib.contextmanager
def parse_clock():
    """Seconds the service spends parsing the block's requests, by step, read
    from the parse spans recorded in the block."""
    spent = dict.fromkeys(PARSE_STEPS, 0.0)
    step_of = {name: step for step, name in PARSE_STEPS.items()}
    t0 = time.perf_counter_ns()
    with recording() as rec:
        yield spent
        for s in rec.spans:
            if s.start_ns >= t0 and s.name in step_of:
                spent[step_of[s.name]] += 1e-9 * (s.end_ns - s.start_ns)


def service_call(client: LocalClient, path: str, data: bytes, headers=None) -> tuple:
    """One request through the service, launch counts set to 0 and the peak
    counter reset just before: its host ms split into parse, the rest of
    the handler (the lattice and the service's own work) and the JSON
    encode of the response the HTTP binding does; K1's launches and the
    device's peak allocation.  A job (202) is polled to completion, which
    the rest of the handler then includes."""
    cuda = client.state.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with parse_clock() as spent:
        t0 = time.perf_counter()
        resp = client.request("POST", path, data=data, headers=headers)
        if resp.status_code == 202:
            job_id = resp.json()["job_id"]
            while True:
                resp = client.request("GET", f"/v1/jobs/{job_id}", headers=headers)
                if resp.json()["status"] in ("done", "error"):
                    break
                time.sleep(0.002)
            check(resp.json()["status"] == "done", f"job failed: {resp.json()}")
        handle_s = time.perf_counter() - t0
    check(resp.status_code == 200, f"{path}: status {resp.status_code}: {str(resp.json())[:400]}")
    t0 = time.perf_counter()
    json.dumps(resp.json())
    encode_s = time.perf_counter() - t0
    parse_s = sum(spent.values())
    row = {"ms": 1e3 * (handle_s + encode_s), "parse_ms": 1e3 * parse_s,
           **{f"parse_{step}_ms": 1e3 * spent[step] for step in PARSE_STEPS},
           "lattice_ms": 1e3 * (handle_s - parse_s), "encode_ms": 1e3 * encode_s,
           "k1_launches": spmv.launches,
           "peak_bytes": torch.cuda.max_memory_allocated() if cuda else None}
    body = resp.json()
    return (body["result"] if "result" in body else body), row


def timed_endpoint(tag: str, card: LocalClient, cpu: LocalClient, path: str, data: bytes,
                   headers=None, cold: bool = True, sig_equal: bool = True) -> dict:
    """A cold call on the card (unless ``cold`` is False), then
    SERVICE_WARM_CALLS warm ones; their medians, the last held against the
    CPU service's answer to the same request."""
    cold_row = service_call(card, path, data, headers)[1] if cold else None
    warm = [service_call(card, path, data, headers) for _ in range(SERVICE_WARM_CALLS)]
    body_cpu, cpu_row = service_call(cpu, path, data, headers)
    rows = [row for _, row in warm]
    launches = [row["k1_launches"] for row in rows]
    check(all(x > 0 for x in launches), f"{tag}: K1 was not launched ({launches})")
    check(len(set(launches)) == 1, f"{tag}: K1 launches differ from call to call: {launches}")
    held = hold_service(tag, warm[-1][0], body_cpu, sig_equal=sig_equal)
    out = {"endpoint": path, **{key: statistics.median(r[key] for r in rows) for key in (
               "ms", "parse_ms", *(f"parse_{step}_ms" for step in PARSE_STEPS), "lattice_ms",
               "encode_ms")},
           "warm_ms": [r["ms"] for r in rows], "cold_ms": cold_row and cold_row["ms"],
           "k1_launches": launches[-1], "peak_bytes": max(r["peak_bytes"] or 0 for r in rows),
           "cpu_ms": cpu_row["ms"], "request_bytes": len(data), **held}
    emit("service_endpoint", name=tag, **out)
    return out


def service_clients() -> tuple:
    """The port's service on the card and on the CPU, fresh state each."""
    return LocalClient(create_state()), LocalClient(create_state(device="cpu"))


def quick_payload() -> dict:
    Y, psi = quick_inputs()
    return {"Y": Y.tolist(), "psi": psi.tolist(), "chain": QUICK["chain"],
            "params": {"kneighbors": QUICK["k"], "lamP": QUICK["lamP"]},
            "options": {"max_iters": 12, "tol": 1e-3, "bundle_k": 6}}


def service_quickstart() -> dict:
    """The verify skill's quickstart payload (120 x 128, k = 6, chain
    [2, 5, 7, 9]) through /v1/settle, /v1/receipt, /v1/bundle and
    /v1/chain/receipt of the port's service on the card, each response
    held against the service on the CPU; K1's launches counted from 0
    before each request."""
    data = json.dumps(quick_payload()).encode()
    out = {}
    with env(OSCILLINK_RECEIPT_SECRET=SERVICE_SECRET):
        tconfig.get_settings.cache_clear()
        card, cpu = service_clients()
        for path in ("/v1/settle", "/v1/receipt", "/v1/bundle", "/v1/chain/receipt"):
            body_card, row = service_call(card, path, data)
            body_cpu = service_call(cpu, path, data)[0]
            check(row["k1_launches"] > 0, f"quickstart {path}: K1 was not launched")
            out[path] = {"k1_launches": row["k1_launches"], "ms": row["ms"],
                         **hold_service(f"quickstart {path}", body_card, body_cpu)}
        settle = service_call(card, "/v1/settle", data)[0]
    tconfig.get_settings.cache_clear()
    check(out["/v1/settle"]["signed_receipts"] == 1, "quickstart: the settle receipt is not signed")
    emit("service_quickstart", **QUICK, routes=out)
    return {"launches": {path: row["k1_launches"] for path, row in out.items()},
            "state": card.state, "data": data, "settle": settle}


def diffusion_rounding(Y, psi, k: int, dopt: dict) -> dict:
    """The diffusion gates the service derives, on the card and on the CPU:
    their largest gap, and whether every gate rounds alike at the state
    signature's 1e-6 (the signature hashes the rounded gates)."""
    gates = []
    for dev in ("cuda", "cpu"):
        lat = Oscillink(Y, kneighbors=k, device=dev)
        lat.set_query(psi)
        gates.append(np.asarray(lat.diffusion_gates(**dopt)))
        del lat
    differ = int((np.round(gates[0], 6) != np.round(gates[1], 6)).sum())
    return {"max_abs_gap": float(np.abs(gates[0] - gates[1]).max()),
            "gates_rounding_apart": differ, "rounded_alike": differ == 0}


def service_warmup() -> dict:
    """`run_warmup` for the flagship shape: in two fresh processes sharing
    an empty kernel build directory (OSCILLINK_COMPILE_CACHE_DIR), the
    first of which builds K1 with nvcc and the second loads it, then in
    this process (kernels already loaded)."""
    shape = f"{FLAGSHIP['n']}x{FLAGSHIP['d']}x{FLAGSHIP['k']}"
    code = ("import json, time\n"
            "t0 = time.perf_counter()\n"
            "from oscillink_tpu_torch.service.warmup import run_warmup\n"
            "n = run_warmup(verbose=False)\n"
            "print(json.dumps({'warmed': n, 's': time.perf_counter() - t0}))\n")
    runs = []
    with tempfile.TemporaryDirectory() as cache:
        env_vars = {**os.environ, "OSCILLINK_COMPILE_CACHE_DIR": cache,
                    "OSCILLINK_WARM_SHAPES": shape}
        for _ in range(2):
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, "-c", code], env=env_vars, cwd=ROOT,
                                 capture_output=True, text=True, timeout=600)
            check(out.returncode == 0, f"warmup process failed: {out.stderr[-2000:]}")
            row = json.loads(out.stdout.strip().splitlines()[-1])
            row["process_s"] = time.perf_counter() - t0
            row["libraries"] = {p.name: p.stat().st_mtime_ns for p in Path(cache).glob("*.so")}
            runs.append(row)
    check(all(r["warmed"] == 1 for r in runs), f"warmup did not warm {shape}: {runs}")
    check(any(name.startswith("spmv-") for name in runs[0]["libraries"]),
          f"the first warmup built no K1 library into the cache: {runs[0]}")
    check(runs[1]["libraries"] == runs[0]["libraries"],
          "the second warmup rebuilt a library the cache already held")
    with env(OSCILLINK_WARM_SHAPES=shape):
        t0 = time.perf_counter()
        warmed = run_warmup(verbose=False)
        in_process_ms = sync_ms(t0)
    check(warmed == 1, "in-process warmup failed")
    row = {"shape": shape, "cold_cache_process": runs[0], "warm_cache_process": runs[1],
           "in_process_ms": in_process_ms}
    emit("service_warmup", **row)
    return row


def service_flagship() -> dict:
    """One request of each route at the service's full size, N = 5000
    (max_nodes) x D = 768 x kneighbors 8, psi the normalized mean of the
    first 20 rows; each JSON body serialized once.  Per endpoint: a cold
    call, SERVICE_WARM_CALLS warm ones (host-clock medians split into
    parse, lattice and encode; K1's launches from 0; peak device memory),
    and the CPU service's answer, held with the bars of `hold_service`.
    The bundle cache is off (its TTL 0) so that every call computes."""
    f = FLAGSHIP
    n, d, k = f["n"], f["d"], f["k"]
    rng = np.random.default_rng(11)
    Y = rng.standard_normal((n, d), dtype=np.float32)
    m = Y[:20].mean(0)
    psi = (m / (np.linalg.norm(m) + 1e-12)).astype(np.float32)
    base = {"Y": Y.tolist(), "psi": psi.tolist(), "params": {"kneighbors": k}}
    other_psi = queries(Y, 2)[1]
    dopt = {"beta": 1.0, "gamma": 0.1, "tol": 1e-4, "max_iters": 256}
    corpora = [data(c, d, seed=200 + i) for i, c in enumerate(f["ragged"])]
    bodies = {
        "settle": {**base, "options": {"bundle_k": 8, "include_receipt": True}},
        "bundle": {**base, "bundle_k": 8},
        "chain_receipt": {**base, "chain": f["chain"]},
        "settle_batch": {"Y": base["Y"], "psis": queries(Y, f["q"]).tolist(),
                         "params": base["params"], "bundle_k": 8},
        "bundle_ragged": {"corpora": [c.tolist() for c, _ in corpora],
                          "psis": [p.tolist() for _, p in corpora],
                          "params": base["params"], "bundle_k": 8},
        "settle_diffusion": {**base, "options": {"bundle_k": 8}, "diffusion": dopt},
        "graph_cache_hit": {**base, "psi": other_psi.tolist(), "options": {"bundle_k": 8}},
    }
    t0 = time.perf_counter()
    raw = {key: json.dumps(val).encode() for key, val in bodies.items()}
    serialize_ms = 1e3 * (time.perf_counter() - t0)
    del bodies, base
    rows = {}
    with env(OSCILLINK_RECEIPT_SECRET=SERVICE_SECRET, OSCILLINK_BUNDLE_CACHE_TTL="0"):
        tconfig.get_settings.cache_clear()
        card, cpu = service_clients()
        for key, path in (("settle", "/v1/settle"), ("bundle", "/v1/bundle"),
                          ("chain_receipt", "/v1/chain/receipt"),
                          ("settle_batch", "/v1/settle/batch"),
                          ("bundle_ragged", "/v1/bundle/ragged"),
                          ("jobs_settle", "/v1/jobs/settle")):
            rows[key] = timed_endpoint(key, card, cpu, path, raw.get(key, raw["settle"]))
        # the graph cache: a miss on this corpus, then the same Y with another
        # psi, which must be served from the cached graph
        with env(OSCILLINK_GRAPH_CACHE_SIZE="4"):
            card, cpu = service_clients()
            miss, miss_row = service_call(card, "/v1/settle", raw["settle"])
            check(miss["meta"]["graph_cache"] == "MISS", f"graph cache: {miss['meta']}")
            service_call(cpu, "/v1/settle", raw["settle"])
            rows["graph_cache_hit"] = timed_endpoint(
                "graph_cache_hit", card, cpu, "/v1/settle", raw["graph_cache_hit"], cold=False)
            rows["graph_cache_hit"]["miss_ms"] = miss_row["ms"]
            hit = service_call(card, "/v1/settle", raw["graph_cache_hit"])[0]
            check(hit["meta"]["graph_cache"] == "HIT", f"graph cache: {hit['meta']}")
        # a diffusion-gated settle under a key whose tier allows it (as
        # tests/test_service.py::test_diffusion_tier_gate sets it up); the
        # state signature hashes the derived gates rounded to 1e-6, so card
        # and CPU give the same one exactly when every gate rounds alike
        with env(OSCILLINK_API_KEYS="pk", OSCILLINK_KEY_TIERS="pk:pro"):
            card, cpu = service_clients()
            h = {"X-API-Key": "pk"}
            rounding = diffusion_rounding(Y, psi, k, dopt)
            rows["settle_diffusion"] = {**timed_endpoint(
                "settle_diffusion", card, cpu, "/v1/settle", raw["settle_diffusion"], h,
                sig_equal=rounding["rounded_alike"]), "gates": rounding}
    tconfig.get_settings.cache_clear()
    emit("service_flagship", **{key: val for key, val in f.items() if key != "ragged"},
         ragged=list(f["ragged"]), serialize_ms=serialize_ms,
         diffusion_gates=rows["settle_diffusion"]["gates"],
         request_bytes={key: len(val) for key, val in raw.items()},
         split_ms={key: {part: row[part] for part in (
             "ms", "parse_ms", *(f"parse_{step}_ms" for step in PARSE_STEPS), "lattice_ms",
             "encode_ms")} for key, row in rows.items()})
    return {"launches": {key: row["k1_launches"] for key, row in rows.items()}, "rows": rows}


def service_http(state, data: bytes, expect: dict) -> dict:
    """The quickstart /v1/settle through the port's aiohttp binding on
    127.0.0.1, served from a thread, against the in-process answer; or,
    without aiohttp, a line that says the binding did not run."""
    try:
        import aiohttp  # noqa: F401
    except ImportError:
        emit("service_http", http_binding="aiohttp absent")
        return {"http_binding": "aiohttp absent"}
    from oscillink_tpu_torch.service.http import create_app

    with env(OSCILLINK_RECEIPT_SECRET=SERVICE_SECRET):
        tconfig.get_settings.cache_clear()
        row = http_settle(create_app(state), data)
    tconfig.get_settings.cache_clear()
    got, want = service_digest(row.pop("body")), service_digest(expect)
    check(got == want, f"HTTP /v1/settle differs from the in-process answer: {got} vs {want}")
    row["fields_held"] = len(want)
    emit("service_http", **row)
    return row


def http_settle(app, data: bytes) -> dict:
    """POST ``data`` to /v1/settle of ``app`` served on 127.0.0.1 by an
    event loop in a thread, which is stopped before this returns."""
    from aiohttp import web

    loop = asyncio.new_event_loop()
    runner = web.AppRunner(app)
    loop.run_until_complete(runner.setup())
    site = web.TCPSite(runner, "127.0.0.1", 0)
    loop.run_until_complete(site.start())
    port = site._server.sockets[0].getsockname()[1]
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    try:
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/settle", data=data,
                                     headers={"Content-Type": "application/json"}, method="POST")
        reset_counts()
        t0 = time.perf_counter()
        with opener.open(req, timeout=300) as resp:
            status, body = resp.status, json.loads(resp.read())
        ms = 1e3 * (time.perf_counter() - t0)
        launches = spmv.launches
    finally:
        asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(60)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(60)
        check(not thread.is_alive(), "the HTTP binding's event loop did not stop")
        loop.close()
    check(status == 200, f"HTTP /v1/settle: status {status}")
    check(launches > 0, "HTTP /v1/settle: K1 was not launched")
    return {"http_binding": "aiohttp", "status": status, "ms": ms, "k1_launches": launches,
            "body": body}


# -- the CLI, the checkpoint, the native route, text ingestion and
# profiling ---------------------------------------------------------------


def cli_corpus(tmp: str) -> dict:
    """`oscillink_tpu_torch.cli` at the corpus tier: ``settle`` with a
    bundle and the debug report on a 131072 x 768 .npz, in this process,
    against the same flow through the library on the card (identical
    state_sig, iterations, null points and bundle ids, ΔH within
    LATTICE_TOL; K1's launches equal to the library flow's, whose settle
    and receipt part is r0 + one an iteration in settle and U* plus one
    for the full receipt).  Then ``python -m oscillink_tpu_torch.cli
    settle --diffusion --rerank`` at the quickstart size in a subprocess on
    the card and one with ``--device cpu``: both exit 0 and print the same
    JSON, the state signature equal exactly when the two devices' gates
    round alike at 1e-6 (ROADMAP.md queue C)."""
    n, d, k = CORPUS["n"], CORPUS["d"], CORPUS["k"]
    Y, psi = data(n, d)
    path = os.path.join(tmp, "corpus.npz")
    np.savez(path, Y=Y, psi=psi)
    html = os.path.join(tmp, "cli_report.html")
    torch.cuda.synchronize()
    reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = tcli.main(["settle", path, "--kneighbors", str(k), "--bundle-k", "10",
                        "--debug-report", html])
    command_ms = sync_ms(t0)
    cli_launches = spmv.launches
    check(rc == 0, f"cli settle exited {rc}")
    out = json.loads(buf.getvalue())
    html_bytes = os.path.getsize(html)
    # the same flow through the library: settle, full receipt, bundle, report
    reset_counts()
    t0 = time.perf_counter()
    lat = Oscillink(Y, kneighbors=k)
    lat.set_query(psi)
    lat.set_receipt_detail("full")
    st = lat.settle(max_iters=12, tol=1e-3)
    rec = lat.receipt()
    bundle = [e["id"] for e in lat.bundle(k=10, diversify=True)]
    flow_ms = sync_ms(t0)
    flow_launches = spmv.launches
    t0 = time.perf_counter()
    doc = generate_debug_report(lat, os.path.join(tmp, "library_report.html"))
    report_ms = sync_ms(t0)
    library_launches = spmv.launches
    del lat
    rel = abs(out["deltaH_total"] - rec["deltaH_total"]) / max(abs(rec["deltaH_total"]), 1e-30)
    applies = (st["iters"] + 1) + (rec["meta"]["ustar_iters"] + 1) + 1
    row = {**CORPUS, "command_ms": command_ms, "debug_report_ms": report_ms,
           "library_flow_ms": flow_ms, "html_bytes": html_bytes,
           "library_html_bytes": len(doc.encode()), "cli": out, "deltaH_rel": rel,
           "k1_launches_cli": cli_launches, "k1_launches_library": library_launches,
           "k1_launches_settle_receipt": flow_launches, "operator_applies": applies,
           "k1_launches_report": library_launches - flow_launches}
    emit("cli_corpus", **row)
    check(out["state_sig"] == rec["meta"]["state_sig"], "cli state_sig differs from the library's")
    check(out["settle"]["iters"] == st["iters"], "cli settle iterations differ")
    check(out["null_points"] == len(rec["null_points"]), "cli null points differ")
    check(out["bundle"] == bundle, f"cli bundle {out['bundle']} vs library {bundle}")
    check(rel <= LATTICE_TOL, f"cli deltaH differs from the library's by {rel}")
    check(flow_launches == applies, f"library flow: K1 launches {flow_launches} != {applies}")
    check(cli_launches == library_launches and cli_launches > applies,
          f"cli K1 launches {cli_launches} vs the library flow and report's {library_launches}")
    check(doc.startswith("<!DOCTYPE html>") and html_bytes > 0, "debug report not written")

    # the module entry point in fresh processes, card and CPU, quickstart size
    Yq, psiq = quick_inputs()
    qpath = os.path.join(tmp, "quick.npz")
    np.savez(qpath, Y=Yq, psi=psiq)
    argv = [sys.executable, "-m", "oscillink_tpu_torch.cli", "settle", qpath, "--diffusion",
            "--rerank", "--bundle-k", "6"]
    runs = {}
    for dev, extra in (("cuda", []), ("cpu", ["--device", "cpu"])):
        t0 = time.perf_counter()
        proc = subprocess.run(argv + extra, cwd=ROOT, capture_output=True, text=True, timeout=300)
        runs[dev] = {"rc": proc.returncode, "ms": 1e3 * (time.perf_counter() - t0),
                     "stderr_tail": proc.stderr[-400:]}
        check(proc.returncode == 0, f"python -m oscillink_tpu_torch.cli on {dev}: {proc.stderr}")
        runs[dev]["out"] = json.loads(proc.stdout)
    rounding = diffusion_rounding(Yq, psiq, 6, {"beta": 1.0, "gamma": 0.1})
    gpu, cpu = runs["cuda"]["out"], runs["cpu"]["out"]
    sub_rel = abs(gpu["deltaH_total"] - cpu["deltaH_total"]) / max(abs(cpu["deltaH_total"]), 1e-30)
    emit("cli_subprocess", **QUICK, runs=runs, rounding=rounding, deltaH_rel=sub_rel)
    check(gpu.keys() == cpu.keys(), "cli subprocess: JSON keys differ")
    check(gpu["settle"]["iters"] == cpu["settle"]["iters"], "cli subprocess: iterations differ")
    check(sub_rel <= LATTICE_TOL, f"cli subprocess: deltaH differs by {sub_rel}")
    for key in ("null_points", "bundle"):
        check(gpu[key] == cpu[key], f"cli subprocess: {key} card {gpu[key]} vs CPU {cpu[key]}")
    check((gpu["state_sig"] == cpu["state_sig"]) == rounding["rounded_alike"],
          f"cli subprocess: state_sig equality vs gates rounding alike: {rounding}")
    return {"launches": cli_launches, "command_ms": command_ms, "debug_report_ms": report_ms,
            "html_bytes": html_bytes}


@contextlib.contextmanager
def graph_builds():
    """Counts the lattice's graph builds (`Oscillink._build_graph_device`,
    which every build of the constructor goes through) in the block."""
    count = [0]
    saved = Oscillink._build_graph_device

    def counted(self, *args, **kwargs):
        count[0] += 1
        return saved(self, *args, **kwargs)

    Oscillink._build_graph_device = counted
    try:
        yield count
    finally:
        Oscillink._build_graph_device = saved


def checkpoint_dir(need: int) -> str:
    """A directory with room for a checkpoint of ``need`` bytes: the
    temporary directory, else the checkout's ignored ``build/``."""
    for where in (tempfile.gettempdir(), os.path.join(ROOT, "build")):
        os.makedirs(where, exist_ok=True)
        if shutil.disk_usage(where).free > 2 * need:
            return tempfile.mkdtemp(prefix="oscillink_ckpt_", dir=where)
    raise RuntimeError(f"no directory with {2 * need} bytes free for the checkpoint")


def checkpoint_save(lat: Oscillink) -> dict:
    """`save_checkpoint` of the million lattice, and what its restore is
    held to: host copies of Y, psi and the gates, the state signature and
    the adjacency fingerprint."""
    where = checkpoint_dir(lat.Y.nbytes)
    path = os.path.join(where, "million.pt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat.save_checkpoint(path)
    save_ms = 1e3 * (time.perf_counter() - t0)
    return {"dir": where, "path": path, "save_ms": save_ms, "file_bytes": os.path.getsize(path),
            "Y": lat.Y, "psi": lat.psi.copy(), "B": lat.B_diag.copy(),
            "state_sig": lat._signature(), "fingerprint": lat.adjacency_fingerprint()}


def checkpoint_restore(saved: dict, g, full: dict, ref: dict) -> dict:
    """`from_checkpoint` of the million lattice on the card, after the
    original is freed: no graph build; Y, psi, the gates and the four graph
    tensors bit-equal to the original's (``g``), the same state signature
    and fingerprint; then settle, U* and the full receipt (`solve_steps`,
    launches = applies) with the original's iterations (``full``) and its
    receipt (``ref``) to LATTICE_TOL on ΔH and equal null points.  The
    file is deleted afterwards."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        t0 = time.perf_counter()
        with graph_builds() as builds:
            back = Oscillink.from_checkpoint(saved["path"])
        load_ms = sync_ms(t0)
        load_peak = torch.cuda.max_memory_allocated()
        load_launches = spmv.launches
        equal = {
            "Y": bool(np.array_equal(back.Y, saved["Y"])),
            "psi": back.psi.tobytes() == saved["psi"].tobytes(),
            "B_diag": back.B_diag.tobytes() == saved["B"].tobytes(),
            **{name: bool(torch.equal(a, b)) for name, a, b in zip(
                ("idx", "w", "wn", "sqrt_deg"), back.graph, g)},
        }
        sig, fp = back._signature(), back.adjacency_fingerprint()
        steps = solve_steps(back)
        got = receipt_values(steps["rec"])
        rows = {key: step_row(steps[key], saved["Y"].nbytes) for key in ("settle", "ustar",
                                                                          "receipt")}
        rel = abs(got["deltaH"] - ref["deltaH"]) / max(abs(ref["deltaH"]), 1e-30)
        launches = sum(steps[key]["launches"]["K1"] for key in ("settle", "ustar", "receipt"))
        del back, steps
    finally:
        shutil.rmtree(saved["dir"], ignore_errors=True)
    row = {"save_ms": saved["save_ms"], "load_ms": load_ms, "file_bytes": saved["file_bytes"],
           "graph_builds": builds[0], "load_peak_bytes": load_peak,
           "load_k1_launches": load_launches, "bit_equal": equal,
           "state_sig_equal": sig == saved["state_sig"],
           "fingerprint_equal": fp == saved["fingerprint"], "receipt_values": got,
           "deltaH_rel": rel, "k1_launches": launches, **rows,
           "peak_bytes": max(r["peak_gb"] for r in rows.values()) * 1e9,
           "file_deleted": not os.path.exists(saved["path"])}
    emit("checkpoint_million", **MILLION, **row)
    check(builds[0] == 0, f"from_checkpoint built {builds[0]} graphs")
    check(all(equal.values()), f"restored state not bit-equal: {equal}")
    check(sig == saved["state_sig"] and fp == saved["fingerprint"],
          "restored state_sig or fingerprint differs")
    for key in ("settle", "ustar"):
        check(rows[key]["iters"] == full[key]["iters"],
              f"restored {key}: {rows[key]['iters']} iterations vs {full[key]['iters']}")
    check(rel <= LATTICE_TOL, f"restored deltaH differs by {rel}")
    check(got["null_points"] == ref["null_points"], "restored null points differ")
    return row


def native_request(client: LocalClient, path: str, data: bytes) -> tuple:
    """`service_call` with the bundle cache emptied first, so every call
    runs its settle."""
    client.state.bundle_cache = tapi.BundleCache()
    return service_call(client, path, data)


def untimed(body):
    if isinstance(body, dict):
        return {k: untimed(v) for k, v in body.items() if k not in NATIVE_TIMING_KEYS}
    if isinstance(body, list):
        return [untimed(v) for v in body]
    return body


def native_vs_device(tag: str, route: str, nat: dict, dev: dict) -> dict:
    """The native route's response against the device route's, with the
    JAX package's bars (tests/test_native_service_path.py): the same
    state_sig, ΔH within max(NATIVE_DH_ABS, NATIVE_DH_REL |ΔH|), the same
    bundle ids, the same chain verdict and z_struct within
    max(NATIVE_Z_ABS, NATIVE_Z_REL |z|)."""
    out = {}
    if "state_sig" in dev:
        check(nat["state_sig"] == dev["state_sig"], f"{tag}: state_sig differs")
    if route == "settle":
        dn, dd = nat["receipt"]["deltaH_total"], dev["receipt"]["deltaH_total"]
        out["deltaH_gap"] = abs(dn - dd)
        check(abs(dn - dd) <= max(NATIVE_DH_ABS, NATIVE_DH_REL * abs(dd)),
              f"{tag}: deltaH native {dn} vs device {dd}")
        check(nat["receipt"]["meta"]["backend"] == "native", f"{tag}: receipt backend")
    if "bundle" in dev:
        check([e["id"] for e in nat["bundle"]] == [e["id"] for e in dev["bundle"]],
              f"{tag}: bundle ids differ")
    if "bundles" in dev:
        for qn, qd in zip(nat["bundles"], dev["bundles"]):
            check([e["id"] for e in qn] == [e["id"] for e in qd], f"{tag}: batch bundle ids")
    if "chain_receipt" in dev:
        cn, cd = nat["chain_receipt"], dev["chain_receipt"]
        check(cn["verdict"] == cd["verdict"], f"{tag}: chain verdict differs")
        gaps = [abs(en["z_struct"] - ed["z_struct"]) for en, ed in zip(cn["edges"], cd["edges"])]
        out["z_struct_gap"] = max(gaps)
        for en, ed in zip(cn["edges"], cd["edges"]):
            check(abs(en["z_struct"] - ed["z_struct"]) <= max(NATIVE_Z_ABS,
                                                               NATIVE_Z_REL * abs(ed["z_struct"])),
                  f"{tag}: z_struct native {en['z_struct']} vs device {ed['z_struct']}")
    return out


def native_route() -> dict:
    """The service's native route at the image's threshold
    (``OSCILLINK_NATIVE_SMALL_N=2048``) with a 2048 x 768 x k8 request on
    every route it serves: /v1/settle (receipt and bundle), /v1/bundle
    (MMR and rerank), /v1/chain/receipt and /v1/settle/batch (Q = 8).  Each
    is served natively by the card's service (threshold 2048), by the
    same service's device route (threshold 0) and natively by the service
    on the CPU: the native answers of the two services must be equal apart
    from timing fields, and native against device must meet the JAX
    package's bars (`native_vs_device`).  A cold and SERVICE_WARM_CALLS
    warm calls on each route for each of the card's routes, host ms split
    as `service_call` splits them; the native route launches no kernel.
    One more /v1/bundle call with the cache kept shows a hit skipping the
    settle."""
    n, d, k, q = NATIVE["n"], NATIVE["d"], NATIVE["k"], NATIVE["q"]
    Y, psi = data(n, d, seed=7)
    base = {"Y": Y.tolist(), "psi": psi.tolist(), "params": {"kneighbors": k}}
    opts = {"max_iters": 12, "tol": 1e-3}
    requests = {
        "settle": ("/v1/settle", {**base, "options": {**opts, "include_receipt": True,
                                                      "bundle_k": NATIVE["bundle_k"]}}),
        "bundle_mmr": ("/v1/bundle", {**base, "options": opts, "bundle_k": NATIVE["bundle_k"]}),
        "bundle_rerank": ("/v1/bundle", {**base, "options": opts, "bundle_k": NATIVE["bundle_k"],
                                         "diversify": False}),
        "chain_receipt": ("/v1/chain/receipt", {**base, "options": opts,
                                                "chain": NATIVE["chain"]}),
        "batch": ("/v1/settle/batch", {"Y": base["Y"], "psis": queries(Y, q).tolist(),
                                       "params": base["params"], "bundle_k": NATIVE["bundle_k"]}),
    }
    tconfig.get_settings.cache_clear()
    with env(OSCILLINK_NATIVE_SMALL_N=NATIVE["threshold"]):
        t0 = time.perf_counter()
        card = LocalClient(create_state())  # builds the engine: g++ at first use
        startup_ms = 1e3 * (time.perf_counter() - t0)
        cpu = LocalClient(create_state(device="cpu"))
    out, launches = {}, {}
    for route, (path, payload) in requests.items():
        data_bytes = json.dumps(payload).encode()
        rows = {}
        for mode, threshold in (("native", NATIVE["threshold"]), ("device", "0")):
            with env(OSCILLINK_NATIVE_SMALL_N=threshold):
                cold = native_request(card, path, data_bytes)[1]
                warm = [native_request(card, path, data_bytes)
                        for _ in range(SERVICE_WARM_CALLS)]
            rows[mode] = {"body": warm[-1][0], "cold_ms": cold["ms"],
                          "warm_ms": [r["ms"] for _, r in warm],
                          **{key: statistics.median(r[key] for _, r in warm)
                             for key in ("ms", "parse_ms", "lattice_ms", "encode_ms")},
                          "k1_launches": [r["k1_launches"] for _, r in warm]}
        with env(OSCILLINK_NATIVE_SMALL_N=NATIVE["threshold"]):
            body_cpu, cpu_row = native_request(cpu, path, data_bytes)
        nat, dev = rows["native"].pop("body"), rows["device"].pop("body")
        backend_nat = nat["meta"].get("backend")
        backend_dev = dev["meta"].get("backend", "device")
        held = native_vs_device(f"native_route {route}", route, nat, dev)
        same_as_cpu = untimed(nat) == untimed(body_cpu)
        out[route] = {"endpoint": path, "request_bytes": len(data_bytes), **held,
                      "native": rows["native"], "device": rows["device"],
                      "native_cpu_service_ms": cpu_row["ms"],
                      "device_over_native_ms": rows["device"]["ms"] / rows["native"]["ms"],
                      "device_over_native_lattice_ms": rows["device"]["lattice_ms"]
                      / rows["native"]["lattice_ms"],
                      "native_equals_cpu_service": same_as_cpu}
        emit("native_route_endpoint", name=route, **out[route])
        check(backend_nat == "native" and backend_dev == "device",
              f"native_route {route}: backends {backend_nat} / {backend_dev}")
        check(same_as_cpu, f"native_route {route}: card and CPU services' native answers differ")
        check(all(x == 0 for x in rows["native"]["k1_launches"]),
              f"native_route {route}: the native route launched K1")
        check(all(x > 0 for x in rows["device"]["k1_launches"]),
              f"native_route {route}: the device route did not launch K1")
        launches[route] = rows["device"]["k1_launches"][-1]
    # a bundle-cache hit on the native route: the state signature alone
    with env(OSCILLINK_NATIVE_SMALL_N=NATIVE["threshold"]):
        path, payload = requests["bundle_mmr"]
        data_bytes = json.dumps(payload).encode()
        native_request(card, path, data_bytes)
        hit, hit_row = service_call(card, path, data_bytes)
    check(hit["meta"]["cache"] == "HIT", "native_route: the repeated bundle missed the cache")
    tconfig.get_settings.cache_clear()
    emit("native_route", **NATIVE, engine_startup_ms=startup_ms, bundle_hit_ms=hit_row["ms"],
         bundle_hit_lattice_ms=hit_row["lattice_ms"],
         native_ms={r: out[r]["native"]["ms"] for r in out},
         device_ms={r: out[r]["device"]["ms"] for r in out},
         native_lattice_ms={r: out[r]["native"]["lattice_ms"] for r in out},
         device_lattice_ms={r: out[r]["device"]["lattice_ms"] for r in out})
    return {"launches": launches}


def synth3k(n_docs: int) -> tuple:
    """The repo's synth3k BEIR-format corpus (its first ``n_docs`` texts)
    and its first query."""
    with open(os.path.join(ROOT, SYNTH3K, "corpus.jsonl")) as f:
        docs = [json.loads(line)["text"] for _, line in zip(range(n_docs), f)]
    with open(os.path.join(ROOT, SYNTH3K, "queries.jsonl")) as f:
        query = json.loads(f.readline())["text"]
    return docs, query


def text_flow(lat: Oscillink) -> dict:
    st = lat.settle(max_iters=12, tol=1e-3)
    rec = lat.receipt()
    return {"deltaH": rec["deltaH_total"], "nulls": len(rec["null_points"]),
            "state_sig": rec["meta"]["state_sig"], "settle_iters": st["iters"],
            "ustar_iters": rec["meta"]["ustar_iters"],
            "bundle": [e["id"] for e in lat.bundle(k=8)]}


def texts_phase() -> dict:
    """Text ingestion on the synth3k corpus (3000 documents, the first
    query): ``Oscillink.from_texts`` through the hash embeddings (384) and
    the registry's LSA provider (64), each on the card against the CPU to
    the lattice bars.  Where the two devices' graph builds differ within
    f32 rounding (near-tied similarities), the CPU lattice takes the
    card's graph (``graph=``), as the windowed phases do."""
    docs, query = synth3k(TEXTS["docs"])
    out, launches = {}, {}
    with env(OSCILLINK_DISABLE_ST="1"):
        for provider in ("hash", "lsa"):
            fit_ms = None
            if provider == "hash":
                make = lambda **kw: Oscillink.from_texts(  # noqa: E731
                    docs, query=query, kneighbors=TEXTS["k"], embed_dim=TEXTS["hash_dim"], **kw)
            else:
                t0 = time.perf_counter()
                emb = resolve_provider(f"lsa:{TEXTS['lsa_dim']}")
                Y, psi = emb.embed(docs), emb.embed([query])[0]
                fit_ms = 1e3 * (time.perf_counter() - t0)

                def make(**kw):
                    lat = Oscillink(Y, kneighbors=TEXTS["k"], **kw)
                    lat.set_query(psi)
                    return lat
            reset_counts()
            t0 = time.perf_counter()
            card = make()
            card_run = text_flow(card)
            card_ms = sync_ms(t0)
            k1 = spmv.launches
            cpu = make(device="cpu")
            slots = int((card.graph.idx.cpu() != cpu.graph.idx).sum())
            if slots or not torch.equal(card.graph.w.cpu(), cpu.graph.w):
                cpu = make(device="cpu", graph=card.graph)
            cpu_run = text_flow(cpu)
            rel = abs(card_run["deltaH"] - cpu_run["deltaH"]) / max(abs(cpu_run["deltaH"]), 1e-30)
            # card_ms: the lattice (with the hash embeddings for from_texts)
            # and its flow; lsa_fit_ms: the LSA fit and the query's embedding
            out[provider] = {"N": card.N, "D": card.D, "lsa_fit_ms": fit_ms,
                             "card_ms": card_ms, "k1_launches": k1,
                             "graph_slots_differ": slots, "deltaH_rel": rel, "card": card_run}
            emit("texts", provider=provider, **out[provider])
            check(k1 > 0, f"texts {provider}: K1 was not launched")
            check(rel <= LATTICE_TOL, f"texts {provider}: deltaH differs by {rel}")
            for key in ("nulls", "state_sig", "settle_iters", "ustar_iters", "bundle"):
                check(card_run[key] == cpu_run[key],
                      f"texts {provider}: {key} card {card_run[key]} vs CPU {cpu_run[key]}")
            launches[provider] = k1
            del card, cpu
    return {"launches": launches}


# -- the mesh tiers (parallel/, service/sharded_path.py) -----------------------


def card_mesh(shards: int = MESH_SHARDS):
    """``shards`` mesh shards, all on cuda:0: the halo exchange, the
    per-shard kernel launches and the psum order run for real on one card
    (a code path, not a multi-card speed)."""
    return tmesh.lattice_mesh(devices=[CARD] * shards)


def hold_mesh_u(tag: str, U, ref: torch.Tensor, tol: float) -> float:
    """U (per-shard blocks or a host array, in ref's row order) against a
    single-device U*: |U − ref| <= tol + tol·|ref| elementwise (the JAX
    tests' ``assert_allclose(rtol=atol=tol)``); returns max|U − ref| /
    max|ref|."""
    got = torch.cat([u.to(ref.device) for u in U]) if isinstance(U, list) else \
        torch.from_numpy(np.ascontiguousarray(U)).to(ref.device)
    gap = (got - ref).abs()
    ok = bool((gap <= tol + tol * ref.abs()).all())
    rel = float(gap.max()) / max(float(ref.abs().max()), 1e-30)
    check(bool(torch.isfinite(got).all()), f"{tag}: U not finite")
    check(ok, f"{tag}: U differs from the single-device U* beyond {tol}: max rel {rel}")
    return rel


def mesh_step(fn) -> dict:
    """``fn`` on the card with the launch counts set to 0 and the peak
    reset just before: its result, host ms to a sync, launches and peak."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    ms = sync_ms(t0)
    return {"out": out, "ms": ms, "launches": read_counts(),
            "peak_bytes": torch.cuda.max_memory_allocated()}


def k1_src_case(tag: str, idx, wn, X, S, one_source=None) -> dict:
    """K1's ``src`` form against its plain version on a shard's operands:
    rtol/atol TOL, bit-equal from launch to launch; with ``one_source``
    (the full graph's idx, wn and X, whose first rows are this shard and S
    is that X) also bit-equal to the one-source form's rows.  Then CUDA-event times of the kernel, the plain
    version and one library call (``torch.sparse.mm`` of [I | −Wn] when X
    is S's rows lo.., else ``torch.addmm`` of −Wn), and the bytes bound
    over the rows this run's ids reference."""
    out, again = (spmv.lap_matvec_cuda(idx, wn, X, src=S) for _ in range(2))
    ref = spmv.lap_matvec_ref(idx, wn, X, src=S)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    check(bool(torch.isfinite(out).all()), f"k1_src {tag}: not finite")
    check(torch.allclose(out, ref, rtol=TOL, atol=TOL), f"k1_src {tag}: != plain ({err})")
    check(torch.equal(out, again), f"k1_src {tag}: differs from launch to launch")
    row = {"case": tag, "n": idx.shape[0], "k": idx.shape[1], "d": X.shape[1],
           "src_rows": S.shape[0], "max_abs_err": err,
           "slab_cols": spmv.slab_plan(idx.shape[0], X.shape[1], idx.shape[1],
                                       spmv.device_l2_bytes(0), src_rows=S.shape[0])}
    if one_source is not None:
        g_idx, g_wn, g_X = one_source
        full = spmv.lap_matvec_cuda(g_idx, g_wn, g_X)
        check(torch.equal(out, full[:idx.shape[0]]), f"k1_src {tag}: shard rows != one-source rows")
        row["bit_equal_one_source"] = True
        del full
    del out, again, ref
    n, k, d = idx.shape[0], idx.shape[1], X.shape[1]
    reps = 20
    row["ms"] = cuda_ms(lambda: spmv.lap_matvec_cuda(idx, wn, X, src=S), reps)
    row["plain_ms"] = cuda_ms(lambda: spmv.lap_matvec_ref(idx, wn, X, src=S), 2)
    dev = idx.device
    rows_ref = int(torch.unique(idx[wn != 0]).numel()) if bool((wn != 0).any()) else 0
    unique_bytes = (2 * n * d + 2 * n * k + rows_ref * d) * 4
    flops = 2 * n * k * d
    row.update(referenced_src_rows=rows_ref,
               bound_ms=1e3 * max(unique_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS),
               bound_by="bytes" if unique_bytes / HBM_BYTES_PER_S >= flops / F32_FLOPS
               else "operations")
    crow = torch.arange(0, n * k + 1, k, device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        A = torch.sparse_csr_tensor(crow, idx.reshape(-1).long(), (-wn).reshape(-1),
                                    size=(n, S.shape[0]), check_invariants=False)
        try:
            lib = torch.addmm(X, A, S)
            lib_err = float((lib - spmv.lap_matvec_cuda(idx, wn, X, src=S)).abs().max())
            check(lib_err < 1e-4, f"k1_src {tag}: library yardstick disagrees: {lib_err}")
            row["library_ms"] = cuda_ms(lambda: torch.addmm(X, A, S), reps)
            row["library"] = "torch.addmm(X, CSR(-Wn), S)"
            del lib
        except (RuntimeError, NotImplementedError) as e:
            row["library_ms"], row["library"] = None, f"torch.addmm refused: {str(e)[:120]}"
    emit("k1_src", **row)
    return row


def permuted_graph(g, order: np.ndarray):
    """The graph of the rows taken in ``order``: rows permuted, ids mapped."""
    dev = g.idx.device
    o = torch.from_numpy(order.astype(np.int64)).to(dev)
    inv = torch.empty_like(o)
    inv[o] = torch.arange(o.numel(), device=dev)
    return tgraph.Graph(idx=inv[g.idx[o].long()].to(torch.int32).contiguous(),
                        w=g.w[o].contiguous(), wn=g.wn[o].contiguous(), sqrt_deg=g.sqrt_deg[o])


def mesh_references(lat: Oscillink) -> dict:
    """What `sharded_million` holds the mesh tiers to, from the million
    lattice: its U* from Y without a chain (and its iterations), then, with
    the chain added, the device route's settle, receipt and bundle."""
    lat._U_dev = lat._Y_dev
    lat._invalidate_cache()
    U_ref = lat._solve_ustar_device(use_cache=False)
    ref_it = lat.last_ustar["iters"]
    lat.add_chain(list(FLAGSHIP["chain"]), lamP=0.2)
    lat.settle(dt=1.0, max_iters=12, tol=1e-3)
    rec = lat.receipt()
    ids = [b["id"] for b in lat.bundle(k=8)]
    serve_ref = {key: rec[key] for key in ("coh_drop_sum", "anchor_pen_sum", "query_term_sum")}
    serve_ref.update(deltaH=rec["deltaH_total"], bundle=ids, settle_iters=rec["cg_iters"],
                     ustar_iters=rec["meta"]["ustar_iters"],
                     nulls={tuple(e["edge"]) for e in rec["null_points"]})
    return {"g": lat.graph, "Y_dev": lat._Y_dev, "Y_host": lat.Y, "psi": lat.psi.copy(),
            "U_ref": U_ref, "ref_it": ref_it, "serve_ref": serve_ref}


def sharded_million(g, Y_dev: torch.Tensor, Y_host: np.ndarray, psi: np.ndarray,
                    U_ref: torch.Tensor, ref_it: int, serve_ref: dict) -> dict:
    """The mesh tiers at 1M x 768 x k8 on the `million` IVF graph, 4
    shards on cuda:0, each held to the same run's single-device results:
    `shardmap_solve` (U* at the all-gather bar), the reorder, halo plan and
    `halo_solve` (the halo bar, in the original order), and
    `sharded_serve(graph=)` with a bundle and a chain (ΔH and the sums at
    the JAX service's sharded-vs-device bar, nulls and bundle ids equal).
    K1's ``src`` form is held to its plain version and timed here, at a
    250000-row shard against the 1M source and at the halo frame."""
    n, d, k = MILLION["n"], MILLION["d"], MILLION["k"]
    mesh = card_mesh()
    rows = n // MESH_SHARDS
    dev = Y_dev.device
    lam = tcoh.EnergyParams.make(1.0, 0.5, 4.0, 0.0, device=dev)
    B = torch.ones(n, device=dev)
    out: dict = {}
    # the all-gather tier
    st = mesh_step(lambda: tsmcg.shardmap_solve(mesh, g, Y_dev, psi, B, lam, tol=1e-4,
                                                max_iters=64))
    U, it, res = st.pop("out")
    rel = hold_mesh_u("sharded_million all-gather", U, U_ref, MESH_GATHER_TOL)
    out["all_gather"] = {"iters": it, "res": res, "rel_err": rel, **st}
    check(abs(it - ref_it) <= 1, f"all-gather iterations {it} vs single-device {ref_it}")
    check(st["launches"]["K1"] == MESH_SHARDS * (it + 1),
          f"all-gather K1 launches {st['launches']['K1']} != {MESH_SHARDS} x ({it} + 1)")
    # K1's src form at the shard's shape: a 250000-row shard against the 1M source
    idx0, wn0 = g.idx[:rows].contiguous(), g.wn[:rows].contiguous()
    X = torch.cat(U)
    k1_rows = [k1_src_case("allgather_shard", idx0, wn0, X[:rows].contiguous(), X,
                           one_source=(g.idx, g.wn, X))]
    del U, X
    torch.cuda.empty_cache()
    # the halo tier: PCA-bisection order, the graph permuted, its halo
    t0 = time.perf_counter()
    order = tpar.pca_bisection_order(Y_host, levels=4, device=dev)
    reorder_ms = sync_ms(t0)
    t0 = time.perf_counter()
    gp = permuted_graph(g, order)
    idx_h, w_h = gp.idx.cpu().numpy(), gp.w.cpu().numpy()
    stats = tpar.halo_stats(idx_h, w_h, MESH_SHARDS)
    plan = thalo.build_halo_plan(idx_h, w_h, MESH_SHARDS)
    plan_ms = sync_ms(t0)
    del idx_h, w_h
    o = torch.from_numpy(order.astype(np.int64)).to(dev)
    Yp = Y_dev[o]
    st = mesh_step(lambda: thalo.halo_solve(mesh, gp, plan, Yp, psi, B, lam, tol=1e-4,
                                            max_iters=64))
    U, it, res = st.pop("out")
    back = torch.empty((n, d), device=dev)
    back[o] = torch.cat(U)
    rel = hold_mesh_u("sharded_million halo", [back], U_ref, MESH_HALO_TOL)
    out["halo"] = {"iters": it, "res": res, "rel_err": rel, "halo_stats": stats,
                   "r_max": plan.r_max, "reorder_ms": reorder_ms, "plan_ms": plan_ms, **st}
    check(abs(it - ref_it) <= 1, f"halo iterations {it} vs single-device {ref_it}")
    check(st["launches"]["K1"] == 2 * MESH_SHARDS * (it + 1),
          f"halo K1 launches {st['launches']['K1']} != 2 x {MESH_SHARDS} x ({it} + 1)")
    # K1's src form at the halo frame: shard 0's halo slots against its frame
    ops = thalo._HaloOperands(mesh, gp, plan)
    frame = ops.halo([u.contiguous() for u in U])[0]
    k1_rows.append(k1_src_case("halo_frame", ops.idx_halo[0], ops.w_halo[0],
                               U[0].contiguous(), frame))
    del U, back, Yp, gp, ops, frame, o
    torch.cuda.empty_cache()
    # sharded serve on the given graph, with a bundle and a chain
    chain = list(FLAGSHIP["chain"])
    st = mesh_step(lambda: tserve.sharded_serve(
        mesh, Y_host, psi, k=k, bundle_k=8, chain=chain, lamP=0.2, graph=g))
    sv = st.pop("out")
    held = {}
    for key in ("deltaH", "coh_drop_sum", "anchor_pen_sum", "query_term_sum"):
        want = serve_ref[key]
        held[key] = abs(sv[key] - want) / max(abs(want), 1e-30)
        check(held[key] <= SERVICE_DEVICE_REL, f"sharded serve {key}: {sv[key]} vs {want}")
    nulls = {tuple(e["edge"]) for e in sv["null_points"]}
    check(nulls == serve_ref["nulls"], f"sharded serve nulls: {len(nulls)} vs "
          f"{len(serve_ref['nulls'])}")
    ids = [e["id"] for e in sv["bundle"]]
    check(ids == serve_ref["bundle"], f"sharded serve bundle {ids} vs {serve_ref['bundle']}")
    applies = (sv["settle_iters"] + 1) + (sv["ustar_iters"] + 1) + 1
    check(st["launches"]["K1"] == MESH_SHARDS * applies,
          f"sharded serve K1 launches {st['launches']['K1']} != {MESH_SHARDS} x {applies}")
    out["serve"] = {"settle_iters": sv["settle_iters"], "ustar_iters": sv["ustar_iters"],
                    "rel_to_device": held, "null_points": len(nulls), "bundle_ids": ids,
                    "device_settle_iters": serve_ref["settle_iters"],
                    "device_ustar_iters": serve_ref["ustar_iters"], **st}
    del sv
    torch.cuda.empty_cache()
    emit("sharded_million", **MILLION, shards=MESH_SHARDS, device_ustar_iters=ref_it, **out)
    return {"launches": {key: val["launches"]["K1"] for key, val in out.items()},
            "k1_src": k1_rows}


def halo_windowed() -> dict:
    """The windowed halo tier (``OSCILLINK_WINDOWED_MATVEC=1``) on 4 shards:
    the locality corpus at 131072 x 768 x k8 through `halo_solve_windowed`
    (K3 on each shard's local frame, K1 on its halo), against `halo_solve`
    and the single-device solve; then 16384 x 97 through K2 and its
    straggler epilogue.  K3/K2 launches = shards x applies."""
    rows = {}
    mesh = card_mesh()
    for tag, shape, kernel in (("corpus", HALO_WINDOWED, "K3"), ("narrow", HALO_NARROW, "K2")):
        n, d, k = shape["n"], shape["d"], shape["k"]
        Y, psi = locality_corpus(n, d, clusters=min(2048, n // 8))
        t0 = time.perf_counter()
        order = tpar.pca_bisection_order(Y, levels=4, device=CARD)
        (Y,) = tpar.apply_order(order, Y)[:1]
        reorder_ms = sync_ms(t0)
        t0 = time.perf_counter()
        g = tshbuild.build_graph_sharded(mesh, Y, k)
        build_ms = sync_ms(t0)
        t0 = time.perf_counter()
        idx_h, w_h = g.idx.cpu().numpy(), g.w.cpu().numpy()
        plan = thalo.build_halo_plan(idx_h, w_h, MESH_SHARDS)
        wplan, woh, cov, s_max = thalo.build_shard_window_plans(plan, g.wn.cpu().numpy(),
                                                                MESH_SHARDS, mesh=mesh)
        plan_ms = sync_ms(t0)
        live = ((g.wn.cpu().numpy() * plan.w_local_mask) != 0).reshape(MESH_SHARDS, -1).sum(1)
        covs = [1.0 - int((p.strag_w != 0).sum()) / max(int(c), 1) for p, c in zip(wplan, live)]
        check(CARD.type == "cpu" or all(o is None for o in woh),
              "the card's shard window plans hold a one-hot")
        lam = tcoh.EnergyParams.make(1.0, 0.5, 4.0, 0.0, device=CARD)
        B = np.ones(n, np.float32)

        def windowed():
            with env(OSCILLINK_WINDOWED_MATVEC="1"):
                return thalo.halo_solve_windowed(mesh, g, plan, wplan, woh, Y, psi, B, lam,
                                                 tol=1e-4, max_iters=64, s_max=s_max)

        def gather():
            return thalo.halo_solve(mesh, g, plan, Y, psi, B, lam, tol=1e-4, max_iters=64)

        # one untimed solve each first (the window kernels' first use), then
        # timed in turns
        windowed(), gather()
        win, gat = mesh_step(windowed), mesh_step(gather)
        U_w, it_w, _ = win.pop("out")
        U_g, it_g, _ = gat.pop("out")
        Yd = torch.from_numpy(Y).to(CARD)
        U1, it1, _ = tcoh.solve_stationary(g, None, Yd, torch.from_numpy(psi).to(CARD),
                                           torch.ones(n, device=CARD), lam, tol=1e-4,
                                           max_iters=64)
        rel_g = hold_mesh_u(f"halo_windowed {tag} gather", U_g, U1, MESH_HALO_TOL)
        Uw, Ug = torch.cat(U_w), torch.cat(U_g)
        rel_wg = float((Uw - Ug).abs().max()) / float(Ug.abs().max())
        check(rel_wg <= WINDOWED_HALO_TOL and abs(it_w - it_g) <= 1,
              f"halo_windowed {tag}: windowed vs gather {rel_wg}, iterations {it_w} vs {it_g}")
        check(win["launches"][kernel] == MESH_SHARDS * (it_w + 1),
              f"halo_windowed {tag}: {kernel} launches {win['launches'][kernel]} != "
              f"{MESH_SHARDS} x ({it_w} + 1)")
        check(win["launches"]["K1"] == MESH_SHARDS * (it_w + 1),
              f"halo_windowed {tag}: K1 (halo) launches {win['launches']['K1']}")
        rows[tag] = {**shape, "kernel": kernel, "iters": it_w, "gather_iters": it_g,
                     "single_device_iters": it1, "windowed_vs_gather": rel_wg,
                     "gather_vs_single_device": rel_g, "min_coverage": cov,
                     "shard_coverage": covs, "s_max": s_max, "r_max": plan.r_max,
                     "reorder_ms": reorder_ms, "build_ms": build_ms, "plan_ms": plan_ms,
                     "windowed": win, "gather": gat}
        emit("halo_windowed", case=tag, shards=MESH_SHARDS, **rows[tag])
        del g, U_w, U_g, Uw, Ug, U1, Yd, wplan
        torch.cuda.empty_cache()
    return {"launches": {tag: {r["kernel"]: r["windowed"]["launches"][r["kernel"]],
                               "K1": r["windowed"]["launches"]["K1"]} for tag, r in rows.items()}}


def solve_auto_corpus() -> dict:
    """`solve_auto` end to end at 131072 x 768 x k8 on 4 shards: on the
    clustered corpus (the halo tier expected) and on the Gaussian corpus
    (the all-gather tier expected).  The tier must match the measured halo;
    U, in the original row order, is held to the single-device lattice's
    U* with the same similarity ("auto": fast at this N)."""
    mesh = card_mesh()
    n, d, k = AUTO_MESH["n"], AUTO_MESH["d"], AUTO_MESH["k"]
    rows = {}
    for tag, (Y, psi), expect in (("clustered", clustered_corpus(n, d), "halo-exchange"),
                                  ("gaussian", data(n, d), "all-gather")):
        st = mesh_step(lambda: tpar.solve_auto(mesh, Y, psi, k=k))
        U, info = st.pop("out")
        s = info["halo_stats"]
        want = "halo-exchange" if s["halo_mean"] < 0.5 * s["allgather_rows"] else "all-gather"
        check(info["tier"].startswith(want),
              f"solve_auto {tag}: tier {info['tier']}, halo says {want}")
        lat = Oscillink(Y, kneighbors=k, similarity="auto", device=CARD)
        lat.set_query(psi)
        U1 = lat._solve_ustar_device(tol=1e-4, max_iters=64)
        it1 = lat.last_ustar["iters"]
        tol = MESH_HALO_TOL if info["tier"].startswith("halo") else MESH_GATHER_TOL
        rel = hold_mesh_u(f"solve_auto {tag}", U, U1, tol)
        check(abs(info["iters"] - it1) <= 1, f"solve_auto {tag}: {info['iters']} vs {it1} iters")
        # K1 twice an apply on the gather halo tier (local, then halo slots),
        # once on the all-gather tier and beside K3 on the windowed halo tier
        per_apply = 2 if info["tier"] == "halo-exchange" else 1
        check(st["launches"]["K1"] == per_apply * MESH_SHARDS * (info["iters"] + 1),
              f"solve_auto {tag}: K1 launches {st['launches']['K1']}")
        rows[tag] = {**info, "expected_tier": expect, "met_expectation": info["tier"] == expect,
                     "single_device_iters": it1, "rel_err": rel, "similarity": lat._similarity,
                     **st}
        emit("solve_auto_corpus", case=tag, **AUTO_MESH, shards=MESH_SHARDS, **rows[tag])
        del lat, U1, U
        torch.cuda.empty_cache()
    return {"launches": {tag: r["launches"]["K1"] for tag, r in rows.items()}}


def service_sharded() -> dict:
    """`service_flagship`'s 5000 x 768 x k8 request at
    ``OSCILLINK_SHARDED_MIN_N=4096`` (`SHARDED_MIN_N`) on a 4-shard mesh on
    cuda:0: settle
    (with a bundle), bundle, chain receipt and a job, each held to the
    card's device route (the JAX service's sharded-vs-device bars) and to
    the CPU service on a 4-shard CPU mesh (ΔH 1e-5 relative; state_sig,
    nulls, bundle ids and verdicts equal); backend "sharded", 4 shards."""
    f = FLAGSHIP
    n, d, k = f["n"], f["d"], f["k"]
    rng = np.random.default_rng(11)
    Y = rng.standard_normal((n, d), dtype=np.float32)
    m = Y[:20].mean(0)
    psi = (m / (np.linalg.norm(m) + 1e-12)).astype(np.float32)
    base = {"Y": Y.tolist(), "psi": psi.tolist(), "params": {"kneighbors": k}}
    raw = {key: json.dumps(val).encode() for key, val in {
        "settle": {**base, "options": {"bundle_k": 8, "include_receipt": True}},
        "bundle": {**base, "bundle_k": 8},
        "chain_receipt": {**base, "chain": f["chain"]},
    }.items()}
    rows = {}
    with env(OSCILLINK_RECEIPT_SECRET=SERVICE_SECRET, OSCILLINK_BUNDLE_CACHE_TTL="0"):
        tconfig.get_settings.cache_clear()
        device_route = LocalClient(create_state(device=CARD))
        with env(OSCILLINK_SHARDED_MIN_N=SHARDED_MIN_N):
            card = LocalClient(create_state(device=CARD, mesh=[CARD] * MESH_SHARDS))
            cpu = LocalClient(create_state(device="cpu", mesh=[torch.device("cpu")] * MESH_SHARDS))
            for key, path in (("settle", "/v1/settle"), ("bundle", "/v1/bundle"),
                              ("chain_receipt", "/v1/chain/receipt"),
                              ("jobs_settle", "/v1/jobs/settle")):
                data_ = raw.get(key, raw["settle"])
                body, row = service_call(card, path, data_)
                body_cpu, cpu_row = service_call(cpu, path, data_)
                with env(OSCILLINK_SHARDED_MIN_N="0"):
                    body_dev, dev_row = service_call(device_route, path, data_)
                held = hold_service(key, body, body_cpu, backend="sharded")
                meta = body.get("meta", {})
                backend = body.get("backend", meta.get("backend"))
                check(backend == "sharded", f"service_sharded {key}: backend {backend}")
                shards = ((body.get("receipt") or {}).get("meta", {}).get("mesh_devices")
                          or body.get("chain_receipt", {}).get("mesh_devices"))
                check(shards in (None, MESH_SHARDS), f"service_sharded {key}: {shards} shards")
                check(row["k1_launches"] > 0 and row["k1_launches"] % MESH_SHARDS == 0,
                      f"service_sharded {key}: K1 launches {row['k1_launches']}")
                rows[key] = {"endpoint": path, "backend": backend, "mesh_devices": shards,
                             "ms": row["ms"], "lattice_ms": row["lattice_ms"],
                             "k1_launches": row["k1_launches"], "peak_bytes": row["peak_bytes"],
                             "cpu_ms": cpu_row["ms"], "device_route_ms": dev_row["ms"],
                             "device_route_k1": dev_row["k1_launches"],
                             "vs_device": hold_vs_device(key, body, body_dev), **held}
                emit("service_sharded", name=key, shards=MESH_SHARDS, **rows[key])
    tconfig.get_settings.cache_clear()
    return {"launches": {key: row["k1_launches"] for key, row in rows.items()}}


def hold_vs_device(tag: str, sharded: dict, device: dict) -> dict:
    """The sharded route against the device route on one request: the JAX
    service's bars (tests/test_service_sharded.py): state_sig equal, ΔH and
    the sums within 2e-3 relative, null edges, bundle ids and chain
    verdicts equal."""
    out = {}
    check(sharded["state_sig"] == device["state_sig"], f"{tag}: state_sig sharded vs device")
    rs, rd = sharded.get("receipt"), device.get("receipt")
    if rs is not None and rd is not None:
        for key in ("deltaH_total", "coh_drop_sum", "anchor_pen_sum", "query_term_sum"):
            out[key] = abs(rs[key] - rd[key]) / max(abs(rd[key]), 1e-30)
            check(out[key] <= SERVICE_DEVICE_REL, f"{tag}: {key} sharded {rs[key]} vs {rd[key]}")
        check({tuple(e["edge"]) for e in rs["null_points"]}
              == {tuple(e["edge"]) for e in rd["null_points"]}, f"{tag}: null edges")
    if sharded.get("bundle") is not None:
        check([e["id"] for e in sharded["bundle"]] == [e["id"] for e in device["bundle"]],
              f"{tag}: bundle ids sharded vs device")
    if "chain_receipt" in sharded:
        cs, cd = sharded["chain_receipt"], device["chain_receipt"]
        check(cs["verdict"] == cd["verdict"] and cs["weakest_link"]["edge"]
              == cd["weakest_link"]["edge"], f"{tag}: chain verdict sharded vs device")
        out["coherence_gain"] = abs(cs["coherence_gain"] - cd["coherence_gain"]) / max(
            abs(cd["coherence_gain"]), 1e-30)
    return out


def hierarchical_card_vs_cpu(Y: np.ndarray, psi: np.ndarray, card: dict, cpu: dict, shards: int,
                             k: int) -> list:
    """Each shard of ``hierarchical_settle``'s card receipt (``card``, with
    the defaults' lambdas, tol and iteration cap) against the CPU, two
    ways.  On the card's graph, the shard solved on the CPU: ΔH within
    HIER_REL and equal iterations, every shard.  Against the CPU's own run
    (``cpu``): where cuBLAS and the CPU's BLAS round near-tied similarities
    apart (the graphs differ only within `near_tie_witness`'s rounding
    bound), ΔH within HIER_TIE_REL and iterations within one; every other
    shard within HIER_REL and equal iterations."""
    ns = Y.shape[0] // shards
    lam = tcoh.EnergyParams.make(1.0, 0.5, 4.0, 0.0, device="cpu")
    psi_c = torch.from_numpy(psi)
    witness = []
    for s_, (a, b) in enumerate(zip(card["shard_receipts"], cpu["shard_receipts"])):
        Ys = torch.from_numpy(np.ascontiguousarray(Y[s_ * ns:(s_ + 1) * ns]))
        g = build_graph(Ys.to(CARD), k)
        ties = near_tie_witness(Ys.numpy(), g.idx.cpu().numpy(), build_graph(Ys, k).idx.numpy())
        U, it, _ = tcoh.solve_stationary(tgraph.Graph(*(t.cpu() for t in g)), None, Ys, psi_c,
                                         torch.ones(ns), lam, tol=1e-4, max_iters=64)
        diff = U - Ys
        dH = float(torch.sum(diff * (lam.lamG * diff)))
        ties["deltaH_rel_card_graph"] = abs(a["deltaH"] - dH) / abs(dH)
        ties["deltaH_rel"] = abs(a["deltaH"] - b["deltaH"]) / abs(b["deltaH"])
        witness.append(ties)
        check(it == a["iters"] and ties["deltaH_rel_card_graph"] <= HIER_REL,
              f"hierarchical shard {s_} on the card's graph: CPU {it} iterations, {dH} vs {a}")
        check(ties["max_gap"] <= ties["gap_bound"], f"hierarchical shard {s_} graphs: {ties}")
        if ties["slots_differ"]:
            check(abs(a["iters"] - b["iters"]) <= 1 and ties["deltaH_rel"] <= HIER_TIE_REL,
                  f"hierarchical card vs CPU: {a} vs {b}")
        else:
            check(a["iters"] == b["iters"] and ties["deltaH_rel"] <= HIER_REL,
                  f"hierarchical card vs CPU: {a} vs {b}")
    return witness


def hierarchical_streaming() -> dict:
    """`hierarchical_settle` at 131072 x 768 x k8 with 8 shards on the card;
    a `StreamingLattice` fed the same rows in 8 flushes with max_shards 5
    (one consolidation), whose per-flush shard receipts must be the
    hierarchical ones, and one with max_shards 8, whose flushed stream
    must compose the hierarchical receipts; then card against CPU at
    16384 x 768 (`hierarchical_card_vs_cpu`)."""
    n, d, k, shards = HIER["n"], HIER["d"], HIER["k"], HIER["shards"]
    Y, psi = clustered_corpus(n, d)
    st = mesh_step(lambda: tpar.hierarchical_settle(Y, psi, n_shards=shards, kneighbors=k,
                                                    device=CARD))
    hier = st.pop("out")
    applies = sum(r["iters"] + 1 for r in hier["shard_receipts"]) + hier["super"]["iters"] + 1
    check(st["launches"]["K1"] == applies, f"hierarchical K1 {st['launches']['K1']} != {applies}")
    ns = n // shards
    streams = {}
    for max_shards in (5, 8):
        t0 = time.perf_counter()
        reset_counts()
        sl = tpar.StreamingLattice(psi, shard_size=ns, max_shards=max_shards, kneighbors=k,
                                   device=CARD)
        recs = sl.append(Y)
        ms = sync_ms(t0)
        for s, r in enumerate(recs):
            want = hier["shard_receipts"][s]
            got = r["new_shard"]
            check(got["iters"] == want["iters"] and abs(got["deltaH"] - want["deltaH"])
                  <= HIER_REL * abs(want["deltaH"]), f"stream flush {s}: {got} vs {want}")
        last = recs[-1]
        if max_shards == 8:
            check(last["super"]["ranking"] == hier["super"]["ranking"],
                  "flushed stream ranking != hierarchical")
            check(abs(last["deltaH_composed"] - hier["deltaH_composed"])
                  <= HIER_REL * abs(hier["deltaH_composed"]), "flushed stream deltaH_composed")
        else:
            check(sl.generation == 1 and sl.total_rows == n, f"stream: generation {sl.generation}")
        streams[max_shards] = {"ms": ms, "generation": sl.generation, "n_shards": sl.n_shards,
                               "deltaH_composed": last["deltaH_composed"],
                               "k1_launches": spmv.launches}
        del sl, recs
    nc = HIER_CPU["n"]
    Yc, psic = clustered_corpus(nc, d, seed=1)
    card = tpar.hierarchical_settle(Yc, psic, n_shards=shards, kneighbors=k, device=CARD)
    cpu = tpar.hierarchical_settle(Yc, psic, n_shards=shards, kneighbors=k, device="cpu")
    witness = hierarchical_card_vs_cpu(Yc, psic, card, cpu, shards, k)
    check(card["super"]["ranking"] == cpu["super"]["ranking"], "hierarchical ranking card vs CPU")
    rounded_alike = all(round(a["deltaH"], 6) == round(b["deltaH"], 6) for a, b in zip(
        card["shard_receipts"], cpu["shard_receipts"])) and round(card["super"]["deltaH"], 6) \
        == round(cpu["super"]["deltaH"], 6) and [round(x, 6) for x in card["super"]["align"]] \
        == [round(x, 6) for x in cpu["super"]["align"]]
    check((card["composition_sig"] == cpu["composition_sig"]) == rounded_alike,
          "composition_sig card vs CPU against the rounding rule")
    emit("hierarchical_streaming", **HIER, hierarchical={**st, "super_iters": hier["super"]["iters"],
         "shard_iters": [r["iters"] for r in hier["shard_receipts"]],
         "deltaH_composed": hier["deltaH_composed"]}, streams=streams,
         card_vs_cpu={"n": nc, "sig_equal": card["composition_sig"] == cpu["composition_sig"],
                      "rounded_alike": rounded_alike, "shards": witness})
    return {"launches": {"hierarchical": st["launches"]["K1"],
                         **{f"stream_max{m}": s["k1_launches"] for m, s in streams.items()}}}


def profiling_phase() -> dict:
    """`utils.profiling` on the card: `trace` around a corpus settle writes
    a Chrome trace that holds K1's kernel; `device_memory_stats` returns its
    three keys, the peak at least the phase's `max_memory_allocated`."""
    Y, psi = data(CORPUS["n"], CORPUS["d"])
    lat = Oscillink(Y, kneighbors=CORPUS["k"])
    lat.set_query(psi)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with profiler_trace(tmp):
            lat.settle(max_iters=12, tol=1e-3)
        traced_ms = sync_ms(t0)
        trace_path = os.path.join(tmp, "trace.json")
        trace_bytes = os.path.getsize(trace_path)
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
    k1_events = [e for e in events if K1_SYMBOL in str(e.get("name", ""))
                 and e.get("cat") == "kernel"]
    stats = device_memory_stats()
    peak = torch.cuda.max_memory_allocated()
    row = {"traced_settle_ms": traced_ms, "trace_bytes": trace_bytes, "events": len(events),
           "k1_kernel_events": len(k1_events), "k1_launches": spmv.launches,
           "k1_device_us": sum(float(e.get("dur", 0)) for e in k1_events),
           "memory_stats": stats, "max_memory_allocated": peak,
           "k1_kernel_name": k1_events[0]["name"] if k1_events else None}
    emit("profiling", **CORPUS, **row)
    check(len(k1_events) > 0 and spmv.launches > 0,
          f"trace holds {len(k1_events)} K1 kernels for {spmv.launches} launches")
    check(stats is not None and set(stats) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"},
          f"device_memory_stats: {stats}")
    check(stats["peak_bytes_in_use"] >= peak, f"peak {stats['peak_bytes_in_use']} < {peak}")
    return {"launches": spmv.launches}


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance between two float32 tensors in units in the
    last place (0 where both are the same NaN)."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def exact_parts(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[1, C] float64 column sums of a ⊙ b (the products exact in float64):
    a partials row for `cg_fused.alpha_ref` and `finish_ref`."""
    a2, b2 = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    return (a2.double() * b2.double()).sum(0, keepdim=True)


def cg_pass_checks(n: int, d: int, seed: int) -> tuple[dict, dict, dict]:
    """Each fused CG pass (`ops.kernels.cg_fused`) against its twin on the
    card on random [n, d] blocks: x, r, p and Ap bit-equal, and bit-equal
    from launch to launch (partials too); with and without the
    preconditioner, the operator's two forms and its dot form.  The column
    sums, after their finalize launches (α; rz', β and the residual at 1
    and more lanes), within `CG_ULPS` of the same finalize of float64 sums
    taken by torch (`exact_parts`); their distance from the twins' (float32
    ``torch.sum``, as the classic body) is read, not held.  Returns the
    ulps against the float64 sums, against the twins, and the inputs."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def blk(scale=1.0):
        return torch.randn((n, d), generator=gen, device="cuda") * scale

    def vec(lo, hi, size=d):
        return lo + (hi - lo) * torch.rand(size, generator=gen, device="cuda")

    lam = tcoh.EnergyParams.make(*CG_LAMS, device="cuda")
    B = vec(0.0, 1.0, n)
    inv_M = 1.0 / (lam.lamG + lam.lamQ * B + 1e-12)
    p, L, b, x, r = blk(), blk(), blk(), blk(), blk(0.1)
    rz, alpha, beta = vec(0.5, 1.5), vec(0.0, 1e-2), vec(0.0, 0.5)
    tag = f"[{n}, {d}]"
    u, tw_u = {}, {}

    def same(a, b, what):
        check(torch.equal(a, b), f"cg_fused {what} != twin at {tag}")

    def sums(key, got, exact, twin):
        u[key], tw_u[key] = ulps(got, exact), ulps(got, twin)

    for form, dt in (("operator", None), ("settle", 1.0)):
        Lk, Lt, La = L.clone(), L.clone(), L.clone()
        Ak, pk = cg_fused.combine(p, Lk, lam, B, dt)
        At, pt = cg_fused.combine_ref(p, Lt, lam, B, dt)
        Aa, pa = cg_fused.combine(p, La, lam, B, dt)
        check(Ak.data_ptr() == Lk.data_ptr(), "cg_fused combine did not write into L")
        same(Ak, At, f"combine ({form}) Ap")
        check(torch.equal(Ak, Aa) and torch.equal(pk, pa), f"combine ({form}) run to run at {tag}")
        sums(f"combine_{form}", cg_fused.alpha(pk, rz),
             cg_fused.alpha_ref(exact_parts(p, Ak), rz), cg_fused.alpha_ref(pt, rz))
    sums("dot", cg_fused.alpha(cg_fused.dot(p, L), rz), cg_fused.alpha_ref(exact_parts(p, L), rz),
         cg_fused.alpha_ref(cg_fused.dot_ref(p, L), rz))
    for pre in (inv_M, None):
        key = "pre" if pre is not None else "nopre"
        rk, qk, sk = cg_fused.residual(b, L, pre)
        rt, qt, st = cg_fused.residual_ref(b, L, pre)
        same(rk, rt, f"residual r ({key})")
        same(qk, qt, f"residual p ({key})")
        sums(f"residual_{key}", cg_fused.finish(sk)[0], cg_fused.finish_ref(exact_parts(rk, qk))[0],
             cg_fused.finish_ref(st)[0])
        xk, rk = x.clone(), r.clone()
        xo = torch.empty_like(x)
        zk, qk2 = cg_fused.update(xk, xo, rk, p, L, alpha, pre)
        xt, rt = x.clone(), r.clone()
        zt, qt2 = cg_fused.update_ref(xt, xt, rt, p, L, alpha, pre)
        same(xk, x, f"update x_in ({key}, written)")
        same(xo, xt, f"update x ({key})")
        same(rk, rt, f"update r ({key})")
        xk2, rk2 = x.clone(), r.clone()
        zk2, qk3 = cg_fused.update(xk2, xk2, rk2, p, L, alpha, pre)
        check(torch.equal(xk2, xo) and torch.equal(rk2, rk) and torch.equal(zk2, zk)
              and torch.equal(qk3, qk2), f"update ({key}) run to run or in place at {tag}")
        z = rk if pre is None else rk * pre[:, None]
        for q in [1] + [q for q in CG_LANES if d % q == 0 and q > 1]:
            gk = cg_fused.finish(zk, rz, qk2, q)
            ge = cg_fused.finish_ref(exact_parts(rk, z), rz, exact_parts(rk, rk), q)
            gt = cg_fused.finish_ref(zt, rz, qt2, q)
            for name, a, e, t in zip(("rz", "beta", "res"), gk, ge, gt):
                sums(f"finish_{name}_{key}_lanes{q}", a, e, t)
        pk, pt = p.clone(), p.clone()
        cg_fused.direction(pk, r, beta, pre)
        cg_fused.direction_ref(pt, r, beta, pre)
        same(pk, pt, f"direction p ({key})")
    check(max(u.values()) <= CG_ULPS, f"cg_fused column sums vs float64 at {tag}: {u}")
    return u, tw_u, dict(p=p, L=L, b=b, x=x, r=r, B=B, inv_M=inv_M, lam=lam, alpha=alpha,
                         beta=beta, rz=rz)


def cg_pass_timing(n: int, d: int, t: dict) -> dict:
    """Each pass's CUDA-event time against its byte bound (each [n, d] f32
    block read or written once over `HBM_BYTES_PER_S`) and its twin's."""
    blk = n * d * 4 / HBM_BYTES_PER_S * 1e3
    p2 = t["p"].clone()
    calls = {
        # name: (kernel, twin, blocks moved)
        "combine": (lambda: cg_fused.combine(t["p"], t["L"], t["lam"], t["B"], 1.0),
                    lambda: cg_fused.combine_ref(t["p"], t["L"], t["lam"], t["B"], 1.0), 3),
        "dot": (lambda: cg_fused.dot(t["p"], t["L"]), lambda: cg_fused.dot_ref(t["p"], t["L"]), 2),
        "residual": (lambda: cg_fused.residual(t["b"], t["L"], t["inv_M"]),
                     lambda: cg_fused.residual_ref(t["b"], t["L"], t["inv_M"]), 4),
        "update": (lambda: cg_fused.update(t["x"], t["x"], t["r"], t["p"], t["L"], t["alpha"],
                                           t["inv_M"]),
                   lambda: cg_fused.update_ref(t["x"], t["x"], t["r"], t["p"], t["L"], t["alpha"],
                                               t["inv_M"]), 6),
        "direction": (lambda: cg_fused.direction(p2, t["r"], t["beta"], t["inv_M"]),
                      lambda: cg_fused.direction_ref(p2, t["r"], t["beta"], t["inv_M"]), 3),
    }
    rows = {}
    for name, (kern, twin, blocks) in calls.items():
        ms = cuda_ms(kern, 20)
        rows[name] = {"ms": ms, "bound_ms": blocks * blk, "roofline_pct": 100 * blocks * blk / ms,
                      "plain_ms": cuda_ms(twin, 3), "library_ms": None}
    pz, pr = cg_fused.update(t["x"], t["x"], t["r"], t["p"], t["L"], t["alpha"], t["inv_M"])
    pap = cg_fused.dot(t["p"], t["L"])
    rows["alpha"] = {"ms": cuda_ms(lambda: cg_fused.alpha(pap, t["rz"]), 50),
                     "partial_rows": pap.shape[0]}
    rows["finish"] = {"ms": cuda_ms(lambda: cg_fused.finish(pz, t["rz"], pr), 50),
                      "launches": 2}
    return rows


def cg_iteration_ms(g, lam, B, X, inv_M) -> dict:
    """One U* CG iteration at the flow's shape, K1 included: the fused
    passes against the classic eager body (`cg_solve_lanes`' expressions on
    the same inputs), in turns."""
    n, d = X.shape
    op = tcoh._gather_operator(g, None, lam, B)
    r, p = X * 1e-3, X.clone()
    rz = torch.sum(r * (r * inv_M[:, None]), dim=0)
    inv_rows = inv_M.contiguous()
    x = X.clone()

    def fused():
        Ap, pap = op(p)
        al = cg_fused.alpha(pap, rz)
        prz, prr = cg_fused.update(x, x, r, p, Ap, al, inv_rows)
        rz_n, be, _ = cg_fused.finish(prz, rz, prr, 1)
        cg_fused.direction(p, r, be, inv_rows)

    def classic():
        Ap = tcoh.stationary_matvec(g, None, lam, B, p)
        al = rz / (torch.sum(p * Ap, dim=0, keepdim=True) + 1e-18)
        x_n = x + p * al
        r_n = r - Ap * al
        torch.amax(torch.linalg.vector_norm(r_n, dim=0, keepdim=True), dim=-1)
        z = r_n * inv_M[:, None]
        rz_n = torch.sum(r_n * z, dim=0, keepdim=True)
        be = rz_n / (rz + 1e-18)
        return x_n, z + p * be

    return turns_ms({"fused": fused, "classic": classic}, 10)


def cg_flow() -> dict:
    """The corpus flow through the fused CG at trec_covid's shape: U* and a
    settle step each twice (bit-equal, every iteration fused, the kernels'
    launches 3 + 6 an iteration), against the classic body on the same
    inputs (the one-lane lanes-first layout, which keeps it): the same
    iterations, U within `CG_FORM_TOL`; the lattice's own settle and U*
    with no classic iteration; then an iteration and the U* solve timed,
    fused against classic, in turns."""
    n, d, k = CG_FLOW["n"], CG_FLOW["d"], CG_FLOW["k"]
    Y, psi = data(n, d)
    lat = Oscillink(Y, kneighbors=k)
    lat.set_query(psi)
    g, Yd, psid, Bd, lam = lat._graph, lat._Y_dev, lat._psi_dev, lat._B_dev, lat._lam()
    solves = {
        "ustar": (lambda: tcoh.solve_stationary(g, None, Yd, psid, Bd, lam, tol=1e-4,
                                                max_iters=64),
                  None, tcoh.query_rhs(lam, Yd, psid, Bd), lam.lamG + lam.lamQ * Bd, 1e-4, 64),
        "settle": (lambda: tcoh.settle_step(g, None, Yd, Yd, psid, Bd, lam, dt=1.0, tol=1e-3,
                                            max_iters=12),
                   1.0, Yd + 1.0 * tcoh.query_rhs(lam, Yd, psid, Bd),
                   tcoh._settle_diag(None, lam, Bd, 1.0), 1e-3, 12),
    }
    out = {}
    for name, (fn, dt, rhs, diag, tol, iters) in solves.items():
        cg_fused.launches = tsolver.fused_iterations = tsolver.classic_iterations = 0
        U1, it1, res1 = fn()
        torch.cuda.synchronize()
        launches = cg_fused.launches
        U2, it2, res2 = fn()
        fused_its, classic_its = tsolver.fused_iterations, tsolver.classic_iterations

        def classic_op(X, dt=dt):
            M = tcoh.stationary_matvec(g, None, lam, Bd, X.view(n, d))
            return (M if dt is None else X.view(n, d) + dt * M).view(1, n, d)

        Uc, itc, resc = tsolver.cg_solve_lanes(classic_op, rhs[None], x0=Yd[None],
                                               M_diag=diag[None, :, None], tol=tol,
                                               max_iters=iters, row_dim=1)
        err = float((Uc[0] - U1).abs().max() / U1.abs().max())
        out[name] = {"iters": it1, "res": res1, "classic_iters": int(itc[0]),
                     "classic_res": float(resc[0]), "cg_launches": launches,
                     "fused_iterations": fused_its, "classic_iterations": classic_its,
                     "bit_equal_repeat": bool(torch.equal(U1, U2)), "vs_classic_rel": err}
        check(torch.equal(U1, U2) and it1 == it2 and res1 == res2,
              f"cg_flow {name}: two runs differ")
        check(launches == 3 + 6 * it1, f"cg_flow {name}: {launches} launches for {it1} iterations")
        check(fused_its == 2 * it1 and classic_its == 0,
              f"cg_flow {name}: fused {fused_its}, classic {classic_its} for 2 x {it1}")
        check(int(itc[0]) == it1, f"cg_flow {name}: iterations {it1}, classic body {int(itc[0])}")
        check(err <= CG_FORM_TOL, f"cg_flow {name}: fused vs classic U {err}")
        del U1, U2, Uc
    tsolver.fused_iterations = tsolver.classic_iterations = 0
    lat.settle(dt=1.0, max_iters=12, tol=1e-3)
    lat._solve_ustar_device(use_cache=False)
    torch.cuda.synchronize()
    out["lattice"] = {"fused_iterations": tsolver.fused_iterations,
                      "classic_iterations": tsolver.classic_iterations,
                      "settle_iters": lat.last["iters"], "ustar_iters": lat.last_ustar["iters"]}
    check(tsolver.classic_iterations == 0 and tsolver.fused_iterations
          == lat.last["iters"] + lat.last_ustar["iters"], f"cg_flow lattice: {out['lattice']}")
    inv_M = 1.0 / (lam.lamG + lam.lamQ * Bd + 1e-12)
    out["iteration_ms"] = cg_iteration_ms(g, lam, Bd, Yd, inv_M)
    ustar = solves["ustar"]

    def classic_ustar():
        return tsolver.cg_solve_lanes(
            lambda X: tcoh.stationary_matvec(g, None, lam, Bd, X.view(n, d)).view(1, n, d),
            ustar[2][None], x0=Yd[None], M_diag=ustar[3][None, :, None], tol=1e-4, max_iters=64,
            row_dim=1)

    runs = {"fused": [], "classic": []}
    for key in ("fused", "classic", "classic", "fused"):
        t0 = time.perf_counter()
        (ustar[0] if key == "fused" else classic_ustar)()
        runs[key].append(sync_ms(t0))
    out["ustar_ms"] = runs
    del lat
    return out


def cg_fused_phase() -> dict:
    """The fused CG passes held to their twins at `CG_SHAPES` (and timed
    against their byte bounds from `CG_TIMED_N` rows), then `cg_flow`."""
    t0 = time.perf_counter()
    rows = []
    for i, shape in enumerate(CG_SHAPES):
        u, tw_u, inputs = cg_pass_checks(shape["n"], shape["d"], seed=100 + i)
        row = {**shape, "max_ulps_vs_f64": max(u.values()), "ulps_vs_f64": u,
               "max_ulps_vs_twin": max(tw_u.values()), "ulps_vs_twin": tw_u, "bit_equal": True}
        if shape["n"] >= CG_TIMED_N:
            row["timing"] = cg_pass_timing(shape["n"], shape["d"], inputs)
        del inputs
        torch.cuda.empty_cache()
        rows.append(row)
        emit("cg_fused_vs_plain", **row)
    flow = cg_flow()
    torch.cuda.empty_cache()
    emit("cg_fused_flow", **CG_FLOW, **flow, phase_s=time.perf_counter() - t0)
    return {"rows": rows, "flow": flow}


def edge_case(n: int, d: int, k: int, seed: int) -> tuple:
    """idx [n, k] int32 of uniformly random neighbours, X [n, d] and a row
    scale in [0.5, 1.5), on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((n, d), generator=gen, device="cuda")
    idx = torch.randint(0, n, (n, k), generator=gen, device="cuda", dtype=torch.int32)
    return idx, X, 0.5 + torch.rand(n, generator=gen, device="cuda")


def edge_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest per-edge relative distance between two [N, K] results."""
    return float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())


def edge_checks(idx, X, scale, tag: str) -> dict:
    """The kernel against the plain version, scaled and not, at the plan's
    slab width and at 32 columns: within `ED_RTOL` of it, and bit-equal on a
    second launch.  At up to 5000 rows, both against float64 sums of the
    same rounded terms too (read, not held)."""
    out = {}
    for name, s in (("scaled", scale), ("unscaled", None)):
        ref = edge_dists.edge_sq_dists_ref(idx, X, s)
        f64 = None
        if X.shape[0] <= 5000:
            Xs = X if s is None else X * s[:, None]
            diff = Xs[:, None, :] - Xs[idx.long()]
            f64 = (diff * diff).double().sum(-1)
            del Xs, diff
        for slab in (None, min(32, X.shape[1])):
            got = edge_dists.edge_sq_dists_cuda(idx, X, s, slab_cols=slab)
            again = edge_dists.edge_sq_dists_cuda(idx, X, s, slab_cols=slab)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"edge_dists {tag} {name} slab {slab}: run to run")
            rel = edge_rel(got, ref)
            check(rel <= ED_RTOL, f"edge_dists {tag} {name} slab {slab}: {rel} vs plain")
            key = f"{name}_slab{slab or 'plan'}"
            out[key] = {"rel_vs_plain": rel}
            if f64 is not None:
                out[key].update(rel_vs_f64=edge_rel(got.double(), f64),
                                plain_rel_vs_f64=edge_rel(ref.double(), f64))
        del ref, f64
    return out


def edge_peak(fn) -> int:
    """Bytes ``fn`` allocated at its peak above what was allocated before."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del out
    return peak


def edge_timing(idx, X, scale) -> dict:
    """The kernel's CUDA-event time (scaled, as the receipts call it) against
    its byte bound (X once, idx, the scale and out: (N*D + 2*N*K + N)*4 B
    over `HBM_BYTES_PER_S`) and the bound with its slabs' partials written
    and read; the plain version's time; each call's peak above its inputs."""
    n, d = X.shape
    k = idx.shape[1]
    slab = spmv.slab_plan(n, d, k, spmv.device_l2_bytes(0))
    slabs = -(-d // slab)
    bound = (n * d + 2 * n * k + n) * 4 / HBM_BYTES_PER_S * 1e3
    partials = (2 * slabs * n * k * 4 if slabs > 1 else 0) / HBM_BYTES_PER_S * 1e3
    kern = lambda: edge_dists.edge_sq_dists_cuda(idx, X, scale)  # noqa: E731
    plain = lambda: edge_dists.edge_sq_dists_ref(idx, X, scale)  # noqa: E731
    ms = cuda_ms(kern, 20)
    peak = edge_peak(kern)
    # the working-set model's term; the caching allocator rounds each of
    # the two blocks up to 512 bytes and leaves a large block's remainder
    # of up to 1 MiB unsplit
    check(peak <= edge_dists.scratch_bytes(n, d, k) + ALLOC_SLACK_BYTES,
          f"edge_dists at [{n}, {d}] k{k}: peak {peak} B over its scratch "
          f"{edge_dists.scratch_bytes(n, d, k)} B")
    return {"ms": ms, "unscaled_ms": cuda_ms(lambda: edge_dists.edge_sq_dists_cuda(idx, X), 20),
            "bound_ms": bound, "bound_by": "bytes", "roofline_pct": 100 * bound / ms,
            "bound_with_partials_ms": bound + partials,
            "roofline_with_partials_pct": 100 * (bound + partials) / ms,
            "plain_ms": cuda_ms(plain, 3), "library_ms": None, "slab_cols": slab,
            "slabs": slabs, "peak_bytes": peak, "scratch_bytes": edge_dists.scratch_bytes(n, d, k),
            "plain_peak_bytes": edge_peak(plain)}


def edge_dists_phase() -> dict:
    """The edge-distance kernel held to its plain version at `ED_CHECKED`
    and `ED_TIMED`, a lane view of an [N, `ED_LANES`, D] block held to its
    contiguous copy at the first timed shape, one launch counted a call,
    and the timed shapes against their byte bounds."""
    t0 = time.perf_counter()
    rows = []
    for i, shape in enumerate(ED_CHECKED + ED_TIMED):
        idx, X, scale = edge_case(shape["n"], shape["d"], shape["k"], seed=200 + i)
        tag = f"[{shape['n']}, {shape['d']}] k{shape['k']}"
        row = {**shape, "checks": edge_checks(idx, X, scale, tag)}
        if shape in ED_TIMED:
            row["timing"] = edge_timing(idx, X, scale)
        if shape is ED_TIMED[0]:
            block = torch.stack([X] * ED_LANES, dim=1)
            block[:, 0] *= 0.5
            lane = block[:, ED_LANES // 2]
            got = edge_dists.edge_sq_dists_cuda(idx, lane, scale)
            check(torch.equal(got, edge_dists.edge_sq_dists_cuda(idx, lane.contiguous(), scale)),
                  f"edge_dists {tag}: a lane view != its contiguous copy")
            row["lane_view"] = {"lanes": ED_LANES, "row_stride": lane.stride(0),
                                "ms": cuda_ms(lambda: edge_dists.edge_sq_dists_cuda(
                                    idx, lane, scale), 20)}
            del block, lane, got
            before = edge_dists.launches
            edge_dists.edge_sq_dists_cuda(idx, X, scale)
            check(edge_dists.launches == before + 1, "edge_dists: one launch count a call")
        del idx, X, scale
        torch.cuda.empty_cache()
        rows.append(row)
        emit("edge_dists_vs_plain", **row)
    return {"rows": rows, "phase_s": time.perf_counter() - t0,
            "max_rel_vs_plain": max(c["rel_vs_plain"] for row in rows
                                    for c in row["checks"].values())}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0))

    # 1. build K1, K2-K4, K5 and the CG's fused passes from the checkout's
    # sources, one nvcc per source, all started together
    sources = ("spmv", "window_spmv3f", "bucket_gather", "cg_fused", "edge_dists")
    t0 = time.perf_counter()
    kbuild.build(list(sources))
    build_s = time.perf_counter() - t0
    libs = {}
    for name in sources:
        log = kbuild._target(name)[1].with_suffix(".log")
        libs[name] = {
            "library": log.with_suffix(".so").name,
            "ptxas": ptxas_report(log.read_text()) if log.exists() else {},
        }
        kbuild.load_library(name)
    emit("build", seconds=build_s, **libs)

    # 2. K1 against its plain version on graphs built by the port
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for name, shape in (("headline", HEADLINE), ("corpus", CORPUS), ("ragged", RAGGED),
                        ("k_one", K_ONE), ("k_wide", K_WIDE)):
        cases[name] = kernel_vs_plain(shape, gen)

    # 3. K2-K4 against their plain versions, every precision tier, on the
    # kernel-bench graph at the corpus shape, at a ragged N and D, in the
    # W = 512 / R = 256 / 2-window geometry and at 40 slots a row; on
    # non-finite input at each; then their times at the corpus shape
    # (default tier)
    win_errs: dict = {}
    for shape, seed in ((CORPUS, 0), (WIN_RAGGED, 1), (WIN_512, 2), (WIN_K40, 3)):
        case = window_case(shape, seed)
        info = case["info"]
        if shape is CORPUS:
            check(0 < info["blocks_with_stragglers"] < info["blocks"],
                  f"the bench graph should give blocks with and without stragglers: {info}")
        for tier in tw.PRECISION_TIERS:
            errs = window_vs_plain(case, tier)
            emit("window_vs_plain", **info, tier=tier, max_abs_err=errs,
                 tol={"K2-K4": WIN_TOL, "K4_pap": PAP_TOL, "K2-K4_gather": GATHER_TOL,
                      "K4_gather_pap": GATHER_PAP_TOL, "relative_to": "max|plain|"},
                 bit_equal_repeat=True)
            for key, err in errs.items():
                win_errs[key] = max(win_errs.get(key, 0.0), err)
        emit("window_nonfinite", **info, tier="bf16x3", **window_nonfinite(case))
        if shape is CORPUS:
            win_timing = window_timing(case)
        del case
    torch.cuda.empty_cache()

    # 3b. K5 against its plain version, then the bucket-shuffle probe at full
    # size; its ~13 GB are freed before the lattice phases
    k5_row = bucket_gather_phase()
    torch.cuda.empty_cache()

    # 4. quickstart: the card against the port's own CPU path
    gpu, cpu = quickstart("cuda"), quickstart("cpu")
    rel = abs(gpu["deltaH"] - cpu["deltaH"]) / max(abs(cpu["deltaH"]), 1e-30)
    emit("quickstart", cuda=gpu, cpu=cpu, deltaH_rel=rel)
    check(rel <= 1e-5, f"quickstart deltaH differs: {rel}")
    for key in ("nulls", "verdict", "bundle", "state_sig", "settle_iters", "ustar_iters"):
        check(gpu[key] == cpu[key], f"quickstart {key}: cuda {gpu[key]} vs cpu {cpu[key]}")
    for run in (gpu, cpu):
        check(run["deltaH_f64_tree_bits_equal_numpy_spec"], "f64-tree deltaH != NumPy spec bits")

    # 5. headline config: the card against the CPU, then warm medians
    Y, psi = data(HEADLINE["n"], HEADLINE["d"])
    emit("headline_parity", **HEADLINE, **headline_parity(Y, psi, HEADLINE["k"]))
    flow_pass(Y, psi, HEADLINE["k"])
    passes = [flow_pass(Y, psi, HEADLINE["k"])[0] for _ in range(5)]
    emit("headline", **HEADLINE, passes=len(passes), **medians(passes))

    # 5b. the service: its warmup in fresh processes on an empty kernel build
    # directory, the quickstart payload through four routes, every route at
    # the service's full size, and the HTTP binding; each response against
    # the CPU service, K1's launches counted from 0 before each request
    service_warmup()
    quick = service_quickstart()
    flagship = service_flagship()
    svc_sharded = service_sharded()
    http = service_http(quick["state"], quick["data"], quick["settle"])
    native = native_route()
    service_launches = {
        **{f"quickstart {path}": val for path, val in quick["launches"].items()},
        **{f"flagship {key}": val for key, val in flagship["launches"].items()},
        "http /v1/settle": http.get("k1_launches"),
        **{f"native_route device {route}": val for route, val in native["launches"].items()},
        **{f"sharded {route}": val for route, val in svc_sharded["launches"].items()},
    }
    del quick, flagship
    torch.cuda.empty_cache()

    # 6. corpus scale, gather path (K1): the launch counts of its last pass
    Y, psi = data(CORPUS["n"], CORPUS["d"])
    flow_pass(Y, psi, CORPUS["k"])
    passes = [flow_pass(Y, psi, CORPUS["k"])[0] for _ in range(2)]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t, lat, settle_launches = flow_pass(Y, psi, CORPUS["k"])
    ed_flow = {"light_flow": edge_dists.launches}
    t0 = time.perf_counter()
    lat.set_receipt_detail("full")
    rec = lat.receipt()
    t["receipt_full_ms"] = sync_ms(t0)
    ed_flow["receipt_full"] = edge_dists.launches - sum(ed_flow.values())
    t0 = time.perf_counter()
    bundle = lat.bundle(k=8)
    ed_flow["bundle"] = edge_dists.launches - sum(ed_flow.values())
    chain = lat.chain_receipt([2, 5, 7, 9])
    ed_flow["chain_receipt"] = edge_dists.launches - sum(ed_flow.values())
    t["bundle_chain_ms"] = sync_ms(t0)
    counts = read_counts()
    launches = counts["K1"]
    peak = torch.cuda.max_memory_allocated()
    passes.append(t)
    settle_it, ustar_it = lat.last["iters"], rec["meta"]["ustar_iters"]
    applies = (settle_it + 1) + (ustar_it + 1) + 2  # r0 + one per iteration; 2 receipts
    U = lat.U
    del lat
    emit("corpus", **CORPUS, passes=len(passes), **medians(passes), last_pass=t,
         settle_iters=settle_it, ustar_iters=ustar_it, spmv_launches=launches,
         operator_applies=applies, settle_launches=settle_launches, launches=counts,
         edge_dists_launches=ed_flow,
         host_syncs_per_settle=settle_it,
         max_memory_allocated_bytes=peak, deltaH=rec["deltaH_total"],
         null_points=len(rec["null_points"]), bundle_ids=[b["id"] for b in bundle],
         chain_verdict=chain["verdict"])
    check(launches > 0, "K1 was not launched on the main path")
    check(launches == applies, f"K1 launches {launches} != operator applies {applies}")
    check(settle_launches == settle_it + 1,
          f"K1 launches in settle {settle_launches} != r0 + {settle_it} iterations")
    check(U.shape == (CORPUS["n"], CORPUS["d"]) and bool(np.isfinite(U).all()), "U not finite")
    check(np.isfinite(rec["deltaH_total"]) and rec["deltaH_total"] >= 0, "deltaH invalid")
    check(len(bundle) == 8 and len({b["id"] for b in bundle}) == 8, "bundle ids invalid")
    check(ed_flow == ED_CORPUS_FLOW,
          f"edge_dists launches on the corpus flow {ed_flow} != {ED_CORPUS_FLOW}")

    # 6a. the CG's fused passes against their twins at the corpus cells'
    # shapes, timed against their bounds; the corpus flow through them
    cg = cg_fused_phase()
    torch.cuda.empty_cache()
    # 6a'. the edge distances against their plain version, timed at the
    # corpus cells' shapes against their byte bounds
    ed = edge_dists_phase()

    # 6b. the CLI at the corpus tier (and as a module in fresh processes),
    # torch.profiler around a corpus settle, text ingestion on synth3k
    with tempfile.TemporaryDirectory() as tmp:
        cli = cli_corpus(tmp)
    prof = profiling_phase()
    texts = texts_phase()
    torch.cuda.empty_cache()

    # 7. K1 timing at the main path's shapes, then its slab widths swept at
    # the corpus shape
    rows = [time_kernel(HEADLINE, cases["headline"]), time_kernel(CORPUS, cases["corpus"])]
    main_row = rows[1]
    sweep = k1_slab_sweep(CORPUS, cases["corpus"])
    sweep_mid = k1_sweep_mid()
    # 7b. K1 at the serving paths' narrow widths and on the ragged union graph
    narrow = k1_narrow(cases["corpus"]["g"], cases["ragged"]["g"])
    k1_err = max([c["err"] for c in cases.values()] + [r["max_abs_err"] for r in narrow])
    del cases
    torch.cuda.empty_cache()

    # 7c. the multi-query serving paths through K1, each with its launches
    # counted from 0: the batched lattice (card vs CPU), the /v1/bundle batch
    # path at the corpus tier, standalone diffusion gates, ragged bundles,
    # the one-shot light receipt
    parity_batch = batched_parity()
    serving = {"batched_parity": parity_batch["launches"]}
    corpus_batch = batched_corpus()
    serving.update({f"batched_corpus_{key}": val for key, val in corpus_batch["launches"].items()})
    diff = diffusion_standalone()
    serving.update({f"diffusion_{key}": val["launches"] for key, val in diff.items()})
    serving["ragged"] = ragged_phase()["launches"]
    serving["oneshot"] = oneshot_phase()["launches"]
    k1_err = max(k1_err, corpus_batch["k1_row"]["max_abs_err"])
    torch.cuda.empty_cache()

    # 7d. similarity="auto", all through K1 with its launches counted from 0
    # in each phase: the bf16 scan's routes; the corpus tier's default
    # request (fast) against the exact build; the blocked fast path, the IVF
    # build and the seeded host build each against the CPU; the cluster tier
    # (IVF at 524288) and its isotropic fallback; export and import
    auto_launches = {}
    scan_routes()
    auto_launches["auto_corpus"] = auto_corpus()["launches"]
    auto_launches["fast_parity"] = fast_parity()["launches"]
    cluster = cluster_corpus()
    auto_launches["cluster_corpus"] = cluster["launches"]
    auto_launches["ivf_parity"] = ivf_parity()["launches"]
    with tempfile.TemporaryDirectory() as tmp:
        auto_launches["seeded_and_state"] = seeded_and_state(tmp)["launches"]
    torch.cuda.empty_cache()

    # 7e. the 1M study shape: full width, column-chunked and the two CG
    # forms, K1's launches counted from 0 before each step
    big = million()
    torch.cuda.empty_cache()

    # 7f. the mesh tiers at 131072 rows, 4 shards on the card: the windowed
    # halo tier (K3; K2 at D = 97), solve_auto on both sides of its tier
    # decision, the hierarchical and streaming tiers (8 shards)
    halo_win = halo_windowed()
    auto_mesh = solve_auto_corpus()
    hier = hierarchical_streaming()
    torch.cuda.empty_cache()
    mesh_launches = {**{f"million_{key}": val for key, val in big["sharded"]["launches"].items()},
                     **{f"halo_windowed_{tag}": val["K1"]
                        for tag, val in halo_win["launches"].items()},
                     **{f"solve_auto_{tag}": val for tag, val in auto_mesh["launches"].items()},
                     **hier["launches"]}
    k1_src = big["sharded"]["k1_src"]

    # 8. windowed corpus: the full-width windowed main path through K4
    win_launches = {"K4": windowed_corpus()}

    # 9. windowed stragglers: a low-coverage clustered corpus through K4
    # (fused) and K3 (OSCILLINK_WINDOWED_FUSED=0), each held to the CPU
    Y, psi = clustered_corpus(STRAGGLERS["n"], STRAGGLERS["d"])
    with env(OSCILLINK_WINDOWED_MATVEC="1", OSCILLINK_WINDOWED_FUSED="1", **STRAGGLER_RETRY):
        card_vs_cpu("windowed_stragglers_fused", Y, psi, STRAGGLERS["k"], "K4")
    with env(OSCILLINK_WINDOWED_MATVEC="1", OSCILLINK_WINDOWED_FUSED="0", **STRAGGLER_RETRY):
        win_launches["K3"] = card_vs_cpu(
            "windowed_stragglers_unfused", Y, psi, STRAGGLERS["k"], "K3")[0]["launches"]

    # 10. narrow D: a D = 97 lattice routes to K2 and the straggler epilogue;
    # two applies on the card must be bit-equal (no atomics in the epilogue)
    Y, psi = clustered_corpus(NARROW["n"], NARROW["d"])
    with env(OSCILLINK_WINDOWED_MATVEC="1", **STRAGGLER_RETRY):
        run, lat = card_vs_cpu("windowed_narrow_d", Y, psi, NARROW["k"], "K2")
        win_launches["K2"] = run["launches"]
        ctx = lat._window_ctx
        Xp = tw.pad_rows(lat._U_dev.index_select(0, ctx.order.long()), ctx.plan.n_pad)
        first = tw.lap_matvec_windowed(ctx.plan, ctx.oh, Xp, W=ctx.W, s_max=ctx.s_max)
        second = tw.lap_matvec_windowed(ctx.plan, ctx.oh, Xp, W=ctx.W, s_max=ctx.s_max)
        torch.cuda.synchronize()
        check(torch.equal(first, second), "K2 + epilogue differs from run to run")
        emit("windowed_narrow_d_repeat", bit_equal=True)
        del lat, ctx, Xp, first, second

    # 10b. the windowed tier's routing under auto: the default environment
    # at and below the corpus tier, the unforced branches driven under the
    # JAX package's values through K4, the smallest such lattice against the
    # CPU; solve_auto's windowed halo tier under the default environment
    routing = window_routing()
    routing_halo = window_routing_halo()
    torch.cuda.empty_cache()
    default_launches = {
        key: sum(row.get(key, 0) for tag, row in routing["launches"].items()
                 if tag in ("locality", "gaussian", "small"))
        + sum(row.get(key, 0) for tag, row in routing_halo["launches"].items()
              if not tag.endswith("jax_values"))
        for key in ("K2", "K3", "K4")}

    # 11. the windowed tier under column chunks: K4 and K3 at D/c = 384, K2
    # and its epilogue at 96
    wchunk = windowed_chunked()
    chunk_rows = {row["kernel"]: row for row in wchunk["rows"]}
    chunk_launches = {key: {tag: val[key] for tag, val in wchunk["launches"].items() if key in val}
                      for key in ("K2", "K3", "K4")}
    k1_chunk_rows = big["k1_rows"] + [wchunk["k1_row"]]

    print(json.dumps({"kernels": [{
        "name": "spmv_gather",
        "route": "cuda",
        "source": "oscillink_tpu_torch/csrc/spmv.cu",
        "replaces": "oscillink_tpu/ops/pallas/spmv.py:43",
        "launches": launches,
        "max_abs_err": max(k1_err, max(r["max_abs_err"] for r in k1_src)),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": "N=131072 D=768 K=8",
        "slab_cols": sweep["plan_slab_cols"],
        "l2_budget_bytes": sweep["l2_budget_bytes"],
        "slab_sweep_ms": sweep["ms"],
        "slab_sweeps": {str(row["n"]): {key: row[key] for key in (
            "plan_slab_cols", "fastest_slab_cols", "plan_over_fastest", "ms")}
            for row in (sweep, sweep_mid, cluster["sweep"], big["sweep"])},
        "slab_sweeps_1m_chunk_widths": {str(row["d"]): {key: row[key] for key in (
            "plan_slab_cols", "fastest_slab_cols", "plan_over_fastest", "ms")}
            for row in big["chunk_sweeps"]},
        "slab_stream_only_ms": sweep["stream_only_ms"],
        "bench_graph_ms": win_timing["k1_ms"],
        "bench_graph_full_width_ms": win_timing["k1_full_width_ms"],
        "ptxas": k1_ptxas(libs["spmv"]["ptxas"]),
        "launches_per_settle": settle_launches,
        "launches_serving": serving,
        "launches_service": service_launches,
        "launches_auto": auto_launches,
        "launches_cli": cli["launches"],
        "launches_checkpoint": big["checkpoint"]["k1_launches"],
        "launches_texts": texts["launches"],
        "launches_profiling": prof["launches"],
        "gather_ceiling_ms": main_row["gather_ceiling_ms"],
        "per_shape": rows + narrow + [corpus_batch["k1_row"], big["k1_full"]],
        "launches_chunked": {**big["launches"], **{
            f"windowed_{tag}": val["K1"]
            for tag, val in wchunk["launches"].items() if "K1" in val}},
        "launches_mesh": mesh_launches,
        "src_form": k1_src,
        "src_max_abs_err": max(r["max_abs_err"] for r in k1_src),
        "chunk_max_abs_err": max(r["max_abs_err"] for r in k1_chunk_rows),
        "per_chunk_width": k1_chunk_rows,
    }] + [{
        "name": kname,
        "route": "cuda",
        "source": WINDOW_SOURCE,
        "replaces": replaces,
        "launches": win_launches[key],
        "max_abs_err": win_errs[key],
        **win_timing["rows"][key],
        "shape": "bench graph N=131072 (Npad 131328) D=768 K=8, W=R=384, 3 windows, bf16x3",
        "k1_same_graph_ms": win_timing["k1_ms"],
        "gather_plain_max_abs_err": win_errs[f"{key}_gather"],
        **({"pap_max_abs_err": win_errs["K4_pap"],
            "gather_plain_pap_max_abs_err": win_errs["K4_gather_pap"]} if key == "K4" else {}),
        "launches_chunked": chunk_launches[key],
        "launches_halo_windowed": {tag: val[key] for tag, val in halo_win["launches"].items()
                                   if key in val},
        "launches_default_path": default_launches[key],
        "launches_window_routing": {
            **{tag: val[key] for tag, val in routing["launches"].items() if key in val},
            **{f"halo_{tag}": val[key] for tag, val in routing_halo["launches"].items()
               if key in val}},
        "chunk_max_abs_err": chunk_rows[key]["max_abs_err"],
        "chunk_width": chunk_rows[key],
    } for key, kname, _, replaces in WINDOW_KERNELS] + [k5_row] + [{
        "name": f"cg_{name}",
        "route": "cuda",
        "source": "oscillink_tpu_torch/csrc/cg_fused.cu",
        "replaces": "none (XLA fused oscillink_tpu/ops/solver.py cg_solve's body)",
        "launches_corpus_flow": {key: cg["flow"][key]["cg_launches"] for key in ("ustar", "settle")},
        "max_ulps_vs_f64": max(row["max_ulps_vs_f64"] for row in cg["rows"]),
        "bit_equal": True,
        "per_shape": {f"{row['n']}x{row['d']}": row["timing"][name]
                      for row in cg["rows"] if "timing" in row},
    } for name in ("combine", "dot", "residual", "update", "direction", "alpha", "finish")] + [{
        "name": "edge_dists",
        "route": "cuda",
        "source": "oscillink_tpu_torch/csrc/edge_dists.cu",
        "replaces": "none (XLA fused oscillink_tpu/ops/receipts.py _edge_sq_dists)",
        "launches": sum(ed_flow.values()),
        "launches_corpus_flow": ed_flow,
        "launches_batch": {"batched_parity": parity_batch["edge_dists"],
                           "batched_corpus": corpus_batch["edge_dists"]},
        "max_rel_vs_plain": ed["max_rel_vs_plain"],
        "bit_equal_repeat": True,
        "per_shape": {f"{row['n']}x{row['d']}x{row['k']}": row["timing"]
                      for row in ed["rows"] if "timing" in row},
        "ptxas": libs["edge_dists"]["ptxas"],
    }]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
