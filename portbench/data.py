"""The cells' inputs, made on the device from ``--seed``.

Every draw comes from a ``torch.Generator`` on the device, seeded from the
run's seed and the name of its stream (`sub_seed`), in a few large calls.
The same seed gives the same corpus, topics, candidate sets and queries.

`study_corpus` copies the generator of ``chip_smoke.py:study_corpus`` (the
JAX package's IVF study corpus, ``benchmarks/probe_ivf_balanced_1m.py``):
Gaussian centres, each row a uniformly drawn centre plus ``spread`` times
Gaussian noise.  The copy draws on the device instead of with numpy.
"""

from __future__ import annotations

import hashlib
import math

import torch

QUERY_CHUNK = 256


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for the named stream of run ``seed`` (any integer)."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(device: torch.device, seed: int, stream: str) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream))
    return g


def study_corpus(corpus: dict, seed: int, device: torch.device):
    """(Y [n, d] float32, centres [c, d]) on ``device``: row i is
    centres[a_i] + spread * noise, a_i uniform over the centres."""
    n, d, c = corpus["n"], corpus["d"], corpus["centres"]
    g = generator(device, seed, "corpus")
    centres = torch.randn(c, d, generator=g, device=device)
    assign = torch.randint(0, c, (n,), generator=g, device=device)
    Y = torch.randn(n, d, generator=g, device=device).mul_(float(corpus["spread"]))
    Y.add_(centres[assign])
    return Y, centres


def pool_topics(corpus: dict, seed: int, device: torch.device) -> torch.Tensor:
    """The ids of the centres that queries are asked about (``topics``
    of them, distinct)."""
    g = generator(device, seed, "topics")
    return torch.randperm(corpus["centres"], generator=g, device=device)[: corpus["topics"]]


def query_chunk(centres: torch.Tensor, topics: torch.Tensor, noise: float, seed: int,
                stream: str, chunk: int) -> torch.Tensor:
    """Queries ``chunk * QUERY_CHUNK`` .. + QUERY_CHUNK - 1 of a stream:
    a pool topic's centre plus ``noise`` times fresh Gaussian noise."""
    dev = centres.device
    g = generator(dev, seed, f"{stream}:{chunk}")
    pick = torch.randint(0, topics.numel(), (QUERY_CHUNK,), generator=g, device=dev)
    psi = torch.randn(QUERY_CHUNK, centres.shape[1], generator=g, device=dev).mul_(noise)
    return psi.add_(centres[topics[pick]])


class Queries:
    """Query i of a stream, made QUERY_CHUNK at a time and kept on the host."""

    def __init__(self, centres, topics, noise: float, seed: int, stream: str):
        self._args = (centres, topics, float(noise), seed, stream)
        self._chunks: dict[int, object] = {}

    def __getitem__(self, i: int):
        c, r = divmod(int(i), QUERY_CHUNK)
        if c not in self._chunks:
            self._chunks[c] = query_chunk(*self._args, c).cpu().numpy()
        return self._chunks[c][r]


def stratified_sizes(lo: int, hi: int, count: int) -> list[int]:
    """``count`` candidate-set sizes at the midpoints of equal steps of
    log N from ``lo`` to ``hi``: log-uniform, and the same for every seed."""
    a, b = math.log(lo), math.log(hi)
    return [int(round(math.exp(a + (b - a) * (i + 0.5) / count))) for i in range(count)]


def stratified_order(count: int, strata: int, seed: int) -> list[int]:
    """An order of pool entries 0..count-1 (entries sorted by size) in which
    each run of ``strata`` consecutive entries holds one of each stratum of
    sizes, so any window of whole runs sends the same sizes; the seed
    shuffles the order within and across runs."""
    per = count // strata
    g = torch.Generator().manual_seed(sub_seed(seed, "order"))
    cols = [torch.randperm(per, generator=g).tolist() for _ in range(strata)]
    order = []
    for r in range(per):
        run = [s * per + cols[s][r] for s in range(strata)]
        perm = torch.randperm(strata, generator=g).tolist()
        order.extend(run[p] for p in perm)
    return order


def candidate_sets(Y: torch.Tensor, centres: torch.Tensor, topics: torch.Tensor,
                   sizes: list[int], seed: int) -> list[torch.Tensor]:
    """One candidate set per size: the ids of the ``size`` rows of Y of
    highest cosine to a pool topic drawn from the seed, best first, on Y's
    device."""
    dev = Y.device
    g = generator(dev, seed, "candidates")
    pick = torch.randint(0, topics.numel(), (len(sizes),), generator=g, device=dev)
    tids = topics[pick]
    Yn = Y / (torch.linalg.vector_norm(Y, dim=1, keepdim=True) + 1e-12)
    C = centres[tids]
    Cn = C / (torch.linalg.vector_norm(C, dim=1, keepdim=True) + 1e-12)
    sims = Yn @ Cn.T  # [n, sets]
    top = torch.topk(sims, max(sizes), dim=0).indices  # [max, sets]
    return [top[:s, i].clone() for i, s in enumerate(sizes)]
