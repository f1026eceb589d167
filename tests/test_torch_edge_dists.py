"""The edge-distance kernel's plain version and wrapper
(`oscillink_tpu_torch/ops/kernels/edge_dists.py`).

On the CPU: the receipts' `_edge_sq_dists` takes the plain version, whose
direct and row-blocked paths give the same bits and agree with a float64
sum of the same rounded terms; the wrapper refuses what the kernel does not
take; each lattice step makes the number of calls the card's checks count.
The cases marked ``cuda`` hold the kernel to the plain version on the card
and skip without one; this file imports no JAX, so they run there with
``python -m pytest --noconftest tests/test_torch_edge_dists.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from oscillink_tpu_torch.ops import receipts as trec  # noqa: E402
from oscillink_tpu_torch.ops.graph import build_graph  # noqa: E402
from oscillink_tpu_torch.ops.kernels import edge_dists  # noqa: E402

# (n, d, k): D a multiple of the slab, D not a multiple of 4, K past one
# group of 8 slots, a single row's worth of columns, N below a row tile
SHAPES = [(300, 64, 6), (257, 37, 5), (129, 97, 13), (70, 1, 3), (33, 768, 8)]


def _case(n, d, k, seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    X = torch.randn((n, d), generator=gen)
    g = build_graph(X, k)
    inv = 1.0 / (g.sqrt_deg + 1e-12)
    return g, X.to(device), inv.to(device)


def _f64_dists(idx, X, inv):
    """Each edge's terms rounded as the plain version rounds them (each side
    scaled in float32, subtracted, squared), summed in float64."""
    Xs = X if inv is None else X * inv[:, None]
    diff = Xs[:, None, :] - Xs[idx.long()]
    return (diff * diff).double().sum(-1)


def _blocked(monkeypatch):
    monkeypatch.setattr(edge_dists, "TEMP_BUDGET_BYTES", 1024)
    monkeypatch.setattr(edge_dists, "BLOCK_ROWS", 64)


@pytest.mark.parametrize("n,d,k", SHAPES)
@pytest.mark.parametrize("scaled", [False, True])
def test_plain_version_is_the_receipts_cpu_path(monkeypatch, n, d, k, scaled):
    """`_edge_sq_dists` on a CPU tensor is the plain version; its direct and
    blocked paths (ragged last block) give the same bits, zero-weight padded
    slots included, and agree with float64 sums of the same terms."""
    g, X, inv = _case(n, d, k, seed=n + d + k)
    s = inv if scaled else None
    direct = trec._edge_sq_dists(g, X, s)
    assert direct.dtype == torch.float32 and direct.shape == (n, k)
    assert torch.equal(direct, edge_dists.edge_sq_dists_ref(g.idx, X, s))
    _blocked(monkeypatch)
    assert torch.equal(trec._edge_sq_dists(g, X, s), direct)
    if n > 64:
        assert bool((g.w == 0).any()), "the graph should have zero-weight padded slots"
    np.testing.assert_allclose(direct.double().numpy(), _f64_dists(g.idx, X, s).numpy(),
                               rtol=1e-6, atol=1e-30)


def test_plain_version_takes_a_strided_lane():
    """A lane of an [N, Q, D] block, an [N, D] view with row stride Q·D,
    gives what its contiguous copy gives."""
    g, X, inv = _case(200, 48, 6, seed=7)
    block = torch.stack([X * 0.5, X, X * 2.0], dim=1)
    lane = block[:, 1]
    assert lane.stride() == (3 * 48, 1)
    assert torch.equal(edge_dists.edge_sq_dists_ref(g.idx, lane, inv),
                       edge_dists.edge_sq_dists_ref(g.idx, lane.contiguous(), inv))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    g, X, inv = _case(100, 16, 4, seed=3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        edge_dists.edge_sq_dists_cuda(g.idx, X, inv)
    with pytest.raises(ValueError, match="float32"):
        edge_dists.edge_sq_dists_cuda(g.idx, X.double(), inv)
    with pytest.raises(ValueError, match="float32"):
        edge_dists.edge_sq_dists_cuda(g.idx, X, inv.double())
    with pytest.raises(ValueError, match="int32"):
        edge_dists.edge_sq_dists_cuda(g.idx.long(), X, inv)
    with pytest.raises(ValueError, match=r"\[N, K\] and \[N, D\]"):
        edge_dists.edge_sq_dists_cuda(g.idx[:-1], X, inv)
    with pytest.raises(ValueError, match=r"must be \[N\]"):
        edge_dists.edge_sq_dists_cuda(g.idx, X, inv[:-1])
    with pytest.raises(ValueError, match="unsupported device"):
        trec._edge_sq_dists(g, X.to("meta"), None)


@pytest.mark.parametrize("d,slabs", [(768, 24), (97, 4), (32, 1), (5, 1)])
def test_scratch_bytes_counts_the_output_and_the_partials(d, slabs):
    """The working-set term: the [N, K] output, and the [slabs, N, K]
    partials at 32 columns a slab where D takes more than one."""
    n, k = 171332, 8
    partials = slabs if slabs > 1 else 0
    assert edge_dists.scratch_bytes(n, d, k) == 4 * n * k * (1 + partials)


# calls of `_edge_sq_dists` a lattice step makes: the light receipt none,
# the full receipt's energy two (Y and U*) and its null points one, a
# bundle's scores two, a chain receipt's residuals one, a batch two a lane
STEP_CALLS = [("light_receipt", 0), ("full_receipt", 3), ("bundle", 2),
              ("chain_receipt", 1), ("bundle_batch", 6)]


@pytest.mark.parametrize("step,calls", STEP_CALLS)
def test_edge_distance_calls_a_step(monkeypatch, step, calls):
    """The counts the card's checks hold `launches` to, on the CPU path."""
    from oscillink_tpu_torch import OscillinkLattice

    rng = np.random.default_rng(5)
    Y = rng.standard_normal((120, 32)).astype(np.float32)
    lat = OscillinkLattice(Y, kneighbors=6, device="cpu")
    lat.set_query(Y[:10].mean(0))
    lat.settle(max_iters=8, tol=1e-3)
    lat.set_receipt_detail("full" if step == "full_receipt" else "light")
    seen = []
    inner = trec._edge_sq_dists
    monkeypatch.setattr(trec, "_edge_sq_dists", lambda *a, **kw: seen.append(1) or inner(*a, **kw))
    if step.endswith("_receipt") and step != "chain_receipt":
        lat.receipt()
    elif step == "bundle":
        lat.bundle(k=4)
    elif step == "chain_receipt":
        lat.chain_receipt([2, 5, 7, 9])
    else:
        lat.bundle_batch(Y[:3], k=4)
    assert len(seen) == calls


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernel has no CPU form")
    return torch.device("cuda")


def _on(g, device):
    return g._replace(**{f: getattr(g, f).to(device) for f in g._fields})


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", SHAPES)
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("slab", [None, 32, 5])
def test_kernel_matches_plain_and_repeats_its_bits(card, n, d, k, scaled, slab):
    """The kernel against the plain version on the card within 1e-6
    relative, at the plan's slab width, at 32 and at a ragged 5, and the
    same bits on a second launch."""
    g, X, inv = _case(n, d, k, seed=n + d + k, device=card)
    g = _on(g, card)
    s = inv if scaled else None
    slab = None if slab is None else min(slab, d)
    got = edge_dists.edge_sq_dists_cuda(g.idx, X, s, slab_cols=slab)
    again = edge_dists.edge_sq_dists_cuda(g.idx, X, s, slab_cols=slab)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ref = edge_dists.edge_sq_dists_ref(g.idx, X, s)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=1e-6, atol=1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [768, 37])
def test_kernel_takes_a_strided_lane(card, d):
    """A lane view of an [N, Q, D] block gives its contiguous copy's bits."""
    g, X, inv = _case(1000, d, 8, seed=d, device=card)
    g = _on(g, card)
    block = torch.stack([X * 0.5, X, X * 2.0], dim=1)
    lane = block[:, 2]
    for slab in (None, min(32, d)):
        got = edge_dists.edge_sq_dists_cuda(g.idx, lane, inv, slab_cols=slab)
        want = edge_dists.edge_sq_dists_cuda(g.idx, lane.contiguous(), inv, slab_cols=slab)
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", SHAPES)
def test_kernel_allocates_at_most_its_scratch(card, n, d, k):
    """A call's peak allocation above its inputs is within `scratch_bytes`
    (the caching allocator rounds each of the two blocks to 512 bytes and
    leaves a large block's remainder of up to 1 MiB unsplit): no
    [rows, K, D] temporary."""
    g, X, inv = _case(n, d, k, seed=n, device=card)
    g = _on(g, card)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = edge_dists.edge_sq_dists_cuda(g.idx, X, inv, slab_cols=min(32, d))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    assert peak <= edge_dists.scratch_bytes(n, d, k) + (2 << 20)
    del out


@pytest.mark.cuda
def test_kernel_counts_one_launch_a_call(card):
    """`launches` rises by one a call, one slab or many, and the receipts'
    `_edge_sq_dists` goes through the kernel on a CUDA tensor."""
    g, X, inv = _case(500, 64, 6, seed=11, device=card)
    g = _on(g, card)
    before = edge_dists.launches
    edge_dists.edge_sq_dists_cuda(g.idx, X, inv)
    edge_dists.edge_sq_dists_cuda(g.idx, X, None, slab_cols=32)
    assert edge_dists.launches == before + 2
    got = trec._edge_sq_dists(g, X, inv)
    assert edge_dists.launches == before + 3
    ref = edge_dists.edge_sq_dists_ref(g.idx, X, inv)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=1e-6, atol=1e-30)
