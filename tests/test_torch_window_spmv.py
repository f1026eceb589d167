"""Kernels K2–K4 of the PyTorch port (windowed matvec) and their plans.

On the CPU the port's plain versions are held against the TPU kernels run
as the JAX package's own tests run them: `_window_spmv` (K2) interprets by
itself off the TPU, `_window_spmv3` (K3) and `_window_spmv3f` (K4) run with
`pl.pallas_call` patched to ``interpret=True``.  Both sides take the same
bf16-rounded operands and sum the exact products in f32, so only the order
of summation differs: outputs are held to 1e-5 relative to max|ref|, K4's
column partials (summed over rows and blocks) to 1e-4, as
`tests/test_fused_windowed.py` holds the JAX package's own.  The gather-form
plain versions of K2, K3 and K4 (the arithmetic of the kernels in
``csrc/window_spmv3f.cu``) differ from the one-hot forms by about 2^-16 a
product and are held to the same bars.  Plans and one-hots must be
identical.  The CUDA kernels have no CPU mode: `chip_smoke.py` holds them
against these plain versions on a card.
"""

from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from oscillink_tpu.ops.pallas import window_spmv as ws  # noqa: E402
from oscillink_tpu_torch import interop  # noqa: E402
from oscillink_tpu_torch.ops.kernels import build as kbuild  # noqa: E402
from oscillink_tpu_torch.ops.kernels import window_spmv as tw  # noqa: E402

TIERS = ("bf16x3", "bf16x2", "oh16", "dma16", "bf16")


def _far_jump(n, k, seed, spread=200, band=300):
    """Neighbours within ±spread of the diagonal plus a band of random
    far jumps, so some row blocks have stragglers and some have none
    (the recipe of tests/test_window_spmv.py)."""
    rng = np.random.default_rng(seed)
    idx = (np.arange(n)[:, None] + rng.integers(-spread, spread, size=(n, k))) % n
    lo = n // 3
    idx[lo:lo + band] = rng.integers(0, n, size=(band, k))
    wn = (rng.random((n, k)) * 0.1).astype(np.float32)
    wn[rng.random((n, k)) < 0.1] = 0.0  # padding slots
    return idx.astype(np.int32), wn


def _assert_plans_equal(pj, pt):
    for name in pj._fields:
        a = np.asarray(getattr(pj, name))
        b = getattr(pt, name).cpu().numpy()
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def _interp():
    orig = ws.pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    return mock.patch.object(ws.pl, "pallas_call", interp)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


@pytest.mark.parametrize(
    "n,k,W,R,n_win",
    [(1900, 6, 384, 384, 3), (2000, 5, 512, 256, 2), (700, 5, 256, 128, 3), (1000, 4, 128, 128, 1)],
)
def test_host_plan_matches_jax(n, k, W, R, n_win):
    idx, wn = _far_jump(n, k, seed=n)
    pj, cj = ws.build_window_plan(idx, wn, W=W, R=R, n_windows=n_win)
    pt, ct = tw.build_window_plan(idx, wn, W=W, R=R, n_windows=n_win, device="cpu")
    _assert_plans_equal(pj, pt)
    assert ct == cj
    assert tw.plan_s_max(pt) == ws.plan_s_max(pj)


@pytest.mark.parametrize(
    "n,k,W,R,n_win,cap,s_max",
    [
        (1900, 6, 384, 384, 3, 1024, 384),  # the lattice geometry
        (1900, 6, 384, 384, 3, 64, 384),  # cap truncates: fits false, drops masked
        (2000, 5, 512, 256, 2, 2048, 128),  # a segment overflows s_max
        (1100, 8, 384, 384, 3, 9216, 768),  # the low-coverage retry's cap
    ],
)
def test_device_plan_matches_jax(n, k, W, R, n_win, cap, s_max):
    idx, wn = _far_jump(n, k, seed=k)
    order = np.random.default_rng(n).permutation(n).astype(np.int32)
    pj, cov_j, ns_j, fits_j = ws.build_window_plan_device(
        jnp.asarray(idx), jnp.asarray(wn), jnp.asarray(order), W, R, cap, s_max, n_win
    )
    pt, cov_t, ns_t, fits_t = tw.build_window_plan_device(
        torch.from_numpy(idx), torch.from_numpy(wn), torch.from_numpy(order), W, R, cap, s_max,
        n_win,
    )
    _assert_plans_equal(pj, pt)
    assert float(cov_t) == float(cov_j)
    assert int(ns_t) == int(ns_j)
    assert bool(fits_t) == bool(fits_j)


@pytest.mark.parametrize("s_max", [128, 384])
def test_build_onehot_matches_jax_exactly(s_max):
    idx, wn = _far_jump(1900, 6, seed=3)
    pj, _ = ws.build_window_plan(idx, wn, W=384, R=384, n_windows=3)
    pt, _ = tw.build_window_plan(idx, wn, W=384, R=384, n_windows=3, device="cpu")
    s_max = max(s_max, ws.plan_s_max(pj))
    oj = ws.build_onehot(pj, 384, s_max)
    ot_ = tw.build_onehot(pt, 384, s_max)
    assert ot_.main.dtype == torch.float32 and ot_.strag.dtype == torch.bfloat16
    np.testing.assert_array_equal(ot_.main.numpy(), np.asarray(oj.main))
    np.testing.assert_array_equal(
        ot_.strag.float().numpy(), np.asarray(oj.strag.astype(jnp.float32))
    )


ACCEPT_CASES = [
    dict(cov=0.99, n_strag=10, fits=True, s_max=384, strag_cap=1024),
    dict(cov=0.99, n_strag=2000, fits=True, s_max=384, strag_cap=1024),
    dict(cov=0.99, n_strag=10, fits=False, s_max=384, strag_cap=1024),
    dict(cov=0.5, n_strag=10, fits=True, s_max=384, strag_cap=1024),
    dict(cov=0.5, n_strag=10, fits=True, s_max=1024, strag_cap=4096),
]


@pytest.mark.parametrize("case", ACCEPT_CASES)
@pytest.mark.parametrize("forced", [True, False])
@pytest.mark.parametrize("lowcov", [0, 768])
def test_accept_window_plan_matches_jax(case, forced, lowcov):
    """Forced and unforced plans: the port decides as the JAX package does."""
    kw = dict(forced=forced, min_cov=0.92, lowcov_bound=lowcov)
    assert tw.accept_window_plan(**case, **kw) == ws.accept_window_plan(**case, **kw)


@pytest.mark.parametrize("s_max", [128, 384])
def test_right_sized_plan_gives_the_same_operator(s_max):
    """Cutting the straggler arrays to strag_off[-1] + s_max (rounded up to
    128) keeps every entry the kernels read."""
    n = 1900
    idx, wn = _far_jump(n, 6, seed=12)
    order = torch.arange(n)
    plan, _, n_strag, fits = tw.build_window_plan_device(
        torch.from_numpy(idx), torch.from_numpy(wn), order, 384, 384, 4096, 384, 3)
    assert bool(fits) and int(n_strag) <= 4096
    s_max = max(s_max, tw.plan_s_max(plan))
    off_last = int(plan.strag_off[-1])
    cut = tw.right_size_stragglers(plan, off_last, s_max)
    assert cut.strag_w.shape[0] == -(-(off_last + s_max) // 128) * 128 < 4096
    oh, oh_cut = tw.build_onehot(plan, 384, s_max), tw.build_onehot(cut, 384, s_max)
    assert torch.equal(oh.strag, oh_cut.strag) and torch.equal(oh.main, oh_cut.main)
    X = tw.pad_rows(torch.from_numpy(np.random.default_rng(0).standard_normal((n, 128)).astype(
        np.float32)), plan.n_pad)
    args = (384, 384, s_max, "bf16x3")
    assert torch.equal(tw.window_spmv3_ref(cut, oh.main, oh.strag, X, *args),
                       tw.window_spmv3_ref(plan, oh.main, oh.strag, X, *args))
    assert tw.right_size_stragglers(cut, off_last, s_max) is cut


@pytest.mark.parametrize("value", [None, "bf16x3", "BF16X2", " oh16 ", "dma16", "bf16", "fp8", ""])
def test_precision_tier_parser_matches_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("OSCILLINK_WINDOW_PRECISION", raising=False)
    else:
        monkeypatch.setenv("OSCILLINK_WINDOW_PRECISION", value)
    assert tw._env_precision() == ws._env_precision()
    for bound in ("512", "0"):
        monkeypatch.setenv("OSCILLINK_WINDOWED_LOWCOV_SMAX", bound)
        assert tw.lowcov_smax_bound() == ws.lowcov_smax_bound()
    # a value that is not an integer gives each package's own default
    monkeypatch.setenv("OSCILLINK_WINDOWED_LOWCOV_SMAX", "x")
    assert tw.lowcov_smax_bound() == tw.LOWCOV_SMAX_DEFAULT


def _kernel_case(n, d, seed, W=384, R=384, n_win=3, k=6):
    idx, wn = _far_jump(n, k, seed=seed)
    pj, _ = ws.build_window_plan(idx, wn, W=W, R=R, n_windows=n_win)
    pt, _ = tw.build_window_plan(idx, wn, W=W, R=R, n_windows=n_win, device="cpu")
    s_max = ws.plan_s_max(pj)
    cnt = np.asarray(pj.strag_cnt)
    assert (cnt == 0).any() and (cnt > 0).any()  # both straggler arms run
    oj = ws.build_onehot(pj, W, s_max)
    ot_ = tw.build_onehot(pt, W, s_max)
    rng = np.random.default_rng(seed + 1)
    X = rng.standard_normal((n, d)).astype(np.float32)
    g = (1.5 + rng.random((pj.n_pad, 1))).astype(np.float32)
    Xj = ws.pad_rows(jnp.asarray(X), pj.n_pad)
    Xt = tw.pad_rows(torch.from_numpy(X), pt.n_pad)
    return pj, pt, oj, ot_, Xj, Xt, g, s_max


def _main(oh, tier, jax_side):
    """The one-hot as the lattice stores it for the tier: bf16 under oh16/dma16."""
    if tier not in ("oh16", "dma16"):
        return oh.main
    return oh.main.astype(jnp.bfloat16) if jax_side else oh.main.to(torch.bfloat16)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("n,d", [(1900, 96), (1500, 37)])  # ragged N; D % 128 != 0
def test_k2_plain_matches_pallas(tier, n, d):
    pj, pt, oj, ot_, Xj, Xt, _, _ = _kernel_case(n, d, seed=d)
    ref = ws._window_spmv(pj, _main(oj, tier, True), Xj, 384, 384, tier)
    out = tw.window_spmv_ref(pt, _main(ot_, tier, False), Xt, 384, 384, tier)
    assert _rel(out.numpy(), ref) < 1e-5


@pytest.mark.parametrize("tier", TIERS)
def test_k3_plain_matches_pallas_interpret(tier):
    pj, pt, oj, ot_, Xj, Xt, _, s_max = _kernel_case(1900, 64, seed=11)
    with _interp():
        ref = ws._window_spmv3(pj, _main(oj, tier, True), oj.strag, Xj, 384, 384, s_max, tier)
    out = tw.window_spmv3_ref(pt, _main(ot_, tier, False), ot_.strag, Xt, 384, 384, s_max, tier)
    assert _rel(out.numpy(), ref) < 1e-5


@pytest.mark.parametrize("tier", TIERS)
def test_k4_plain_matches_pallas_interpret(tier):
    pj, pt, oj, ot_, Xj, Xt, g, s_max = _kernel_case(1700, 48, seed=5)
    with _interp():
        ref, pap_ref = ws._window_spmv3f(
            pj, _main(oj, tier, True), oj.strag, Xj, jnp.asarray(g), 384, 384, s_max, tier
        )
    out, pap = tw.window_spmv3f_ref(
        pt, _main(ot_, tier, False), ot_.strag, Xt, torch.from_numpy(g), 384, 384, s_max, tier
    )
    assert _rel(out.numpy(), ref) < 1e-5
    assert _rel(pap.numpy(), pap_ref) < 1e-4


GEOMETRIES = {
    "ragged_384x3": dict(n=1700, d=48, seed=5),
    "w512_r256x2": dict(n=2000, d=32, seed=9, W=512, R=256, n_win=2),
    # more slots a row than one warp's 32 lanes: a window's repeated columns
    # can fall in different 32-slot chunks of the kernel's walk
    "k40_384x3": dict(n=1200, d=48, seed=17, k=40),
}


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_k4_gather_plain_matches_pallas_and_the_onehot_form(tier, geometry):
    """K4's gather form against the TPU kernel (interpret mode) and the
    one-hot plain version, in every tier; the plans repeat columns within a
    row, which the gather form must merge as the one-hot does."""
    geo = dict(GEOMETRIES[geometry])
    W, R = geo.get("W", 384), geo.get("R", 384)
    pj, pt, oj, ot_, Xj, Xt, g, s_max = _kernel_case(**geo)
    gt = torch.from_numpy(g)
    with _interp():
        ref, pap_ref = ws._window_spmv3f(pj, _main(oj, tier, True), oj.strag, Xj, jnp.asarray(g),
                                         W, R, s_max, tier)
    one, pap_one = tw.window_spmv3f_ref(pt, _main(ot_, tier, False), ot_.strag, Xt, gt, W, R,
                                        s_max, tier)
    out, pap = tw.window_spmv3f_gather_ref(pt, Xt, gt, W, R, s_max, tier)
    assert _rel(out.numpy(), ref) < 1e-5 and _rel(pap.numpy(), pap_ref) < 1e-4
    assert _rel(out.numpy(), one.numpy()) < 1e-5 and _rel(pap.numpy(), pap_one.numpy()) < 1e-4


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_k2_k3_gather_plain_match_pallas_and_the_onehot_form(kernel, tier, geometry):
    """K2's and K3's gather forms (K4's arithmetic without g and partials;
    K2 also without stragglers) against the TPU kernels (interpret mode) and
    the one-hot plain versions, in every tier and geometry of the K4 test."""
    geo = dict(GEOMETRIES[geometry])
    W, R = geo.get("W", 384), geo.get("R", 384)
    pj, pt, oj, ot_, Xj, Xt, _, s_max = _kernel_case(**geo)
    main_j, main_t = _main(oj, tier, True), _main(ot_, tier, False)
    if kernel == "K2":
        ref = ws._window_spmv(pj, main_j, Xj, W, R, tier)
        one = tw.window_spmv_ref(pt, main_t, Xt, W, R, tier)
        out = tw.window_spmv_gather_ref(pt, Xt, W, R, tier)
    else:
        with _interp():
            ref = ws._window_spmv3(pj, main_j, oj.strag, Xj, W, R, s_max, tier)
        one = tw.window_spmv3_ref(pt, main_t, ot_.strag, Xt, W, R, s_max, tier)
        out = tw.window_spmv3_gather_ref(pt, Xt, W, R, s_max, tier)
    assert _rel(out.numpy(), ref) < 1e-5
    assert _rel(out.numpy(), one.numpy()) < 1e-5


@pytest.mark.parametrize("tier", ["bf16x3", "dma16"])
def test_straggler_epilogue_matches_the_jax_scatter(tier):
    """K2's epilogue, each row's run of the sorted straggler list subtracted
    in entry order, against the JAX package's XLA scatter
    ``out.at[strag_dst].add(-contrib)`` on a plan whose rows repeat
    destinations (dma16 rounds each weighted row to bf16 on both sides)."""
    pj, pt, _, _, Xj, Xt, _, s_max = _kernel_case(1900, 40, seed=2)
    live_dst = pt.strag_dst[pt.strag_w != 0.0]
    assert bool((live_dst[1:] == live_dst[:-1]).any())
    base = np.random.default_rng(7).standard_normal(tuple(Xt.shape)).astype(np.float32)
    contrib = pj.strag_w[:, None] * jnp.take(Xj, pj.strag_src, axis=0)
    if tier == "dma16":
        contrib = contrib.astype(jnp.bfloat16).astype(jnp.float32)
    ref = jnp.asarray(base).at[pj.strag_dst].add(-contrib, indices_are_sorted=True,
                                                  unique_indices=False)
    out = tw._stragglers_gather(pt, Xt, torch.from_numpy(base), 384, s_max, tier)
    assert _rel(out.numpy(), ref) < 1e-6


def _unreferenced_window_rows(plan, W, R, n):
    """Real rows (< n) of elected windows that no live slot, no straggler
    entry and no padding entry reads."""
    n_pad = plan.n_pad
    blk = torch.arange(n_pad) // R
    read = torch.zeros(n_pad, dtype=torch.bool)
    held = torch.zeros(n_pad, dtype=torch.bool)
    for w in range(plan.n_windows):
        cols = (plan.cs[w].long()[blk] * W)[:, None] + plan.idxl[w].long()
        read[cols[plan.wnl[w] != 0.0]] = True
        held[(plan.cs[w].long()[:, None] * W + torch.arange(W)).reshape(-1)] = True
    read[plan.strag_src.long()] = True
    rows = torch.nonzero(held & ~read)[:, 0]
    return rows[rows < n]


@pytest.mark.parametrize("value", ["nan", "inf"])
def test_a_nonfinite_unreferenced_window_row_stays_out_of_the_gather_forms(value):
    """Gather semantics, the kernels' behaviour on the card: a NaN or an
    infinity in a window row that no row references reaches no output row
    but its own in the gather forms of K2, K3 and K4.  The one-hot forms, as
    the TPU kernels, spread it through 0·NaN to every row of each block
    whose windows hold it."""
    n, W, R = 1900, 384, 384
    _, pt, _, ot_, _, Xt, g, s_max = _kernel_case(n, 64, seed=11)
    r = int(_unreferenced_window_rows(pt, W, R, n)[0])
    X = Xt.clone()
    X[r] = float(value)
    gt = torch.from_numpy(g)
    gather = {
        "K2": tw.window_spmv_gather_ref(pt, X, W, R, "bf16x3"),
        "K3": tw.window_spmv3_gather_ref(pt, X, W, R, s_max, "bf16x3"),
        "K4": tw.window_spmv3f_gather_ref(pt, X, gt, W, R, s_max, "bf16x3")[0],
    }
    one_hot = {
        "K2": tw.window_spmv_ref(pt, ot_.main, X, W, R, "bf16x3"),
        "K3": tw.window_spmv3_ref(pt, ot_.main, ot_.strag, X, W, R, s_max, "bf16x3"),
        "K4": tw.window_spmv3f_ref(pt, ot_.main, ot_.strag, X, gt, W, R, s_max, "bf16x3")[0],
    }
    rows = torch.arange(pt.n_pad)
    holds = (pt.cs == r // W).any(dim=0)[rows // R]  # the rows of blocks whose windows hold r
    assert 0 < int(holds.sum()) < pt.n_pad
    for key in gather:
        bad = ~torch.isfinite(gather[key]).all(dim=1)
        assert torch.equal(bad, rows == r), key
        bad = ~torch.isfinite(one_hot[key]).all(dim=1)
        assert torch.equal(bad, holds | (rows == r)), key


def test_merged_weights_sum_repeated_columns_in_slot_order():
    idxl = torch.tensor([[3, 5, 3, 0, 3], [1, 1, 2, 7, 0]], dtype=torch.int32)
    wnl = torch.tensor([[0.5, 0.25, 2.0**-30, 0.0, 0.125], [0.0, 0.75, 0.5, 0.0, 0.0]])
    merged = tw._merged_weights(idxl, wnl)
    want = torch.tensor([[(0.5 + 2.0**-30) + 0.125, 0.25, 0.0, 0.0, 0.0],
                         [0.0, 0.75, 0.5, 0.0, 0.0]])
    assert torch.equal(merged, want)


def test_k4_gather_plain_skips_padding_and_empty_blocks():
    """Straggler padding (w = 0) contributes nothing, even from a NaN source
    row, and a block whose count is 0 applies none of its segment."""
    pj, pt, oj, ot_, Xj, Xt, g, s_max = _kernel_case(1900, 64, seed=13)
    gt = torch.from_numpy(g)
    n, args = 1900, (384, 384, s_max, "bf16x3")
    out, _ = tw.window_spmv3f_gather_ref(pt, Xt, gt, *args)
    pad = pt.strag_w == 0.0
    assert bool(pad.any())
    Xn = Xt.clone()
    Xn[-1] = float("nan")  # a padding row no live slot reads
    nan_src = pt._replace(strag_src=torch.where(pad, pt.n_pad - 1, pt.strag_src))
    out_nan, _ = tw.window_spmv3f_gather_ref(nan_src, Xn, gt, *args)
    assert torch.equal(out_nan[:n], out[:n])

    cnt = pt.strag_cnt.clone()
    i = int(torch.nonzero(cnt > 0)[0, 0])
    off = int(pt.strag_off[i])
    no_count = pt._replace(strag_cnt=torch.where(torch.arange(cnt.numel()) == i, 0, cnt))
    w0 = pt.strag_w.clone()
    w0[off:off + int(cnt[i])] = 0.0
    out_empty, _ = tw.window_spmv3f_gather_ref(no_count, Xt, gt, *args)
    assert torch.equal(out_empty, tw.window_spmv3f_gather_ref(pt._replace(strag_w=w0), Xt, gt,
                                                               *args)[0])
    assert not torch.equal(out_empty, out)
    one, _ = tw.window_spmv3f_ref(no_count, ot_.main, ot_.strag, Xt, gt, *args)
    assert _rel(out_empty.numpy(), one.numpy()) < 1e-5


def test_k_matvec_windowed_with_more_slots_than_a_warp_matches_pallas():
    """K = 40 slots a row still takes K4's path (no slot limit): on the CPU
    its one-hot plain version, with no launch."""
    n, k = 1200, 40
    idx, wn = _far_jump(n, k, seed=17)
    pj, _ = ws.build_window_plan(idx, wn, W=384, R=384, n_windows=3)
    pt, _ = tw.build_window_plan(idx, wn, W=384, R=384, n_windows=3, device="cpu")
    s_max = ws.plan_s_max(pj)
    oj, ot_ = ws.build_onehot(pj, 384, s_max), tw.build_onehot(pt, 384, s_max)
    rng = np.random.default_rng(3)
    X = rng.standard_normal((n, 128)).astype(np.float32)
    g = (1.5 + rng.random((pj.n_pad, 1))).astype(np.float32)
    kj, pap_j = ws.k_matvec_windowed(pj, oj, ws.pad_rows(jnp.asarray(X), pj.n_pad),
                                     jnp.asarray(g), precision="bf16x3")
    Xt, gt = tw.pad_rows(torch.from_numpy(X), pt.n_pad), torch.from_numpy(g)
    before = tw.window_spmv3f_cuda.launches
    kt, pap_t = tw.k_matvec_windowed(pt, ot_, Xt, gt, W=384, s_max=s_max, precision="bf16x3")
    assert tw.window_spmv3f_cuda.launches == before
    one, pap_one = tw.window_spmv3f_ref(pt, ot_.main, ot_.strag, Xt, gt, 384, 384, s_max,
                                        "bf16x3")
    assert torch.equal(kt, one) and torch.equal(pap_t, pap_one)
    assert _rel(kt.numpy(), kj) < 1e-5 and _rel(pap_t.numpy(), pap_j) < 1e-4


def test_kernels_in_the_other_geometry_match_pallas():
    """W = 512 windows over R = 256 row blocks, two windows."""
    pj, pt, oj, ot_, Xj, Xt, g, s_max = _kernel_case(2000, 32, seed=9, W=512, R=256, n_win=2)
    ref2 = ws._window_spmv(pj, oj.main, Xj, 512, 256, "bf16x3")
    with _interp():
        ref4, pap_ref = ws._window_spmv3f(pj, oj.main, oj.strag, Xj, jnp.asarray(g), 512, 256,
                                          s_max, "bf16x3")
    assert _rel(tw.window_spmv_ref(pt, ot_.main, Xt, 512, 256, "bf16x3").numpy(), ref2) < 1e-5
    out, pap = tw.window_spmv3f_ref(pt, ot_.main, ot_.strag, Xt, torch.from_numpy(g), 512, 256,
                                    s_max, "bf16x3")
    assert _rel(out.numpy(), ref4) < 1e-5 and _rel(pap.numpy(), pap_ref) < 1e-4


@pytest.mark.parametrize("tier", ["bf16x3", "dma16"])
@pytest.mark.parametrize("d", [128, 40])  # K3/K4 route vs K2 + epilogue route
def test_windowed_operators_match_jax(monkeypatch, tier, d):
    """`lap_matvec_windowed` and `k_matvec_windowed`.  Off the TPU the JAX
    package always composes K2 + its XLA scatter epilogue; the port routes
    D % 128 == 0 to K3/K4 as the reference does on its chip."""
    monkeypatch.setenv("OSCILLINK_WINDOW_PRECISION", tier)
    pj, pt, oj, ot_, Xj, Xt, g, s_max = _kernel_case(1900, d, seed=2)
    oj = oj._replace(main=_main(oj, tier, True))
    ot_ = ot_._replace(main=_main(ot_, tier, False))
    lap_j = ws.lap_matvec_windowed(pj, oj, Xj)
    lap_t = tw.lap_matvec_windowed(pt, ot_, Xt, W=384, s_max=s_max)
    assert _rel(lap_t.numpy(), lap_j) < 1e-5
    kj, pap_j = ws.k_matvec_windowed(pj, oj, Xj, jnp.asarray(g))
    kt, pap_t = tw.k_matvec_windowed(pt, ot_, Xt, torch.from_numpy(g), W=384, s_max=s_max)
    assert _rel(kt.numpy(), kj) < 1e-5
    assert _rel(pap_t.numpy(), pap_j) < 1e-4


def test_plain_versions_match_the_gather_matvec():
    """Real rows of the windowed Laplacian equal the gather-SpMV."""
    from oscillink_tpu_torch.ops.kernels.spmv import lap_matvec_ref

    n = 1900
    idx, wn = _far_jump(n, 6, seed=21)
    pt, _ = tw.build_window_plan(idx, wn, W=384, R=384, n_windows=3, device="cpu")
    s_max = tw.plan_s_max(pt)
    oh = tw.build_onehot(pt, 384, s_max)
    X = torch.from_numpy(np.random.default_rng(0).standard_normal((n, 128)).astype(np.float32))
    ref = lap_matvec_ref(torch.from_numpy(idx), torch.from_numpy(wn), X)
    for d in (128, 100):
        Xp = tw.pad_rows(X[:, :d].contiguous(), pt.n_pad)
        out = tw.lap_matvec_windowed(pt, oh, Xp, W=384, s_max=s_max, precision="bf16x3")
        assert _rel(out[:n].numpy(), ref[:, :d].numpy()) < 1e-5
        gather = tw.window_spmv3_gather_ref(pt, Xp, 384, 384, s_max, "bf16x3")
        assert _rel(gather[:n].numpy(), ref[:, :d].numpy()) < 1e-5


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    pj, pt, oj, ot_, Xj, Xt, g, s_max = _kernel_case(1900, 128, seed=4)
    before = [f.launches for f in (tw.window_spmv_cuda, tw.window_spmv3_cuda, tw.window_spmv3f_cuda)]
    gt = torch.from_numpy(g)
    geo = dict(W=384, s_max=s_max, precision="bf16x3")
    out = tw.lap_matvec_windowed(pt, ot_, Xt, **geo)
    assert torch.equal(out, tw.window_spmv3_ref(pt, ot_.main, ot_.strag, Xt, 384, 384, s_max, "bf16x3"))
    X97 = Xt[:, :97].contiguous()  # D % 128 != 0: K2's route and the epilogue
    out = tw.lap_matvec_windowed(pt, ot_, X97, **geo)
    want = tw._stragglers_gather(pt, X97, tw.window_spmv_ref(pt, ot_.main, X97, 384, 384, "bf16x3"),
                                 384, s_max, "bf16x3")
    assert torch.equal(out, want)
    k, pap = tw.k_matvec_windowed(pt, ot_, Xt, gt, **geo)
    k_ref, pap_ref = tw.window_spmv3f_ref(pt, ot_.main, ot_.strag, Xt, gt, 384, 384, s_max, "bf16x3")
    assert torch.equal(k, k_ref) and torch.equal(pap, pap_ref)
    after = [f.launches for f in (tw.window_spmv_cuda, tw.window_spmv3_cuda, tw.window_spmv3f_cuda)]
    assert after == before
    # the CPU route's plain versions read the one-hots: without them it refuses
    for fn, args in ((tw.lap_matvec_windowed, (pt, None, Xt)),
                     (tw.lap_matvec_windowed, (pt, None, X97)),
                     (tw.k_matvec_windowed, (pt, None, Xt, gt))):
        with pytest.raises(ValueError, match="one-hot plain versions"):
            fn(*args, **geo)


def test_wrappers_refuse_cpu_tensors():
    _, pt, _, ot_, _, Xt, g, s_max = _kernel_case(1900, 64, seed=6)
    gt = torch.from_numpy(g)
    calls = (
        (tw.window_spmv_cuda, (pt, Xt, 384, 384, "bf16x3")),
        (tw.window_spmv3_cuda, (pt, Xt, 384, 384, s_max, "bf16x3")),
        (tw.window_spmv3f_cuda, (pt, Xt, gt, 384, 384, s_max, "bf16x3")),
    )
    for fn, args in calls:
        before = fn.launches
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(*args)
        assert fn.launches == before


# the entry points of csrc/window_spmv3f.cu, one compile-time variant of its
# kernel each, and the Pallas kernel each replaces
ENTRY_POINTS = {
    "window_spmv": "oscillink_tpu/ops/pallas/window_spmv.py:_matmul_kernel (K2",
    "window_spmv3": "oscillink_tpu/ops/pallas/window_spmv.py:_matmul_kernel3 (K3",
    "window_spmv3f": "oscillink_tpu/ops/pallas/window_spmv.py:_matmul_kernel3f (K4",
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_window_source_is_content_addressed_and_names_what_it_replaces(name):
    """One source carries K2, K3 and K4: it names each Pallas kernel and
    exports each entry point, and it reads no one-hot, takes no buffer of
    weighted straggler rows and uses no atomics; no source of the port
    holds a WMMA product."""
    src, lib = kbuild._target("window_spmv3f")
    assert src == kbuild.CSRC_DIR / "window_spmv3f.cu" and src.exists()
    assert lib.parent == kbuild.BUILD_DIR and lib.name.startswith("window_spmv3f-")
    text = src.read_text()
    assert ENTRY_POINTS[name] in text
    assert f"int oscillink_{name}(" in text
    assert "oscillink_window_spmv3f_error_string(" in text
    for needle in ("wmma::", "oh3", "contrib"):
        assert needle not in text
    assert "atomic" not in text.replace("no atomics", "").replace("without atomics", "")
    assert not (kbuild.CSRC_DIR / "window_spmv.cu").exists()
    for other in kbuild.CSRC_DIR.glob("*.cu"):
        assert "wmma::" not in other.read_text(), other.name


def _jax_plan_arrays(pj):
    return [np.asarray(getattr(pj, f)) for f in pj._fields]


def test_interop_carries_a_jax_plan_and_onehots():
    idx, wn = _far_jump(1900, 6, seed=8)
    pj, _ = ws.build_window_plan(idx, wn, W=384, R=384, n_windows=3)
    s_max = ws.plan_s_max(pj)
    oj = ws.build_onehot(pj, 384, s_max)
    pt = interop.window_plan_from_numpy(*_jax_plan_arrays(pj), W=384, s_max=s_max, device="cpu")
    _assert_plans_equal(pj, pt)
    for main, dtype in ((oj.main, torch.float32), (oj.main.astype(jnp.bfloat16), torch.bfloat16)):
        oh = interop.onehots_from_numpy(np.asarray(main), np.asarray(oj.strag), device="cpu")
        assert oh.main.dtype == dtype and oh.strag.dtype == torch.bfloat16
        np.testing.assert_array_equal(oh.main.float().numpy(), np.asarray(main.astype(jnp.float32)))
        np.testing.assert_array_equal(
            oh.strag.float().numpy(), np.asarray(oj.strag.astype(jnp.float32))
        )


def test_interop_rejects_plans_the_kernels_cannot_take():
    idx, wn = _far_jump(1900, 6, seed=8)
    pj, _ = ws.build_window_plan(idx, wn, W=384, R=384, n_windows=3)
    arrays = _jax_plan_arrays(pj)
    bad = [a.copy() for a in arrays]
    bad[1][0, 0, 0] = 384  # idxl: a local id past the window
    with pytest.raises(ValueError, match=r"\[0, W=384\)"):
        interop.window_plan_from_numpy(*bad, W=384, device="cpu")
    bad = [a.copy() for a in arrays]
    bad[3][[0, -1]] = bad[3][[-1, 0]]  # strag_dst: out of order
    with pytest.raises(ValueError, match="non-decreasing"):
        interop.window_plan_from_numpy(*bad, W=384, device="cpu")
    bad = [a.copy() for a in arrays]
    bad[4][0] = pj.n_pad  # strag_src: past the padded rows
    with pytest.raises(ValueError, match=r"\[0, Npad="):
        interop.window_plan_from_numpy(*bad, W=384, device="cpu")
    bad = [a.copy() for a in arrays]
    bad[6][1] += 4  # strag_off: not 8-aligned
    with pytest.raises(ValueError, match="8-aligned"):
        interop.window_plan_from_numpy(*bad, W=384, device="cpu")
    with pytest.raises(ValueError, match="too short"):
        interop.window_plan_from_numpy(*arrays, W=384, s_max=4096, device="cpu")
    # K4 lists a row's live slots in K places: more over a row's windows is
    # refused, not cut short (the builders keep at most K)
    assert (arrays[2] != 0).sum(axis=(0, 2)).max() <= 6
    bad = [a.copy() for a in arrays]
    bad[2][:, 5, :] = 0.05  # wnl: row 5 live in every slot of all 3 windows
    with pytest.raises(ValueError, match="more than K=6 live slots"):
        interop.window_plan_from_numpy(*bad, W=384, device="cpu")
