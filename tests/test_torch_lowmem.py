"""The port's low-memory CG, its donated settle and its two working-set
models, against the port's classic forms and the JAX package
(tests/test_lowmem_solve.py's checks).

`cg_solve_lowmem` must stop after the same number of iterations as the
port's `cg_solve`, with x within rtol 1e-6 / atol 1e-7, and within 1e-5 of
the JAX `cg_solve_lowmem`.  The models' ``OSCILLINK_COL_CHUNKS`` override
behaves as the JAX lattice's; their automatic branch is the port's own
model of the card, evaluated here at an 80 GB capacity.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import oscillink_tpu as ot  # noqa: E402
import oscillink_tpu_torch as pt  # noqa: E402
from oscillink_tpu.ops.graph import build_graph as jbuild_graph  # noqa: E402
from oscillink_tpu.ops.solver import cg_solve_lowmem as jcg_solve_lowmem  # noqa: E402
from oscillink_tpu_torch import interop  # noqa: E402
from oscillink_tpu_torch.core import lattice as tlat  # noqa: E402
from oscillink_tpu_torch.models import coherence as tcoh  # noqa: E402
from oscillink_tpu_torch.ops import solver as tsolver  # noqa: E402
from oscillink_tpu_torch.ops.path import build_path_graph  # noqa: E402

CAPACITY_80GB = 80 * 10**9


def _spd(n=40, d=6, seed=11):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)).astype(np.float32)
    A = A @ A.T + n * np.eye(n, dtype=np.float32)
    b = rng.standard_normal((n, d)).astype(np.float32)
    return A, b


@pytest.mark.parametrize("jacobi", [False, True])
@pytest.mark.parametrize("tol,max_iters", [(1e-5, 50), (1e-2, 3)])
def test_cg_solve_lowmem_matches_classic_and_jax(jacobi, tol, max_iters):
    A, b = _spd()
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    M = torch.from_numpy(np.diag(A).copy()) if jacobi else None
    x1, it1, r1 = tsolver.cg_solve(lambda X: At @ X, bt, M_diag=M, tol=tol, max_iters=max_iters)
    x2, it2, r2 = tsolver.cg_solve_lowmem(lambda X: At @ X, bt.clone(), M_diag=M, tol=tol,
                                          max_iters=max_iters)
    assert it1 == it2
    np.testing.assert_allclose(x2.numpy(), x1.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(r2, r1, rtol=1e-4)
    Aj = jnp.asarray(A)
    xj, itj, _ = jcg_solve_lowmem(lambda X: Aj @ X, jnp.asarray(b),
                                  M_diag=None if M is None else jnp.asarray(np.diag(A)),
                                  tol=tol, max_iters=max_iters)
    assert it2 == int(itj)
    np.testing.assert_allclose(x2.numpy(), np.asarray(xj), rtol=1e-5, atol=1e-5)


def test_cg_solve_lowmem_row_blocks_and_overwrites(monkeypatch):
    """Row blocks smaller than b (a ragged last block) change no iterate
    beyond rounding; overwrite_x0 and overwrite_b use the callers' buffers."""
    A, b = _spd(n=61, d=5, seed=3)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    M = torch.from_numpy(np.diag(A).copy())
    x1, it1, _ = tsolver.cg_solve(lambda X: At @ X, bt, M_diag=M, tol=1e-6, max_iters=80)
    monkeypatch.setattr(tsolver, "ROW_BLOCK_BYTES", 7 * 5 * 4)
    assert len(tsolver.row_blocks(61, 5)) == 9
    x0 = torch.zeros_like(bt)
    b2 = bt.clone()
    x2, it2, _ = tsolver.cg_solve_lowmem(lambda X: At @ X, b2, x0=x0, M_diag=M, tol=1e-6,
                                         max_iters=80, overwrite_x0=True, overwrite_b=True)
    assert it2 == it1
    assert x2.data_ptr() == x0.data_ptr()
    assert not torch.equal(b2, bt)  # the residual lived in b's buffer
    np.testing.assert_allclose(x2.numpy(), x1.numpy(), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="overwrite_x0"):
        tsolver.cg_solve_lowmem(lambda X: At @ X, bt, x0=x0.T, overwrite_x0=True)


def test_cg_solve_lowmem_one_d_and_min_one_iter():
    A = torch.eye(5) * 2.0
    x, it, res = tsolver.cg_solve_lowmem(lambda v: A @ v, torch.ones(5), tol=1e30, max_iters=10)
    assert x.shape == (5,)
    assert it == 1  # the reference contract: always >= 1 iteration
    np.testing.assert_allclose(x.numpy(), 0.5 * np.ones(5), rtol=1e-6)


def test_pick_cg_gate():
    assert tcoh._pick_cg(torch.zeros((64, 16))) is tsolver.cg_solve

    class _B:  # duck-typed: only shape and dtype.itemsize are read
        shape = (1_000_000, 768)
        dtype = np.dtype(np.float32)

    big = tcoh.LOWMEM_SOLVE_BYTES // 4 // 768 + 1
    _B.shape = (big, 768)
    assert tcoh._pick_cg(_B()) is tsolver.cg_solve_lowmem
    _B.shape = (big - 1, 768)
    assert tcoh._pick_cg(_B()) is tsolver.cg_solve


def _state(n=300, d=24, k=6, seed=0):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, d)).astype(np.float32)
    U = (Y + 0.3 * rng.standard_normal((n, d))).astype(np.float32)
    psi = rng.standard_normal(d).astype(np.float32)
    B = (0.5 + rng.random(n)).astype(np.float32)
    gj = jax.jit(lambda Y: jbuild_graph(Y, k))(jnp.asarray(Y))
    g = interop.graph_from_numpy(*(np.asarray(a) for a in (gj.idx, gj.w, gj.wn, gj.sqrt_deg)),
                                 device="cpu")
    lam = interop.energy_from_numpy(1.0, 0.5, 4.0, 0.2, device="cpu")
    return g, lam, *(torch.from_numpy(a) for a in (Y, U, psi, B))


@pytest.mark.parametrize("chain", [None, [2, 5, 7, 9, 5], [3, 3]])
def test_lowmem_route_matches_classic(monkeypatch, chain):
    """Above LOWMEM_SOLVE_BYTES the stationary solve and the settle take the
    low-memory CG with the in-place operator and right-hand side: the same
    iterations and U as the classic route, chain prior included (a chain of
    one self-edge too)."""
    g, lam, Y, U, psi, B = _state()
    pg = None if chain is None else build_path_graph(Y.shape[0], chain, device="cpu")
    ref_s = tcoh.solve_stationary(g, pg, Y, psi, B, lam, tol=1e-6, max_iters=200)
    ref_t = tcoh.settle_step(g, pg, U, Y, psi, B, lam, dt=0.5, tol=1e-6, max_iters=40)
    monkeypatch.setattr(tcoh, "LOWMEM_SOLVE_BYTES", 0)
    for rows, rtol, atol in ((300, 1e-6, 1e-7), (64, 0.0, 1e-6)):
        # one row block: the classic reductions' order, the cg_solve bar; five
        # blocks: another summation order, held as the card's bar (1e-6 of
        # max|U|)
        monkeypatch.setattr(tsolver, "ROW_BLOCK_BYTES", rows * 24 * 4)
        got_s = tcoh.solve_stationary(g, pg, Y, psi, B, lam, tol=1e-6, max_iters=200)
        got_t = tcoh.settle_step(g, pg, U, Y, psi, B, lam, dt=0.5, tol=1e-6, max_iters=40)
        for got, ref in ((got_s, ref_s), (got_t, ref_t)):
            assert got[1] == ref[1]
            np.testing.assert_allclose(got[0].numpy(), ref[0].numpy(), rtol=rtol,
                                       atol=max(atol * float(ref[0].abs().max()), 1e-7))
    # the in-place operator is the classic one's arithmetic
    X = U * 1.5
    np.testing.assert_array_equal(tcoh._apply_inplace(g, pg, lam, B, X).numpy(),
                                  tcoh.stationary_matvec(g, pg, lam, B, X).numpy())
    np.testing.assert_array_equal(
        tcoh._apply_inplace(g, pg, lam, B, X, 0.5).numpy(),
        (X + 0.5 * tcoh.stationary_matvec(g, pg, lam, B, X)).numpy())


@pytest.mark.parametrize("x0_kind", ["none", "U", "Y"])
def test_donated_settle_matches_plain(monkeypatch, x0_kind):
    """The donated settle (`settle_step(donate_u=True)` on the low-memory
    route) is the plain settle with U's buffer consumed: the same iterations
    and U+ (x0 None or U starts from U; another x0 is copied into U's buffer
    after the right-hand side is built).  The classic route leaves U as it
    was."""
    g, lam, Y, U, psi, B = _state(seed=7)
    x0 = {"none": None, "U": U, "Y": Y}[x0_kind]
    ref, it_ref, res_ref = tcoh.settle_step(g, None, U, Y, psi, B, lam, dt=1.0, tol=1e-3,
                                            max_iters=12, x0=U if x0 is None else x0)
    Uc = U.clone()
    out, it, _ = tcoh.settle_step(g, None, Uc, Y, psi, B, lam, dt=1.0, tol=1e-3, max_iters=12,
                                  x0=Uc if x0_kind == "U" else x0, donate_u=True)
    assert out.data_ptr() != Uc.data_ptr() and torch.equal(Uc, U)
    assert it == it_ref and torch.equal(out, ref)
    monkeypatch.setattr(tcoh, "LOWMEM_SOLVE_BYTES", 0)
    Ud = U.clone()
    out, it, res = tcoh.settle_step(g, None, Ud, Y, psi, B, lam, dt=1.0, tol=1e-3, max_iters=12,
                                    x0=Ud if x0_kind == "U" else x0, donate_u=True)
    assert out.data_ptr() == Ud.data_ptr()
    assert it == it_ref
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-6, atol=1e-7)


def test_lattice_settles_in_place_above_the_lowmem_bytes(monkeypatch):
    """Above LOWMEM_SOLVE_BYTES the lattice's second settle (U no longer Y,
    no dynamics) writes into U's buffer; with dynamics it does not.  Both
    agree with the JAX lattice."""
    rng = np.random.default_rng(4)
    Y = rng.standard_normal((200, 32)).astype(np.float32)
    psi = rng.standard_normal(32).astype(np.float32)
    lj = ot.Oscillink(Y, kneighbors=5)
    lj.set_query(psi)
    for _ in range(2):
        sj = lj.settle(max_iters=12, tol=1e-4)
    monkeypatch.setattr(tcoh, "LOWMEM_SOLVE_BYTES", 0)
    for dynamics in ("0", "1"):
        monkeypatch.setenv("OSCILLINK_RECEIPT_DYNAMICS", dynamics)
        lt = pt.Oscillink(Y, kneighbors=5, device="cpu")
        lt.set_query(psi)
        lt.settle(max_iters=12, tol=1e-4)
        buf = lt._U_dev.data_ptr()
        st = lt.settle(max_iters=12, tol=1e-4)
        assert (lt._U_dev.data_ptr() == buf) == (dynamics == "0")
        assert st["iters"] == int(sj["iters"])
        np.testing.assert_allclose(lt.U, lj.U, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("raw,want", [("4", 4), ("0", 1), ("5", 1), ("x", 1), ("1", 1)])
def test_col_chunk_env_override_matches_jax(monkeypatch, raw, want):
    Y = np.random.default_rng(0).standard_normal((32, 8)).astype(np.float32)
    monkeypatch.setenv("OSCILLINK_COL_CHUNKS", raw)
    lj = ot.Oscillink(Y, kneighbors=4)
    lt = pt.Oscillink(Y, kneighbors=4, device="cpu")
    got = (lt._auto_col_chunks(), lt._auto_col_chunks_gather(1), lt._auto_col_chunks_gather(2))
    assert got == (lj._auto_col_chunks(), lj._auto_col_chunks_gather(1),
                   lj._auto_col_chunks_gather(2)) == (want, want, want)
    # the override holds whatever the capacity
    assert lt._auto_col_chunks(capacity=1) == want
    assert lt._auto_col_chunks_gather(2, capacity=1) == want


def test_automatic_branch_is_one_off_the_card(monkeypatch):
    monkeypatch.delenv("OSCILLINK_COL_CHUNKS", raising=False)
    Y = np.random.default_rng(0).standard_normal((32, 8)).astype(np.float32)
    lt = pt.Oscillink(Y, kneighbors=4, device="cpu")
    lt.N, lt.D, lt._kneighbors = 4_000_000, 768, 8
    assert lt._auto_col_chunks() == 1 and lt._auto_col_chunks_gather(2) == 1


@pytest.mark.parametrize("n,gather2,gather3,receipt,windowed", [
    # 1M x 768 (3.07 GB blocks) runs full width on an 80 GB card
    (1_000_000, 1, 1, 1, 1),
    # 4M x 768 (12.3 GB blocks): the low-memory CG fits beside Y and U,
    # not beside the U* cache too (the classic chunks then need c = 8); the
    # receipt needs c = 2, the windowed solves c = 8
    (4_000_000, 1, 8, 2, 8),
])
def test_automatic_branch_at_80gb(monkeypatch, n, gather2, gather3, receipt, windowed):
    """The port's model of the card (coefficients read on an H100) at an
    80 GB capacity, through the lattice's methods with the capacity given."""
    monkeypatch.delenv("OSCILLINK_COL_CHUNKS", raising=False)
    Y = np.random.default_rng(0).standard_normal((32, 8)).astype(np.float32)
    lt = pt.Oscillink(Y, kneighbors=4, device="cpu")
    lt.N, lt.D, lt._kneighbors = n, 768, 8
    assert lt._auto_col_chunks_gather(2, capacity=CAPACITY_80GB) == gather2
    assert lt._auto_col_chunks_gather(3, capacity=CAPACITY_80GB) == gather3
    assert lt._auto_col_chunks(capacity=CAPACITY_80GB) == receipt
    assert tlat.auto_col_chunks(n, 768, 8, CAPACITY_80GB,
                                [("receipt", 3), ("windowed", 2)]) == windowed


def test_lowmem_bytes_where_the_classic_form_leaves_the_card():
    """LOWMEM_SOLVE_BYTES sits where the classic settle with the most the
    lattice holds (Y, U and the U* cache) stops fitting the H100's
    total_memory (85,017,493,504 bytes as CUDA reports it) less the
    headroom: it fits at the threshold and not 1 % above."""
    budget = 85_017_493_504 - tlat._HEADROOM_BYTES
    rows = tsolver.LOWMEM_SOLVE_BYTES // (4 * 768)
    saved = tcoh.LOWMEM_SOLVE_BYTES
    try:
        tcoh.LOWMEM_SOLVE_BYTES = 1 << 62  # the classic form's estimate at every size
        assert tlat.working_set_bytes(rows, 768, 8, "settle", 3) <= budget
        assert tlat.working_set_bytes(int(rows * 1.01), 768, 8, "settle", 3) > budget
    finally:
        tcoh.LOWMEM_SOLVE_BYTES = saved


def test_working_set_model_terms():
    """The model's terms: resident blocks, the form `_pick_cg` gives the
    chunk width, a solve's accumulator, and the receipt's edge-distance
    scratch (the kernel's output and its 24 slabs' partials at D = 768)."""
    n, d, k = 1_000_000, 768, 8
    block = n * d * 4
    base = 3 * block + n * (12 * k + 4) + tlat._SMALL_BYTES
    assert tlat.working_set_bytes(n, d, k, "ustar", 3) == base + 10.1 * block
    assert tlat.working_set_bytes(n, d, k, "ustar", 3, 4) == base + block + 12.1 * block / 4
    assert tlat.working_set_bytes(n, d, k, "receipt", 3, 8) == base + 4.1 * block / 8
    lowmem = tlat.working_set_bytes(3_000_000, d, k, "settle", 2, donated=True)
    block3 = 3_000_000 * d * 4
    assert lowmem == (2 * block3 + 3_000_000 * 100 + tlat._SMALL_BYTES
                      + 2 * tsolver.ROW_BLOCK_BYTES + 3.1 * block3)
    # the edge distances' scratch, 25 [N, K] f32 blocks, stays below the
    # receipt's live blocks at small N; at c = 16 it passes one chunk's 4.1
    assert tlat.working_set_bytes(4096, d, k, "receipt", 3) == (
        3 * 4096 * d * 4 + 4096 * 100 + tlat._SMALL_BYTES + 4.1 * 4096 * d * 4)
    assert tlat.working_set_bytes(n, d, k, "receipt", 3, 16) == base + 25 * 4 * n * k


@pytest.mark.parametrize("route,donated,live", [
    ("settle", False, 4.1), ("ustar", False, 4.1), ("settle", True, 3.1),
])
def test_working_set_with_the_form_forced(route, donated, live):
    """With the CG form given, the estimate is that form's whatever
    `_pick_cg` would take at the width: at 1M x 768 (the classic form's
    size on the card) "lowmem" gives the low-memory live blocks and their
    row-block temporaries, "classic" the classic 10.1 blocks above
    LOWMEM_SOLVE_BYTES; an unknown form raises."""
    n, d, k = 1_000_000, 768, 8
    block = n * d * 4
    assert not tlat._lowmem_form(n, d)
    base = 3 * block + n * (12 * k + 4) + tlat._SMALL_BYTES
    got = tlat.working_set_bytes(n, d, k, route, 3, donated=donated, form="lowmem")
    assert got == base + 2 * tsolver.ROW_BLOCK_BYTES + live * block
    assert tlat.working_set_bytes(n, d, k, route, 3, donated=donated) == base + 10.1 * block
    n4 = 4_000_000
    block4 = n4 * d * 4
    assert tlat._lowmem_form(n4, d)
    assert tlat.working_set_bytes(n4, d, k, route, 3, donated=donated, form="classic") == (
        3 * block4 + n4 * (12 * k + 4) + tlat._SMALL_BYTES + 10.1 * block4)
    with pytest.raises(ValueError, match="unknown CG form"):
        tlat.working_set_bytes(n, d, k, route, 3, form="fast")
