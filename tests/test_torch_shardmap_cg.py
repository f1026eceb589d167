"""The all-gather tier (`parallel.shardmap_cg.shardmap_solve`) and the
mesh it runs on, against the JAX package's on its 8-virtual-device CPU
mesh; and kernel K1's ``src`` form, whose plain version each shard runs
here.

Port against JAX at 8 shards: U within 1e-5 of max|U|, identical
iterations.  Port against the port's single-device solve: the JAX test's
own bar (2e-4, ``tests/test_shardmap_cg.py:30``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oscillink_tpu.models.coherence import EnergyParams as JaxEnergy  # noqa: E402
from oscillink_tpu.ops.graph import build_graph as jax_build_graph  # noqa: E402
from oscillink_tpu.parallel.mesh import lattice_mesh as jax_mesh  # noqa: E402
from oscillink_tpu.parallel.shardmap_cg import _local_lap_matvec, shardmap_solve as jax_solve  # noqa: E402
from oscillink_tpu_torch.interop import energy_from_numpy, graph_from_numpy  # noqa: E402
from oscillink_tpu_torch.models.coherence import solve_stationary  # noqa: E402
from oscillink_tpu_torch.ops.kernels import spmv  # noqa: E402
from oscillink_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from oscillink_tpu_torch.parallel.shardmap_cg import lap_matvec_src, shardmap_solve  # noqa: E402

CPU8 = [torch.device("cpu")] * 8
REL = 1e-5


def _inputs(n, d, k, seed):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, d)).astype(np.float32)
    psi = rng.standard_normal(d).astype(np.float32)
    g = jax.jit(lambda Y: jax_build_graph(Y, k))(jnp.asarray(Y))
    return Y, psi, g


@pytest.mark.parametrize("n,d,k,seed,gates", [(64, 16, 4, 0, False), (512, 24, 6, 1, True),
                                              (2048, 32, 6, 2, False)])
def test_shardmap_solve_matches_jax_and_single_device(n, d, k, seed, gates):
    Y, psi, g = _inputs(n, d, k, seed)
    B = (np.random.default_rng(seed).uniform(0.2, 1.0, n) if gates else np.ones(n)).astype(np.float32)
    Uj, itj, resj = jax_solve(jax_mesh(8), g, jnp.asarray(Y), jnp.asarray(psi), jnp.asarray(B),
                              JaxEnergy.make(1.0, 0.5, 4.0, 0.0), tol=1e-6, max_iters=200)
    gt = graph_from_numpy(*(np.asarray(a) for a in g), device="cpu")
    lam = energy_from_numpy(1.0, 0.5, 4.0, device="cpu")
    U_l, it, res = shardmap_solve(pmesh.lattice_mesh(devices=CPU8), gt, Y, psi, B, lam,
                                  tol=1e-6, max_iters=200)
    assert len(U_l) == 8 and all(u.shape == (n // 8, d) for u in U_l)
    U = pmesh.gather_rows(U_l).numpy()
    Uj = np.asarray(Uj)
    assert np.abs(U - Uj).max() <= REL * np.abs(Uj).max()
    assert it == int(itj) and res <= 1e-5
    U1, it1, _ = solve_stationary(gt, None, torch.from_numpy(Y), torch.from_numpy(psi),
                                  torch.from_numpy(B), lam, tol=1e-6, max_iters=200)
    np.testing.assert_allclose(U, U1.numpy(), rtol=2e-4, atol=2e-4)
    assert abs(it - it1) <= 1


def test_indivisible_raises():
    Y, psi, g = _inputs(30, 8, 3, 1)
    gt = graph_from_numpy(*(np.asarray(a) for a in g), device="cpu")
    with pytest.raises(ValueError):
        shardmap_solve(pmesh.lattice_mesh(devices=CPU8), gt, Y, psi[:8], np.ones(30, np.float32),
                       energy_from_numpy(1, 0.5, 4, device="cpu"))


def test_mesh_and_collectives():
    m = pmesh.lattice_mesh(devices=CPU8)
    assert m.size == 8 and m.axis_name == "rows"
    assert pmesh.lattice_mesh(3, devices=CPU8).size == 3
    with pytest.raises(ValueError):
        pmesh.lattice_mesh(9, devices=CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pmesh.lattice_mesh()
    parts = [torch.full((2, 3), float(s)) for s in range(8)]
    full = pmesh.all_gather(m, parts)
    assert all(f is full[0] for f in full)  # one tensor per device, not per shard
    assert torch.equal(full[0], torch.cat(parts))
    send = [[torch.tensor([10 * s + d]) for d in range(8)] for s in range(8)]
    recv = pmesh.all_to_all(m, send)
    assert all(int(recv[d][s]) == 10 * s + d for s in range(8) for d in range(8))
    vals = [torch.tensor([1e8]), torch.tensor([1.0]), torch.tensor([-1e8])] + [torch.tensor([0.0])] * 5
    total = pmesh.psum(m, vals)
    assert float(total[0]) == float((torch.tensor([1e8]) + 1.0) - 1e8)  # shard order
    assert all(t is total[0] for t in total)
    assert torch.equal(pmesh.gather_rows(pmesh.split_rows(m, np.arange(16.0))), torch.arange(16.0,
                       dtype=torch.float64))


# -- K1's src form ------------------------------------------------------------


@pytest.mark.parametrize("n_rows,m,d,k", [(64, 512, 24, 6), (100, 37, 9, 5), (8, 8, 4, 1)])
def test_k1_src_plain_version_matches_jax_shard_matvec(n_rows, m, d, k):
    """``lap_matvec_ref(idx, wn, X, src=S)`` is the JAX all-gather tier's
    per-shard matvec on the same inputs (bit for bit: the same slot order),
    and with ``src=X`` it is the one-source form bit for bit."""
    rng = np.random.default_rng(n_rows + m)
    idx = rng.integers(0, m, size=(n_rows, k)).astype(np.int32)
    wn = rng.uniform(-1, 1, size=(n_rows, k)).astype(np.float32)
    S = rng.standard_normal((m, d)).astype(np.float32)
    X = rng.standard_normal((n_rows, d)).astype(np.float32)
    ours = spmv.lap_matvec_ref(torch.from_numpy(idx), torch.from_numpy(wn), torch.from_numpy(X),
                               src=torch.from_numpy(S))
    ref = np.asarray(_local_lap_matvec(jnp.asarray(idx), jnp.asarray(wn), jnp.asarray(S),
                                       jnp.asarray(X)))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    own = rng.integers(0, n_rows, size=(n_rows, k)).astype(np.int32)
    a = spmv.lap_matvec_ref(torch.from_numpy(own), torch.from_numpy(wn), torch.from_numpy(X))
    b = spmv.lap_matvec_ref(torch.from_numpy(own), torch.from_numpy(wn), torch.from_numpy(X),
                            src=torch.from_numpy(X))
    assert torch.equal(a, b)


def test_k1_src_slab_plan_is_sized_by_the_source():
    l2 = 50 * 2**20
    # a 250000-row shard against a 1M-row source: the source does not fit
    assert spmv.slab_plan(250000, 768, 8, l2, src_rows=1_000_000) == spmv.SLAB_COLS
    # a small shard against a small halo frame fits whole
    assert spmv.slab_plan(4096, 128, 8, l2, src_rows=2048) == 128
    # the same shard against a large source slabs
    assert spmv.slab_plan(4096, 128, 8, l2, src_rows=200_000) == spmv.SLAB_COLS
    assert spmv.slab_plan(4096, 128, 8, l2) == spmv.slab_plan(4096, 128, 8, l2, src_rows=4096)


def test_k1_src_wrapper_refuses_cpu_tensors_and_bad_sources():
    idx = torch.zeros((4, 2), dtype=torch.int32)
    wn = torch.zeros((4, 2))
    X = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        spmv.lap_matvec_cuda(idx, wn, X, src=torch.zeros((9, 8)))
    out = lap_matvec_src(idx, wn, X, torch.ones((9, 8)))
    assert torch.equal(out, X)
