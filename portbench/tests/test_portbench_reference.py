"""The plain reference agrees with the port on the CPU at a tiny size: the
graph in both similarity modes, the settle, U*, dH, the null points and
the bundle.  Only these tests call the port from the reference's side."""

import numpy as np
import pytest
import torch

from portbench import data
from portbench import reference as ref

N, D, K = 1500, 64, 8
LAM = ref.Lam(1.0, 0.5, 4.0)


@pytest.fixture(scope="module")
def inputs():
    corpus = {"n": N, "d": D, "centres": 32, "spread": 0.35, "topics": 5, "query_noise": 0.35}
    cpu = torch.device("cpu")
    Y, C = data.study_corpus(corpus, 11, cpu)
    topics = data.pool_topics(corpus, 11, cpu)
    q = data.Queries(C, topics, 0.35, 11, "queries")
    return Y, [torch.as_tensor(q[i]) for i in range(2)]


def port(Y, similarity):
    from oscillink_tpu_torch import OscillinkLattice

    return OscillinkLattice(Y.numpy(), kneighbors=K, similarity=similarity, device="cpu")


def canon(idx, w):
    i = torch.where(w > 0, idx.long(), 10**9)
    i, p = torch.sort(i, dim=1)
    return i, torch.gather(w, 1, p)


@pytest.mark.parametrize("similarity", ["exact", "fast"])
def test_graph(inputs, similarity):
    Y, _ = inputs
    g = ref.build_graph(Y, K, similarity)
    lat = port(Y, similarity)
    pi, pw = canon(lat.graph.idx, lat.graph.w)
    ri, rw = canon(g.idx, g.w)
    assert torch.equal(pi, ri)
    torch.testing.assert_close(pw, rw, rtol=0, atol=1e-6)
    torch.testing.assert_close(lat.graph.sqrt_deg, g.sqrt_deg, rtol=1e-6, atol=0)


def test_auto_resolves_by_rows():
    assert ref.resolve_similarity(65536, "auto") == "exact"
    assert ref.resolve_similarity(65537, "auto") == "fast"


def test_settle_ustar_receipt_and_bundle(inputs):
    Y, psis = inputs
    g = ref.build_graph(Y, K, "fast")
    lat = port(Y, "fast")
    U = Y
    for psi in psis:  # U carries over, as in the gating cell
        lat.set_query(psi.numpy())
        lat.settle(dt=1.0, max_iters=12, tol=1e-3)
        rec = lat.receipt()
        bundle = lat.bundle(k=8, alpha=0.5)
        U = ref.settle(g, U, Y, psi, LAM)
        Us = ref.ustar(g, Y, psi, LAM)
        torch.testing.assert_close(lat._U_dev, U, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(lat._Ustar_cache_dev, Us, rtol=1e-5, atol=1e-5)
        assert rec["deltaH_total"] == pytest.approx(ref.delta_h(g, U, Us, LAM), rel=1e-4)
        flag, j = ref.null_points(g, Us, LAM)
        got = {tuple(p["edge"]) for p in rec["null_points"]}
        rows = flag.nonzero()[:, 0]
        assert got == set(zip(rows.tolist(), j[rows].tolist()))
        score, align = ref.bundle_scores(g, Y, Us, psi, LAM)
        picks = ref.mmr(ref.normalize(Y), score, 8)
        assert [b["id"] for b in bundle] == picks
        np.testing.assert_allclose([b["score"] for b in bundle], score[picks].numpy(),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose([b["align"] for b in bundle], align[picks].numpy(),
                                   rtol=0, atol=1e-5)
        assert max(ref.mmr_gaps(ref.normalize(Y), score, picks)) == 0.0


def test_mmr_gaps_of_a_bad_answer(inputs):
    Y, psis = inputs
    g = ref.build_graph(Y, K, "exact")
    Us = ref.ustar(g, Y, psis[0], LAM)
    score, _ = ref.bundle_scores(g, Y, Us, psis[0], LAM)
    Yn = ref.normalize(Y)
    picks = ref.mmr(Yn, score, 8)
    worst = int(torch.argmin(score))
    assert ref.mmr_gaps(Yn, score, picks[:3] + [worst])[-1] > 0.5
    assert ref.mmr_gaps(Yn, score, picks[:3] + [picks[1]])[-1] == float("inf")
    assert ref.mmr_gaps(Yn, score, [N + 5])[0] == float("inf")


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11 + 2**-13, 1.0 + 2**-12, -3.0])
    assert ref._tf32(x).tolist() == [1.0 + 2**-10, 1.0 + 2**-10, 1.0, -3.0]
