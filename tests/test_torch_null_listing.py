"""The receipt's null-point listing (`native/listing.py`): the native builder
and its Python stand-in against the comprehension the lattice used before,
value for value and type for type, and the lattice's two branches (full and
capped) against that comprehension's listing."""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import oscillink_tpu_torch as pt  # noqa: E402
from oscillink_tpu_torch.native import listing  # noqa: E402
from oscillink_tpu_torch.ops.graph import stable_topk  # noqa: E402
from oscillink_tpu_torch.ops.kernels import build as kbuild  # noqa: E402
from oscillink_tpu_torch.ops.receipts import null_points_sparse  # noqa: E402


@pytest.fixture()
def native():
    if listing._builder() is None:
        pytest.skip("the native listing does not build here (no compiler or no Python.h)")


def _comprehension(i, j, z, r):
    """The lattice's listing before the native builder."""
    rows = zip(i.tolist(), j.tolist(), z.tolist(), r.tolist())
    return [{"edge": [int(a), int(b)], "z": float(c), "residual": float(d)} for a, b, c, d in rows]


def _case(name):
    rng = np.random.default_rng(5)
    n = 70000 if name == "wide_index" else 64
    j = torch.from_numpy(rng.integers(0, n, n).astype(np.int32))
    z = torch.from_numpy((3.0 + rng.random(n)).astype(np.float32))
    r = torch.from_numpy(rng.random(n).astype(np.float32))
    flag = torch.ones(n, dtype=torch.bool)
    if name == "none":
        flag[:] = False
    elif name == "one":
        flag[:] = False
        flag[37] = True
    elif name == "wide_index":
        flag[:] = False
        flag[[0, 65535, 65536, 65537, n - 1]] = True
        j[n - 1] = 2**31 - 1
    elif name == "inexact":
        # none of these is a short decimal: each double differs from the
        # float32's printed value
        vals = [0.1, 1 / 3, 2 / 3, 1e-8, 3.4e38, 1e-45, 7.1, 12345.679, float("inf")]
        z[: len(vals)] = torch.tensor(vals, dtype=torch.float32)
        r[: len(vals)] = torch.tensor(vals[::-1], dtype=torch.float32)
    return flag, j, z, r


def _assert_types(nulls):
    assert type(nulls) is list
    for e in nulls:
        assert type(e) is dict and list(e) == ["edge", "z", "residual"]
        assert type(e["edge"]) is list and len(e["edge"]) == 2
        assert all(type(v) is int for v in e["edge"])
        assert type(e["z"]) is float and type(e["residual"]) is float


@pytest.mark.parametrize("path", ["native", "python"])
@pytest.mark.parametrize("case", ["all", "none", "one", "wide_index", "inexact"])
def test_listing_matches_comprehension(native, case, path):
    flag, j, z, r = _case(case)
    i = torch.arange(flag.shape[0])
    sel = flag.nonzero()[:, 0]
    want = _comprehension(i[sel], j[sel], z[sel], r[sel])
    rows = listing.pack_null_rows(i, j, z, r)[flag]
    if path == "native":
        got, built_native = listing.list_null_points(rows)
        assert built_native
    else:
        got = listing._python_listing(rows.numpy())
    assert got == want and len(got) == int(flag.sum())
    _assert_types(got)


def test_native_listing_holds_one_reference(native):
    flag, j, z, r = _case("all")
    i = torch.arange(64)
    got, _ = listing.list_null_points(listing.pack_null_rows(i, j, z, r))
    want = _comprehension(i, j, z, r)
    # as many references as the comprehension's objects hold: none leaked
    assert sys.getrefcount(got) == sys.getrefcount(want)
    assert sys.getrefcount(got[3]) == sys.getrefcount(want[3])
    assert sys.getrefcount(got[3]["edge"]) == sys.getrefcount(want[3]["edge"])


@pytest.mark.parametrize(
    "rows",
    [torch.zeros((3, 4), dtype=torch.int64), torch.zeros((3, 3), dtype=torch.int32),
     torch.zeros(12, dtype=torch.int32)],
)
def test_listing_refuses_other_buffers(rows):
    with pytest.raises(ValueError):
        listing.list_null_points(rows)


def _lattice(n=300, d=24, seed=9):
    # ten tight clusters: some rows end with no positive residual, so not
    # every row is flagged
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((10, d))
    Y = (centres[rng.integers(0, 10, n)] + 0.1 * rng.standard_normal((n, d))).astype(np.float32)
    psi = rng.standard_normal(d).astype(np.float32)
    lat = pt.Oscillink(Y, kneighbors=5, device="cpu")
    lat.set_query(psi)
    lat.settle(max_iters=10, tol=1e-3)
    return lat


def _previous_null_points(lat, Ustar, cap):
    """`OscillinkLattice._null_points` as it listed before the native builder."""
    nflag, nj, nz, nr = null_points_sparse(lat._graph, Ustar, lat._lam().lamC, z_th=3.0)
    if cap is not None:
        n_flagged = int(nflag.sum())
        score = torch.where(nflag, nz, -torch.inf)
        top_z, top_i = stable_topk(score[None, :], cap)
        top_i = top_i[0]
        rows = zip(top_i.tolist(), nj[top_i].tolist(), top_z[0].tolist(), nr[top_i].tolist())
        nulls = [
            {"edge": [int(i), int(j)], "z": float(z), "residual": float(r)}
            for i, j, z, r in rows
            if np.isfinite(z)
        ]
        return nulls, n_flagged
    rows_i = nflag.nonzero()[:, 0]
    return _comprehension(rows_i, nj[rows_i], nz[rows_i], nr[rows_i]), len(rows_i)


@pytest.mark.parametrize("cap", [None, 3, "above_flagged"])
def test_lattice_branches_list_as_before(monkeypatch, cap):
    lat = _lattice()
    Ustar = lat._solve_ustar_device()
    n_flagged = int(null_points_sparse(lat._graph, Ustar, lat._lam().lamC)[0].sum())
    assert 3 < n_flagged < lat.N - 1  # both capped cases bind as named
    if cap == "above_flagged":
        cap = n_flagged + 1  # the top-k then holds -inf rows, which are dropped
    monkeypatch.delenv("OSCILLINK_RECEIPT_NULL_CAP", raising=False)
    if cap is not None:
        monkeypatch.setenv("OSCILLINK_RECEIPT_NULL_CAP", str(cap))
    want, want_flagged = _previous_null_points(lat, Ustar, cap)
    got, meta = lat._null_points(Ustar)
    assert got == want
    _assert_types(got)
    assert meta == {
        "total_null_points": want_flagged,
        "returned_null_points": len(want),
        "null_cap_applied": want_flagged > len(want),
    }


def test_receipt_counts_native_listings(native):
    lat = _lattice()
    rec = lat.receipt()
    lat.receipt()
    assert lat.stats["null_listings_native"] == 2 and lat.stats["null_listings_python"] == 0
    assert rec["null_points"] and "null_listings_native" not in rec["meta"]


def test_receipt_lists_in_python_without_a_compiler(monkeypatch, tmp_path):
    lat = _lattice()
    want = lat.receipt()["null_points"]
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path / "build")
    before = dict(lat.stats)
    got = lat.receipt()["null_points"]
    assert got == want and got
    _assert_types(got)
    assert lat.stats["null_listings_python"] == before["null_listings_python"] + 1
    assert lat.stats["null_listings_native"] == before["null_listings_native"]
    assert not any((tmp_path / "build").glob("osclisting_*"))


# -- the native engine's and the mesh route's listings ------------------------


def _engine_comprehension(flag, j, z, r):
    """`NativeEngine.null_points` as it listed before the packed rows."""
    return [
        {"edge": [int(i), int(j[i])], "z": float(z[i]), "residual": float(r[i])}
        for i in range(len(flag))
        if flag[i]
    ]


def _mesh_comprehension(nflag, nj, nz, nr):
    """`parallel.serve.sharded_serve` as it listed before the packed rows."""
    return [
        {"edge": [int(i), int(nj[i])], "z": float(nz[i]), "residual": float(nr[i])}
        for i in np.flatnonzero(nflag)
    ]


def _take_path(monkeypatch, path):
    if path == "native":
        if listing._builder() is None:
            pytest.skip("the native listing does not build here (no compiler or no Python.h)")
    else:
        monkeypatch.setattr(listing, "_builder", lambda: None)


@pytest.mark.parametrize("path", ["native", "python"])
@pytest.mark.parametrize("case", ["all", "none", "one", "wide_index", "inexact"])
@pytest.mark.parametrize("route", ["engine", "mesh"])
def test_flagged_listing_matches_the_routes_comprehensions(monkeypatch, route, case, path):
    """`list_flagged` on each route's own buffers (the engine's numpy uint8
    flags and int32 neighbours; the mesh's gathered bool and int64 tensors)
    against the comprehension that route used."""
    _take_path(monkeypatch, path)
    flag, j, z, r = _case(case)
    if route == "engine":
        args = (flag.numpy().astype(np.uint8), j.numpy(), z.numpy(), r.numpy())
        want = _engine_comprehension(*args)
    else:
        args = (flag, j.to(torch.int64), z, r)
        want = _mesh_comprehension(*(a.numpy() for a in args))
    got = listing.list_flagged(*args)
    assert got == want and len(got) == int(flag.sum())
    _assert_types(got)


@pytest.mark.parametrize("path", ["native", "python"])
@pytest.mark.parametrize("z_th", [3.0, -1e30, 1e30])
def test_engine_null_points_list_as_before(monkeypatch, path, z_th):
    """`NativeEngine.null_points` against its comprehension over the
    engine's raw flags: the default threshold, every row with a positive
    residual, and none."""
    from oscillink_tpu_torch.native import NativeEngine, native_available

    if not native_available():
        pytest.skip("native build unavailable")
    _take_path(monkeypatch, path)
    rng = np.random.default_rng(4)
    Y = rng.standard_normal((90, 12)).astype(np.float32)
    eng = NativeEngine(Y, kneighbors=5)
    eng.set_query(rng.standard_normal(12).astype(np.float32))
    eng.settle()
    Us = np.ascontiguousarray(eng.solve_ustar()[0])
    n = eng.N
    j, z, r = np.zeros(n, np.int32), np.zeros(n, np.float32), np.zeros(n, np.float32)
    flag = np.zeros(n, np.uint8)
    eng._lib.osc_null_points(eng.idx, eng.w, eng.sqrt_deg, Us, n, eng.k, eng.D,
                             np.float32(eng.lamC), np.float32(z_th), j, z, r, flag)
    got = eng.null_points(Us, z_th=z_th)
    assert got == _engine_comprehension(flag, j, z, r)
    assert len(got) == int(flag.sum()) and (len(got) > 0) == (z_th < 1e30)
    _assert_types(got)


@pytest.mark.parametrize("path", ["native", "python"])
def test_mesh_null_points_list_as_before(monkeypatch, path):
    """`sharded_serve`'s null points against its comprehension over the
    gathered flags it listed."""
    from oscillink_tpu_torch.parallel import serve
    from oscillink_tpu_torch.parallel.mesh import lattice_mesh

    _take_path(monkeypatch, path)
    seen = []

    def spy(*args):
        seen.append(args)
        return listing.list_flagged(*args)

    monkeypatch.setattr(serve, "list_flagged", spy)
    lat = _lattice()
    out = serve.sharded_serve(lattice_mesh(devices=[torch.device("cpu")] * 4), lat.Y, lat.psi,
                              k=5)
    (args,) = seen
    want = _mesh_comprehension(*(a.numpy() for a in args))
    assert out["null_points"] == want and 0 < len(want) < lat.N
    _assert_types(out["null_points"])


@pytest.mark.parametrize("cap", ["2", "1000", "0", "junk"])
def test_mesh_receipt_caps_as_before(monkeypatch, cap):
    """The mesh route's receipt under ``OSCILLINK_RECEIPT_NULL_CAP``: the
    uncapped list sorted stably by -z and cut to the cap, when the cap is
    positive and below the count; otherwise the whole list."""
    from oscillink_tpu_torch.service import LocalClient
    from oscillink_tpu_torch.service import config as port_config
    from oscillink_tpu_torch.service.api import create_state

    for var in ("OSCILLINK_API_KEYS", "OSCILLINK_NATIVE_SMALL_N", "OSCILLINK_RECEIPT_NULL_CAP",
                "OSCILLINK_ADAPTIVE_PROFILES"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("OSCILLINK_SHARDED_MIN_N", "64")
    monkeypatch.setenv("OSCILLINK_DISABLE_ST", "1")
    port_config.get_settings.cache_clear()
    client = LocalClient(create_state(device="cpu", mesh=[torch.device("cpu")] * 8))
    rng = np.random.default_rng(9)
    Y = rng.standard_normal((128, 8)).astype(np.float32)
    Y[5] += 25.0
    Y[60] -= 25.0
    p = {"Y": Y.tolist(), "psi": rng.standard_normal(8).astype(np.float32).tolist(),
         "options": {"max_iters": 8, "tol": 1e-3}}
    full = client.post("/v1/receipt", json_body=p).json()["receipt"]
    monkeypatch.setenv("OSCILLINK_RECEIPT_NULL_CAP", cap)
    rec = client.post("/v1/receipt", json_body=p).json()["receipt"]
    port_config.get_settings.cache_clear()
    assert rec["meta"]["backend"] == "sharded"
    nulls, total = full["null_points"], len(full["null_points"])
    applied = cap == "2"
    want = sorted(nulls, key=lambda e: -e["z"])[:2] if applied else nulls
    assert 2 < total < 1000 and rec["null_points"] == want
    assert rec["meta"]["null_points_summary"] == {
        "total_null_points": total,
        "returned_null_points": len(want),
        "null_cap_applied": applied,
    }
