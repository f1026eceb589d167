"""The port's lattice debug report (`utils/debug_report.py`): the JAX
package's report tests (``tests/test_debug_report.py``) on the port's
report, and the port's report held to the JAX package's for the same
lattice: the same KPI values (the graph-build time aside), top-node ids,
null-point rows (as a set: the table is sorted by z, and z-scores equal to
f32 rounding may swap), bundle ids and settle-trace iterations."""

import json
import os
import re
import xml.etree.ElementTree as ET

import numpy as np
import pytest

pytest.importorskip("torch")

import oscillink_tpu as ot  # noqa: E402
from oscillink_tpu.utils.debug_report import generate_debug_report as jax_report  # noqa: E402
from oscillink_tpu_torch import OscillinkLattice  # noqa: E402
from oscillink_tpu_torch.utils.debug_report import generate_debug_report  # noqa: E402


def _clustered():
    rng = np.random.default_rng(0)
    centers = 3.0 * rng.standard_normal((6, 32)).astype(np.float32)
    Y = (centers[rng.integers(0, 6, size=120)] + 0.4 * rng.standard_normal((120, 32))).astype(
        np.float32)
    psi = (centers[0] / np.linalg.norm(centers[0])).astype(np.float32)
    return Y, psi


@pytest.fixture(scope="module")
def report_and_lattice():
    Y, psi = _clustered()
    lat = OscillinkLattice(Y, kneighbors=6, device="cpu")
    lat.set_query(psi)
    return generate_debug_report(lat, settle_steps=4), lat


def _svgs(html_doc):
    return re.findall(r"<svg[^>]*>.*?</svg>", html_doc, flags=re.DOTALL)


def _cards(html_doc):
    """{card title: card html}."""
    out = {}
    for card in html_doc.split('<div class="card">')[1:]:
        title = re.match(r"<h2>(.*?)</h2>", card).group(1)
        out[title] = card
    return out


def _digest(html_doc):
    """What the report shows that must not depend on the package."""
    tiles = dict(re.findall(r'<div class="lbl">(.*?)</div><div class="val">(.*?)</div>', html_doc))
    tiles.pop("graph build")
    cards = _cards(html_doc)

    def rows(title):
        return [re.findall(r"<td>(.*?)</td>", r) for r in re.findall(r"<tr>(.*?)</tr>",
                                                                     cards[title])][1:]

    return {
        "tiles": tiles,
        "sub": re.search(r'<p class="sub">(.*?)</p>', html_doc, re.DOTALL).group(1),
        "top_nodes": re.findall(r">node (\d+)</text>", cards["Top coherence-drop nodes"]),
        # sorted by z, whose last bits differ between packages: rows of
        # near-equal z may swap, so the rows are compared as a set
        "nulls": sorted(rows("Null points")),
        "bundle_ids": [r[0] for r in rows("Bundle (top-k)")],
        "settle_iters": [r[3] for r in rows("Settle trace")],
    }


@pytest.mark.parametrize("n,d,k,seed,chain", [
    (120, 32, 6, None, None),
    (90, 24, 5, 3, [1, 4, 9]),
])
def test_report_matches_the_jax_report(n, d, k, seed, chain):
    if seed is None:
        Y, psi = _clustered()
    else:
        rng = np.random.default_rng(seed)
        Y = rng.standard_normal((n, d)).astype(np.float32)
        psi = Y[:5].mean(0)
    lats = []
    for cls, kw in ((OscillinkLattice, {"device": "cpu"}), (ot.OscillinkLattice, {})):
        lat = cls(Y, kneighbors=k, deterministic_k=True, **kw)
        lat.set_query(psi)
        if chain:
            lat.add_chain(chain, lamP=0.2)
        lats.append(lat)
    ours = _digest(generate_debug_report(lats[0], settle_steps=3))
    theirs = _digest(jax_report(lats[1], settle_steps=3))
    assert ours["top_nodes"] and ours["nulls"] and len(ours["bundle_ids"]) == 8
    assert ours == theirs


def test_report_structure(report_and_lattice):
    html_doc, lat = report_and_lattice
    assert html_doc.startswith("<!DOCTYPE html>")
    assert len(_svgs(html_doc)) == 5  # 2 traces, 2 bar charts, 1 histogram
    assert html_doc.count("<table") == 3  # bundle, settle trace, null points
    rec = lat.receipt()
    assert f"{lat.N} x {lat.D}" in html_doc
    assert str(rec["meta"]["state_sig"]) in html_doc
    assert "http://" not in html_doc and "https://" not in html_doc
    assert "<script src" not in html_doc


def test_svgs_are_wellformed_and_in_bounds(report_and_lattice):
    html_doc, _ = report_and_lattice
    for svg in _svgs(html_doc):
        root = ET.fromstring(svg)
        vb = [float(x) for x in root.attrib["viewBox"].split()]
        w, h = vb[2], vb[3]
        for el in root.iter():
            tag = el.tag.split("}")[-1]
            if tag == "circle":
                assert 0 <= float(el.attrib["cx"]) <= w
                assert 0 <= float(el.attrib["cy"]) <= h
            if tag == "rect":
                assert float(el.attrib.get("width", 0)) >= 0
            if tag == "text":
                assert -1 <= float(el.attrib["x"]) <= w + 1
                assert 0 <= float(el.attrib["y"]) <= h


def test_tooltips_are_valid_json(report_and_lattice):
    html_doc, _ = report_and_lattice
    tips = re.findall(r"data-tip='([^']+)'", html_doc)
    assert tips
    for t in tips:
        assert all(len(r) == 2 for r in json.loads(t))
    lines = re.findall(r"data-line='([^']+)'", html_doc)
    assert len(lines) == 2
    for ln in lines:
        assert all(len(p) == 4 for p in json.loads(ln))


def test_tooltip_js_uses_textcontent_not_innerhtml(report_and_lattice):
    html_doc, _ = report_and_lattice
    assert "innerHTML" not in html_doc
    assert "textContent" in html_doc


def test_report_writes_file(tmp_path, monkeypatch):
    monkeypatch.delenv("OSCILLINK_RECEIPT_DYNAMICS", raising=False)
    rng = np.random.default_rng(1)
    Y = rng.standard_normal((40, 16)).astype(np.float32)
    psi = (Y[:5].mean(0) / (np.linalg.norm(Y[:5].mean(0)) + 1e-12)).astype(np.float32)
    lat = OscillinkLattice(Y, kneighbors=4, device="cpu")
    lat.set_query(psi)
    out = tmp_path / "r.html"
    doc = generate_debug_report(lat, str(out), settle_steps=2, top_nodes=5)
    assert out.read_text() == doc
    assert os.environ.get("OSCILLINK_RECEIPT_DYNAMICS") is None
    monkeypatch.setenv("OSCILLINK_RECEIPT_DYNAMICS", "0")
    generate_debug_report(lat, settle_steps=1)
    assert os.environ["OSCILLINK_RECEIPT_DYNAMICS"] == "0"


def test_cli_settle_debug_report(tmp_path, capsys):
    from oscillink_tpu.cli import main as jax_main
    from oscillink_tpu_torch.cli import main

    yp = tmp_path / "Y.npy"
    np.save(yp, np.random.default_rng(2).standard_normal((40, 12)).astype(np.float32))
    outs = []
    for fn, name, extra in ((main, "port.html", ["--device", "cpu"]), (jax_main, "jax.html", [])):
        out = tmp_path / name
        assert fn(["settle", str(yp), "--kneighbors", "4", "--debug-report", str(out), *extra]) == 0
        outs.append(out.read_text())
    capsys.readouterr()
    assert outs[0].startswith("<!DOCTYPE html>") and "<svg" in outs[0]
    assert _digest(outs[0]) == _digest(outs[1])
