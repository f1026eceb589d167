"""The whole run on the CPU at a tiny size, the look for a card skipped:
correct with the program as it is, and not correct with its timed path
broken underneath in each way the cells can break.  (One card a cell: no
exchange between chips to leave out.)"""

import pytest
import torch

import oscillink_tpu_torch.core.lattice as L
from oscillink_tpu_torch.ops.receipts import coherence_drop

from tiny import cell, run

CELLS = ["trec_covid.rerank", "trec_covid.gate", "rag_svc.bundle"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    rc, res, err = run(cell(name))
    assert rc == 0, err
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert {"setup_s", "qps"} <= set(res["metrics"])
    assert ("p90_ms" in res["metrics"]) == (name == "trec_covid.rerank")


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_the_cells_per_layer_metrics(name):
    """Every per-layer metric that a cell lists, except the device trace's,
    which a CPU run has none of, comes out of a traced run."""
    c = cell(name)
    rc, res, err = run(c, trace=True)
    assert rc == 0, err
    assert res["correct"], res["checks"]
    want = {m["name"] for m in c.metrics(True) if m["source"] != "device_trace"}
    assert want <= set(res["metrics"]), res["metrics"]
    assert all(res["metrics"][m]["value"] > 0 for m in want)


def stuck_ustar(monkeypatch):
    """The U* solve returns its start (Y) unchanged."""
    def stuck(g, pg, Y, psi, B, lam, tol=1e-4, max_iters=64, x0=None):
        return (Y if x0 is None else x0).clone(), 1, 0.0

    monkeypatch.setattr(L, "solve_stationary", stuck)


def stuck_settle(monkeypatch):
    """A settle returns U unchanged."""
    monkeypatch.setattr(L, "settle_step", lambda g, pg, U, *a, **k: (U, 1, 0.0))


def state_not_carried(monkeypatch):
    """``bundle`` leaves U* where the carried U was: every later settle
    starts from the wrong state, each one sound on its own."""
    orig = L.OscillinkLattice.bundle

    def replaced(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        self._U_dev = self._Ustar_cache_dev.clone()
        return out

    monkeypatch.setattr(L.OscillinkLattice, "bundle", replaced)


def altered_answer(monkeypatch):
    """The bundle's last id is changed where it is produced."""
    orig = L.OscillinkLattice.bundle

    def altered(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        out[-1] = {**out[-1], "id": (out[-1]["id"] + self.N // 2) % self.N}
        return out

    monkeypatch.setattr(L.OscillinkLattice, "bundle", altered)


def half_the_rows(monkeypatch):
    """The bundle score's z takes the mean and deviation over half the rows."""
    def half(g, Y, Ustar, psi, lamC, alpha):
        u = Ustar / (torch.linalg.vector_norm(Ustar, dim=1, keepdim=True) + 1e-12)
        align = u @ (psi / (torch.linalg.vector_norm(psi) + 1e-12))
        coh = coherence_drop(g, Y, Ustar, lamC)
        part = coh[: coh.numel() // 2]
        z = (coh - part.mean()) / (part.std(correction=0) + 1e-12)
        return alpha * z + (1.0 - alpha) * align, align

    monkeypatch.setattr(L, "bundle_scores", half)


@pytest.mark.parametrize("name, fault", [
    (name, fault) for name in CELLS
    for fault in (stuck_ustar, altered_answer, half_the_rows)] + [
    ("trec_covid.gate", stuck_settle), ("trec_covid.gate", state_not_carried)])
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    c = cell(name)
    fault(monkeypatch)
    rc, res, err = run(c)
    assert rc == 0, err
    assert not res["correct"], res["checks"]
