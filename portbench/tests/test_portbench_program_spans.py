"""The program's spans (`oscillink_tpu_torch.utils.profiling`) against the
harness: a gap inside a program span inside a harness span takes the
program span's name when the reduction is given both lists of names, and
an untraced run records no program span."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from oscillink_tpu_torch.utils import profiling
from portbench import run as runmod
from portbench import trace

from tiny import cell, run


def ev(name, s, e, dev=DeviceType.CUDA):
    return SimpleNamespace(name=name, device_type=dev, time_range=SimpleNamespace(start=s, end=e))


def test_a_gap_takes_the_innermost_program_span():
    cpu = DeviceType.CPU
    events = [
        ev(trace.WINDOW, 0, 100, cpu),
        ev("bundle", 0, 100, cpu), ev("ustar", 0, 80, cpu),
        ev("lattice.signature", 5, 35, cpu), ev("lattice.signature", 5, 35),  # and its mirror
        ev("lattice.ustar", 40, 80, cpu), ev("cg.wait", 60, 62, cpu),
        ev("elementwise", 0, 5), ev("elementwise", 35, 60), ev("elementwise", 62, 100),
    ]
    r = trace.reduce_events(events, runmod.SPANS + profiling.SPANS)
    idle = dict(r["idle_gaps"])
    assert idle == pytest.approx({"lattice.signature": 30e-6, "cg.wait": 2e-6})
    assert r["busy_s"] == pytest.approx(68e-6)  # the span's mirror is not device time
    # given the harness's names alone, the reduction takes the span's mirror
    # on the device's timeline for device time
    alone = trace.reduce_events(events, runmod.SPANS)
    assert alone["busy_s"] == pytest.approx(98e-6)
    assert dict(alone["idle_gaps"]) == pytest.approx({"ustar": 2e-6})


def test_an_untraced_run_records_no_program_span(monkeypatch):
    opened = []
    enter = profiling._Open.__enter__

    def counted(self):
        opened.append(self.name)
        return enter(self)

    monkeypatch.setattr(profiling._Open, "__enter__", counted)
    c = cell("trec_covid.rerank", n=1500)
    rc, res, err = run(c, seconds=0.3)
    assert rc == 0 and res["correct"], err
    assert opened == [] and profiling._recorder is None
    # the same run under recording() opens the lattice's spans
    with profiling.recording() as rec:
        rc, res, err = run(cell("trec_covid.rerank", n=1500), seconds=0.3)
    assert rc == 0, err
    assert {"lattice.set_query", "lattice.bundle", "lattice.ustar", "cg.wait"} <= set(opened)
    assert len(rec.spans) == len(opened)
