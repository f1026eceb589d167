"""The batch cell (``systems/lattice_batch.py``) through the whole run on
the CPU at a tiny size: correct and with its end-to-end metrics; the
control (`control_batch.py`, the reference with TF32-rounded matmul
inputs) not correct, and at the configuration's float32 correct."""

import pytest
import torch

from portbench import control_batch, harness

from tiny import SEED, run

NAME = "trec_covid_batch.batch8"


def cell(n: int = 2048) -> harness.Cell:
    c = harness.load_cell(NAME)
    c.config["corpus"].update(n=n, d=64, centres=64)
    c.config["similarity"] = "fast"
    return c


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(trace, capsys):
    rc, res, err = run(cell(), trace=trace)
    assert rc == 0, err
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res["checks"]) == ["graph_rows_differ", "graph_w_err", "ustar_rel_err",
                                   "bundle_gap", "bundle_score_err"]
    want = {"graph.build_s"} if trace else {"qps", "setup_s"}
    assert want <= set(res["metrics"]), res["metrics"]
    assert '"iterations": {"fused": 0, "classic": ' in capsys.readouterr().err


@pytest.mark.parametrize("precision, passes", [("tf32", False), ("f32", True)])
def test_the_control(precision, passes):
    c = cell()
    nums = control_batch.numbers(c, SEED, torch.device("cpu"), precision, seconds=0.3)
    assert harness.judge(nums, c.limits) == passes, nums
