"""The controls: the reference put in the program's place at the precision
below the configuration's (fp8 towers for bf16, TF32 for float32). On the
CPU at the tiny size the fp8 control reads above the sound program; on the
card, at each cell's own size, every control comes out not correct through
the harness's own comparison against the cell's limits."""

import json

import pytest
import torch

from vosbench import harness
from vosbench.calibrate import readings
from vosbench.tests import _tiny


def tiny_numbers(kind, control=None, **mcfg):
    from vosbench.trace import Tracer

    torch.set_num_threads(2)
    cell = _tiny.cell(kind, **mcfg)
    run = harness.Run(cell, 2 ** 31 + 11, 0.5, False, torch.device("cpu"))
    drv = harness.driver(cell)
    state = drv.setup(run)
    win = drv.window(run, state, Tracer(False, run.device))
    return drv.check(run, state, win, control=control)


@pytest.mark.parametrize("kind", ["video", "stream"])
def test_fp8_control_reads_above_the_program(kind):
    sound = tiny_numbers(kind)
    low = tiny_numbers(kind, control="fp8")
    assert low["confident"] > sound["confident"]
    assert low["first_confident"] > sound["first_confident"]


def test_each_configuration_names_the_precision_below_its_own():
    below = {"bfloat16": "fp8", "float32": "tf32"}
    for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]:
        cfg = harness.load_cell(w["name"]).mcfg
        assert cfg["control"] == below[cfg["dtype"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["davis-offline.bf16", "davis-offline.fp32", "live-stream.bf16"])
def test_control_fails_the_limits_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    c = harness.load_cell(cell)
    for r in readings(cell, [], [c.mcfg["control"]], [101, 102, 103], 8.0,
                      torch.device("cuda:0")):
        assert not r["correct"], r
        assert not harness.is_correct(harness.judge(r["numbers"], c.limits)), r
