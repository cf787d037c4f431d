"""``python -m swem_tpu_torch.bench`` on the CPU: a smoke test of the command
and its JSON line (``--small``: two train steps of a narrow model at batch 2,
32x32; the numbers measure nothing)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
KEYS = {"metric", "value", "unit", "dtype", "train_step_ms", "train_step_ms_median",
        "train_samples_per_s", "train_peak_mem_mb", "device"}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bench_prints_one_json_line(dtype):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"  # one core: the suite's other workers share the machine
    out = subprocess.run([sys.executable, "-m", "swem_tpu_torch.bench", "--device", "cpu",
                          "--small", "--dtype", dtype],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1, out.stdout
    res = json.loads(lines[0])
    assert set(res) == KEYS
    assert res["metric"] == "swem_s3_train_step_ms" and res["unit"] == "ms"
    assert res["dtype"] == dtype and res["device"] == "cpu"
    assert res["train_peak_mem_mb"] is None  # a device number: none from a CPU run
    assert res["value"] == res["train_step_ms"] > 0 and res["train_step_ms_median"] > 0
    assert res["train_samples_per_s"] == pytest.approx(2 / res["train_step_ms"] * 1e3)
