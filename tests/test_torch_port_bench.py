"""``python -m swem_tpu_torch.bench`` on the CPU: a smoke test of the command
and its JSON line (``--small``: a narrow model at 64x64, scan T = 3, runner
T = 7, 3 pushes, two train steps of batch 2 at 32x32; the numbers measure
nothing)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
KEYS = {"metric", "value", "unit", "vs_baseline", "scan_fps", "dtype", "scan_fps_runs",
        "scan_fps_min", "scan_fps_max", "peak_mem_mb", "runner_fps", "runner_device_fps",
        "runner_peak_mem_mb", "serve_latency_ms", "serve_wall_p50_ms", "serve_wall_p95_ms",
        "train_step_ms", "train_step_ms_median", "train_samples_per_s", "train_peak_mem_mb",
        "device"}
DEVICE_ONLY = ("peak_mem_mb", "runner_device_fps", "runner_peak_mem_mb", "serve_latency_ms",
               "train_peak_mem_mb")


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
    assert res["metric"] == "swem_480p_inference_fps" and res["unit"] == "frames/s"
    assert res["dtype"] == dtype and res["device"] == "cpu"
    assert all(res[k] is None for k in DEVICE_ONLY)  # device numbers: none from a CPU run
    assert res["runner_fps"] > 0 and 0 < res["serve_wall_p50_ms"] <= res["serve_wall_p95_ms"]
    runs = res["scan_fps_runs"]
    assert len(runs) >= 5 and all(r > 0 for r in runs)
    assert res["scan_fps_min"] == min(runs) and res["scan_fps_max"] == max(runs)
    assert res["value"] == res["scan_fps"] and res["scan_fps_min"] <= res["value"] <= max(runs)
    assert res["vs_baseline"] == pytest.approx(res["value"] / 36.0)
    assert res["train_step_ms"] > 0 and res["train_step_ms_median"] > 0
    assert res["train_samples_per_s"] == pytest.approx(2 / res["train_step_ms"] * 1e3)
