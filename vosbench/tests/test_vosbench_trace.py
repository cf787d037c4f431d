"""The trace arithmetic on synthetic profiler events: the busy union, idle
gaps named by the host op that ran, and the readers of idle share,
roofline share and MFU."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from vosbench import flops, harness, trace


def ev(name, start, end, device=DeviceType.CPU, thread=1, device_total=0.0):
    return SimpleNamespace(name=name, device_type=device, thread=thread,
                           time_range=SimpleNamespace(start=start, end=end),
                           device_time_total=device_total)


def test_merge():
    assert trace.merged([(5, 20), (0, 10), (30, 40), (35, 38)]) == [(0, 20), (30, 40)]


def test_gaps_are_named_by_the_innermost_host_op():
    ops = [(0, 100, "outer"), (10, 20, "inner_a"), (50, 90, "inner_b"), (200, 300, "solo")]
    assert trace.name_points([15, 30, 60, 150, 250], ops) == \
        ["outer/inner_a", "outer", "outer/inner_b", "(no op)", "solo"]


def test_summarize_counts_kernels_ops_and_gaps():
    cuda = DeviceType.CUDA
    events = [
        ev("aten::convolution", 0, 10, device_total=8.0),
        ev("swem_tpu_torch::em_loop", 20, 30, device_total=5.0),
        ev("cudaStreamSynchronize", 40, 70),
        ev("k_conv", 2, 10, cuda), ev("Memcpy HtoD", 10, 12, cuda), ev("k_em", 25, 30, cuda),
        ev("k_em", 70, 75, cuda),
    ]
    prof = SimpleNamespace(events=lambda: events)
    s = trace.summarize(prof, ("swem_tpu_torch::em_loop",))
    assert s["launches"] == 3
    assert s["busy_s"] == pytest.approx(18e-6)
    assert s["conv_s"] == pytest.approx(8e-6)
    assert s["op_s"] == {"swem_tpu_torch::em_loop": pytest.approx(5e-6)}
    assert s["op_calls"] == {"swem_tpu_torch::em_loop": 1}
    gaps = dict(s["breakdown"]["idle_gaps"])
    # 10..25 (midpoint 17.5: no host op), 30..70 (midpoint 50: the sync)
    assert gaps == {"(no op)": pytest.approx(15e-6), "cudaStreamSynchronize": pytest.approx(40e-6)}
    assert dict(s["breakdown"]["device_ops"])["k_em"] == pytest.approx(10e-6)


def test_readers():
    work = flops.em_loop_work(1, 2, 1620, 128, 128, 4)
    s = {"units": 10, "launches": 5000, "busy_s": 0.5, "window_s": 2.0, "conv_s": 0.02,
         "op_s": {"swem_tpu_torch::em_loop": 9 * 1.2e-4}, "op_calls": {"swem_tpu_torch::em_loop": 9},
         "op_work": {"swem_tpu_torch::em_loop": work}, "mfu_flops": 6e14, "mfu_seconds": 10.0,
         "dtype": "bfloat16", "peak_bytes": 1.6e9}
    read = {m: harness.reader(m).read(s) for m in (
        "launches_per_frame.video", "conv_ms_per_frame.video", "device_idle.video",
        "em_loop_roofline.video", "read_roofline.video", "mfu.video", "peak_mem_mb.video")}
    assert read["launches_per_frame.video"] == 500
    assert read["conv_ms_per_frame.video"] == pytest.approx(2.0)
    assert read["device_idle.video"] == pytest.approx(75.0)
    assert read["em_loop_roofline.video"] == pytest.approx(100 * (1.7e9 / 495e12) / 1.2e-4, rel=1e-3)
    assert read["read_roofline.video"] is None  # nothing traced for that op: no number, never 0
    assert read["mfu.video"] == pytest.approx(100 * 6e13 / 989e12)
    assert read["peak_mem_mb.video"] == pytest.approx(1600.0)


def test_tracer_off_does_nothing():
    t = trace.Tracer(False, torch.device("cpu"))
    t.start()
    t.stop()
    assert t.summary() is None
