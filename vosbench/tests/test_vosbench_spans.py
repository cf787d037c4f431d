"""The readers of the program's stage spans and its ``models.param_preps``
counter: their arithmetic on a synthetic record, no number from an empty
record or from a program without spans, and all seven metrics in traced
tiny runs of both bf16 cells' drivers."""

import time

import pytest
import torch

from vosbench import harness
from vosbench.run import run_cell
from vosbench.tests import _tiny

READERS = ("upload_host_ms", "encode_host_ms", "read_host_ms", "decode_host_ms",
           "memorize_host_ms", "fetch_wait_ms", "param_preps_per_frame")


def record(requests, spans=None, counts=None):
    return {"requests": requests, "request_s": 1.0, "counts": counts or {},
            "spans": {k: {"calls": 1, "self_s": v} for k, v in (spans or {}).items()}}


def read_all(s):
    return {m: harness.reader(m).read(s) for m in READERS}


def test_readers_on_a_synthetic_record(monkeypatch):
    from swem_tpu_torch.utils import profiling

    stream = record(4, {"serve.upload": 0.004, "engine.encode_keys": 0.012,
                        "engine.read": 0.008, "engine.decode": 0.02, "engine.memorize": 0.04,
                        "serve.fetch": 0.002, "engine.init_memory": 1.0},
                    {"models.param_preps": 680})
    records = {"engine.video": record(0), "serve.push": stream}
    monkeypatch.setattr(profiling, "recorded", lambda kind=None: records[kind])
    got = read_all({"units": 4})
    assert got == pytest.approx({"upload_host_ms": 1.0, "encode_host_ms": 3.0,
                                 "read_host_ms": 2.0, "decode_host_ms": 5.0,
                                 "memorize_host_ms": 10.0, "fetch_wait_ms": 0.5,
                                 "param_preps_per_frame": 170.0})
    # whole videos come first: a traced part holding one reads it alone
    records["engine.video"] = record(1, {"engine.upload": 0.01, "engine.fetch": 0.02})
    got = read_all({"units": 10})
    assert got["upload_host_ms"] == pytest.approx(1.0)
    assert got["fetch_wait_ms"] == pytest.approx(2.0)
    assert got["read_host_ms"] == 0.0 and got["param_preps_per_frame"] == 0.0
    assert set(read_all({}).values()) == {None}


def test_no_number_without_a_record(monkeypatch):
    from swem_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "recorded", lambda kind=None: record(0))
    assert set(read_all({"units": 10}).values()) == {None}
    monkeypatch.delattr(profiling, "recorded")  # a program that records no spans
    assert set(read_all({"units": 10}).values()) == {None}


def test_traced_video_reports_the_span_metrics():
    res = _tiny.run("video", trace=True, real="davis-offline.bf16")
    assert res["correct"]
    for m in READERS:
        assert res["metrics"][f"{m}.video"]["value"] >= 0.0
    assert res["metrics"]["param_preps_per_frame.video"]["value"] > 0.0


def test_traced_stream_reports_the_span_metrics(monkeypatch):
    from swem_tpu_torch.utils import profiling

    summaries = []
    per_layer = harness.per_layer

    def spy(cell, summary):
        summaries.append(summary)
        return per_layer(cell, summary)

    monkeypatch.setattr(harness, "per_layer", spy)
    torch.set_num_threads(2)
    # the traced part starts at the 11th push: a window the CPU reaches it in
    res = run_cell(_tiny.cell("stream"), 2 ** 31 + 7, 3.0, True, torch.device("cpu"),
                   time.perf_counter())
    assert res["correct"]
    for m in READERS:
        assert res["metrics"][f"{m}.stream"]["value"] >= 0.0
    assert res["metrics"]["param_preps_per_frame.stream"]["value"] > 0.0
    assert profiling.recorded("serve.push")["requests"] == summaries[0]["units"] > 0
