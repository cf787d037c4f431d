"""The reader of the program's ``models.param_cache_hits`` counter: its
arithmetic on a synthetic record, no number from an empty record, from a
record without the counter or from a program without spans, and in a
traced tiny run of the bf16 video cell's driver every preparation a reuse."""

import pytest

from vosbench import harness
from vosbench.tests import _tiny

READER = "param_cache_hits_per_frame"


def record(requests, counts):
    return {"requests": requests, "request_s": 1.0, "spans": {}, "counts": counts}


def test_reader_on_a_synthetic_record(monkeypatch):
    from swem_tpu_torch.utils import profiling

    records = {"engine.video": record(0, {}),
               "serve.push": record(4, {"models.param_cache_hits": 720,
                                        "models.param_preps": 8})}
    monkeypatch.setattr(profiling, "recorded", lambda kind=None: records[kind])
    read = harness.reader(READER).read
    assert read({"units": 4}) == pytest.approx(180.0)
    assert read({}) is None
    # whole videos come first: a traced part holding one reads it alone
    records["engine.video"] = record(1, {"models.param_cache_hits": 0})
    assert read({"units": 10}) == 0.0
    # a program that prepares on every call records no hits: no number
    records["engine.video"] = record(1, {"models.param_preps": 920})
    assert read({"units": 10}) is None


def test_no_number_without_a_record(monkeypatch):
    from swem_tpu_torch.utils import profiling

    read = harness.reader(READER).read
    monkeypatch.setattr(profiling, "recorded", lambda kind=None: record(0, {}))
    assert read({"units": 10}) is None
    monkeypatch.delattr(profiling, "recorded")
    assert read({"units": 10}) is None


def test_traced_video_reuses_every_prepared_parameter():
    res = _tiny.run("video", trace=True, real="davis-offline.bf16", dtype="bfloat16")
    assert res["correct"]
    metrics = res["metrics"]
    assert metrics["param_cache_hits_per_frame.video"]["value"] > 0.0
    assert metrics["param_preps_per_frame.video"]["value"] == 0.0
