"""The reader of the program's ``engine.steps`` and ``engine.graph_steps``
counters: no number from a program that counts no steps (as one without
the runner's graphs), 100 where every frame replayed, the share in between,
and whole videos read before pushes."""

import pytest

from vosbench import harness

READER = "step_graph_share"


def record(requests, counts):
    return {"requests": requests, "request_s": 1.0, "spans": {}, "counts": counts}


def test_no_number_without_the_counters(monkeypatch):
    from swem_tpu_torch.utils import profiling

    read = harness.reader(READER).read
    monkeypatch.setattr(profiling, "recorded", lambda kind=None: record(3, {"engine.slots": 6}))
    assert read({"units": 3}) is None
    monkeypatch.delattr(profiling, "recorded")
    assert read({"units": 3}) is None


def test_every_frame_replayed(monkeypatch):
    from swem_tpu_torch.utils import profiling

    records = {"engine.video": record(2, {"engine.steps": 130, "engine.graph_steps": 130}),
               "serve.push": record(0, {})}
    monkeypatch.setattr(profiling, "recorded", lambda kind=None: records[kind])
    read = harness.reader(READER).read
    assert read({"units": 132}) == 100.0
    records["engine.video"] = record(2, {"engine.steps": 80, "engine.graph_steps": 60})
    assert read({"units": 82}) == pytest.approx(75.0)
    records["engine.video"] = record(2, {"engine.steps": 80})
    assert read({"units": 82}) == 0.0


def test_the_metric_names_find_the_reader():
    for cell in ("video", "vb2", "ytvos"):
        assert harness.reader(f"{READER}.{cell}").__name__ == harness.reader(READER).__name__
