"""The reader of the program's ``serve.pushes`` and ``serve.graph_replays``
counters: no number from a program that counts no pushes, 100 where every
push replayed, and the share in between."""

import pytest

from vosbench import harness

READER = "graph_replay_share"


def record(requests, counts):
    return {"requests": requests, "request_s": 1.0, "spans": {}, "counts": counts}


def test_no_number_without_the_counters(monkeypatch):
    from swem_tpu_torch.utils import profiling

    read = harness.reader(READER).read
    monkeypatch.setattr(profiling, "recorded", lambda kind=None: record(3, {}))
    assert read({"units": 3}) is None
    monkeypatch.delattr(profiling, "recorded")
    assert read({"units": 3}) is None


def test_every_push_replayed(monkeypatch):
    from swem_tpu_torch.utils import profiling

    records = {"engine.video": record(0, {}),
               "serve.push": record(100, {"serve.pushes": 100, "serve.graph_replays": 100})}
    monkeypatch.setattr(profiling, "recorded", lambda kind=None: records[kind])
    read = harness.reader(READER).read
    assert read({"units": 100}) == 100.0
    records["serve.push"] = record(4, {"serve.pushes": 4, "serve.graph_replays": 1})
    assert read({"units": 4}) == pytest.approx(25.0)
    records["serve.push"] = record(4, {"serve.pushes": 4})
    assert read({"units": 4}) == 0.0
