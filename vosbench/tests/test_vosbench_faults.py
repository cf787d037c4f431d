"""Each fault a cell can have, planted under a whole run at the tiny size on
the CPU (the harness's look for a card skipped), comes out not correct
against that cell's limits; the same run without it is correct."""

import numpy as np
import pytest

from vosbench.tests import _tiny


def frozen_memory(monkeypatch):
    """A step that returns its state unchanged: every memorize, frame 0's
    included, keeps the memory as it was."""
    from swem_tpu_torch.models import em

    monkeypatch.setattr(em, "memorize", lambda mem, *a, **k: mem)


def _alter_video_map(monkeypatch, index):
    from swem_tpu_torch.engine import ChunkedVideoRunner

    call = ChunkedVideoRunner.__call__

    def altered(self, *a, **k):
        out = call(self, *a, **k)
        out[index] = (out[index] + 1) % 3
        return out

    monkeypatch.setattr(ChunkedVideoRunner, "__call__", altered)


def altered_video_answer(monkeypatch):
    """The first map of every video altered where the runner produces it."""
    _alter_video_map(monkeypatch, 0)


def altered_late_video_answer(monkeypatch):
    """The last map of every video altered where the runner produces it:
    a frame of the ladder's last chunk, after every memorize."""
    _alter_video_map(monkeypatch, -1)


def _alter_push(monkeypatch, frames_seen):
    from swem_tpu_torch.serve import StreamingSession

    push = StreamingSession.push

    def altered(self, frame):
        y = push(self, frame)
        return (y + 1) % 3 if self.frames_seen == frames_seen else y

    monkeypatch.setattr(StreamingSession, "push", altered)


def altered_push(monkeypatch):
    """The first push's map of every stream altered where the session
    produces it."""
    _alter_push(monkeypatch, 2)


FAULTS = [("davis-offline.bf16", frozen_memory), ("davis-offline.bf16", altered_video_answer),
          ("davis-offline.fp32", frozen_memory), ("davis-offline.fp32", altered_video_answer),
          ("davis-offline.fp32", altered_late_video_answer),
          ("live-stream.bf16", frozen_memory), ("live-stream.bf16", altered_push)]
KIND = {"davis-offline.bf16": "video", "davis-offline.fp32": "video", "live-stream.bf16": "stream"}


@pytest.mark.parametrize("cell,fault", FAULTS, ids=lambda f: getattr(f, "__name__", f))
def test_a_planted_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    res = _tiny.run(KIND[cell], real=cell)
    assert not res["correct"], res["compared"]
    assert all(np.isfinite(c["value"]) for c in res["compared"].values())

