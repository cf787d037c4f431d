"""Tiny cells for the CPU: the cells' drivers and checks at a width and a
frame size a test run holds (the port runs its plain CPU paths)."""

import time

import torch

from vosbench import harness

TINY = dict(backbone="resnet18", keydim=16, valdim=32, num_bases=8, num_em_iters=2,
            em_tau=0.05, topl=4, max_objs=2, mdim=32, dtype="float32")
TRAFFIC = {
    "video": {"driver": "video", "raw_hw": [64, 72], "in_hw": [64, 64], "out_hw": [64, 72],
              "chunk": 4, "objects": 2, "lengths": [5, 7, 9], "pool_frames": 12,
              "start_step": 2, "check_videos": 2, "trace_videos": 1},
    "stream": {"driver": "stream", "raw_hw": [64, 72], "in_hw": [64, 64], "out_hw": [64, 72],
               "objects": 2, "stream_frames": 8, "check_streams": 2, "trace_pushes": 3},
}
CELLS = {"video": "davis-offline.fp32", "stream": "live-stream.bf16"}


def cell(kind: str, real: str = None, **mcfg) -> harness.Cell:
    """The real cell ``real`` (by default the one of ``kind``; its metrics
    and limits) at the tiny size."""
    real = harness.load_cell(real or CELLS[kind])
    return harness.Cell(real.name, 1, dict(TINY, **mcfg), TRAFFIC[kind], real.limits,
                        real.end_to_end, real.per_layer)


def run(kind: str, seed: int = 2 ** 31 + 7, trace: bool = False, real: str = None,
        **mcfg) -> dict:
    from vosbench.run import run_cell

    torch.set_num_threads(2)
    return run_cell(cell(kind, real, **mcfg), seed, 0.5, trace, torch.device("cpu"),
                    time.perf_counter())
