"""Logging, the training loss meter and the evaluation's frames/s meter (the
port's copy of the parts of ``swem_tpu/utils/__init__.py`` that the
evaluator and the trainer use)."""

from __future__ import annotations

import logging
import os
import sys
import time
from collections import deque
from typing import Optional


def mkdir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def setup_logger(name: str, save_dir: Optional[str] = None, filename: str = "log",
                 screen: bool = True) -> logging.Logger:
    """Timestamped logger to a file in ``save_dir`` (if given) and, with
    ``screen``, to stdout."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s",
                            datefmt="%y-%m-%d %H:%M:%S")
    if save_dir is not None:
        mkdir(save_dir)
        stamp = time.strftime("%y%m%d-%H%M%S")
        fh = logging.FileHandler(os.path.join(save_dir, f"{filename}_{stamp}.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    if screen:
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    return logger


class AvgMeter:
    """Windowed running average of the last ``window`` values (all of them
    at ``window <= 0``), with the global average beside it."""

    def __init__(self, window: int = 100):
        self.window = window
        self.reset()

    def reset(self):
        self._values = deque(maxlen=self.window if self.window > 0 else None)
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        self._values.append(float(value))
        self.total += float(value)
        self.count += 1

    @property
    def avg(self) -> float:
        if not self._values:
            return 0.0
        return sum(self._values) / len(self._values)

    @property
    def global_avg(self) -> float:
        return self.total / max(1, self.count)


class FrameSecondMeter:
    """Frames/s over whole-video inference spans: total frames over total
    seconds, each span covering one video's (or one batch's) inference,
    synchronized by the caller (the runner's host fetch)."""

    def __init__(self):
        self.st = None
        self.n_frames = 0
        self.n_seconds = 0.0
        self.fps = None

    def tic(self):
        self.st = time.perf_counter()

    def toc(self, n_frames: int):
        self.n_seconds += time.perf_counter() - self.st
        self.n_frames += n_frames

    def end(self):
        self.fps = self.n_frames / max(self.n_seconds, 1e-9)
        return self.fps
