"""Logging, meters and small utilities (the port's copy of
``swem_tpu/utils/__init__.py``): the logger, the training loss meter, the
evaluation's frames/s meter, seeding of Python's and numpy's generators,
padded sizes, a source snapshot and a parameter count."""

from __future__ import annotations

import logging
import os
import random
import sys
import time
from collections import deque
from typing import Optional

import numpy as np


def mkdir(path: str) -> None:
    os.makedirs(path, exist_ok=True)


def init_random_seed(seed: int) -> None:
    """Seed Python's and numpy's global generators, as the JAX package does.
    The port's own draws take explicit ``torch.Generator``s and are not
    touched."""
    random.seed(seed)
    np.random.seed(seed)


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


def pad_divide_by(shape, d: int = 16):
    """(h, w) rounded up to multiples of ``d``."""
    h, w = shape
    return ((h + d - 1) // d * d, (w + d - 1) // d * d)


def save_scripts(exp_dir: str, src_root: Optional[str] = None) -> str:
    """Copy the package's source (``swem_tpu_torch/`` unless ``src_root``)
    into ``<exp_dir>/scripts_snapshot``, replacing an earlier copy, so that a
    run keeps the code it ran; returns the copy's path."""
    import shutil

    src_root = src_root or os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(exp_dir, "scripts_snapshot")
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(src_root, dst,
                    ignore=shutil.ignore_patterns("__pycache__", "*.pyc", "logs", ".git"))
    return dst


def count_model_size(params) -> float:
    """Parameters in millions of an ``nn.Module`` (its ``parameters()``) or
    of a ``state_dict`` (its tensors but the batch norms' running statistics
    and counters, which are buffers)."""
    if hasattr(params, "parameters"):
        tensors = list(params.parameters())
    else:
        tensors = [v for k, v in params.items()
                   if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))]
    return sum(int(t.numel()) for t in tensors) / 1e6
