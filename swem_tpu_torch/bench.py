"""The port's S3 train-step timer.

    python -m swem_tpu_torch.bench [--dtype bfloat16|float32]
    python -m swem_tpu_torch.bench --device cpu --small   # smoke test only

Inference is measured by ``vosbench/run.py`` (the cells of
``BENCHMARK.json``); this module times the one path that has no cell yet,
the S3 train step (``train.trainer.make_train_step``, AdamW, bootstrapped
CE + IoU) of the flagship ``ModelConfig`` at ``--dtype`` (default
bfloat16) with seeded random weights: batch 8, 384x384 crops, T = 3,
``scripts/train_bench.py``'s ``step_ms``. A synthetic uint8 batch (two
boxes) is staged on the device; two warm-up steps, then K = 10 steps with
one sync at the end. ``train_step_ms`` is their wall over K,
``train_step_ms_median`` the median of the per-step spans between CUDA
events recorded before each step (no sync between them),
``train_samples_per_s`` = batch / ``train_step_ms``, ``train_peak_mem_mb``
the peak device memory over the K steps (null on the CPU).

Prints one JSON line: ``metric`` (``swem_s3_train_step_ms``), ``value``
(``train_step_ms``), ``unit``, ``dtype``, the train numbers and the
device: the ``nvidia-smi`` name and power limit on CUDA. TF32 is off
through the train step's own scope. ``--small`` runs a narrow model (train
batch 2 at 32x32, K = 2) for the CPU test; its numbers measure nothing.

The sample-data helpers (``box_mask``, ``synthetic_video``,
``uint8_frames``, ``device_line``) serve ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Optional, Sequence

import numpy as np
import torch

from swem_tpu_torch.config import ModelConfig, SWEMConfig, resolve_device
from swem_tpu_torch.models.swem import SWEM

# (y0, y1, x0, x1) of the two objects at 480x854 (bench.py:63-68)
BOXES = ((100, 220, 150, 330), (260, 400, 500, 700))
SMALL = dict(backbone="resnet18", keydim=16, valdim=32, num_bases=8, num_em_iters=2, topl=4,
             mdim=32)
TRAIN_STEPS = 10  # timed train steps


def box_mask(out_size, n_objs: int) -> np.ndarray:
    """The one-hot init mask (1,Ho,Wo,N+1): ``BOXES`` scaled to ``out_size``."""
    Ho, Wo = out_size
    mask = np.zeros((1, Ho, Wo, n_objs + 1), np.float32)
    mask[..., 0] = 1.0
    for ch, (y0, y1, x0, x1) in enumerate(BOXES[:n_objs], start=1):
        ys, xs = slice(y0 * Ho // 480, y1 * Ho // 480), slice(x0 * Wo // 854, x1 * Wo // 854)
        mask[:, ys, xs, ch] = 1.0
        mask[:, ys, xs, 0] = 0.0
    return mask


def synthetic_video(T: int, in_size, out_size, n_objs: int):
    """Frames (T,1,H,W,3) in [0,1], seeded, and ``box_mask``."""
    frames = np.random.default_rng(0).random((T, 1) + tuple(in_size) + (3,)).astype(np.float32)
    return frames, box_mask(out_size, n_objs)


def uint8_frames(shape, seed: int) -> np.ndarray:
    """Seeded uint8 noise frames of ``shape`` (..., H, W, 3), on the host."""
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.uint8)


def device_line(device: torch.device) -> str:
    """The card's ``nvidia-smi`` name and power limit, or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          f"--id={device.index or 0}"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def train_batch(batch: int, n_frames: int, crop: int, n_objs: int, seed: int = 0) -> dict:
    """A synthetic host batch in the loader's layout: uint8 noise frames,
    two boxes in every frame's slot labels, every slot valid."""
    rng = np.random.default_rng(seed)
    label = np.zeros((batch, n_frames, crop, crop), np.uint8)
    for k in range(min(n_objs, 2)):
        a, b = (crop * (1 + 4 * k)) // 12, (crop * (5 + 4 * k)) // 12
        label[:, :, a:b, a:b + crop // 6] = k + 1
    return {"frames": rng.integers(0, 256, (batch, n_frames, crop, crop, 3), dtype=np.uint8),
            "label": label, "valid_obj": np.ones((batch, n_objs + 1), np.float32)}


def time_train_steps(step, k: int, device: torch.device) -> dict:
    """Run ``step()`` ``k`` times with one sync at the end -> the wall per
    step (``ms``), the per-step spans between events recorded before each
    step (``ms_runs``, CUDA only: device-timeline spans; on the CPU the host
    spans) and the last step's losses."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(k + 1)]
    marks = []
    t0 = time.perf_counter()
    for i in range(k):
        if cuda:
            events[i].record()
        else:
            marks.append(time.perf_counter())
        losses = step()
    if cuda:
        events[k].record()
        torch.cuda.synchronize(device)
        runs = [events[i].elapsed_time(events[i + 1]) for i in range(k)]
    else:
        marks.append(time.perf_counter())
        runs = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    wall = (time.perf_counter() - t0) * 1e3 / k
    return {"ms": wall, "ms_runs": runs, "losses": losses}


def bench_train(cfg: SWEMConfig, batch: dict, steps: int, device=None) -> tuple:
    """The train step of ``cfg`` (its remat is ``cfg.solver.remat``) on the
    host ``batch`` (the loader's layout) staged on the device: two warm-up
    steps, then ``steps`` timed ones (see the module note). Returns (the
    numbers, ``one_step``: one more step on the same state and batch)."""
    from swem_tpu_torch.train.trainer import (batch_to_device, create_train_state,
                                              make_train_step, step_generator)

    model = SWEM(cfg.model, device=device).init_weights(0)
    dev = model.device
    state = create_train_state(model, cfg.solver)
    step = make_train_step(cfg, remat=cfg.solver.remat)
    staged = batch_to_device(batch, dev)
    gen = step_generator(0, 0)

    def one_step():
        return step(state, staged, gen)

    for _ in range(2):  # warm-up: cuDNN plans, kernel builds, allocator
        one_step()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    res = time_train_steps(one_step, steps, dev)
    loss = float(res["losses"]["total_loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"train step: non-finite loss {loss}")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20 if dev.type == "cuda" else None
    n = batch["frames"].shape[0]
    return {"ms": res["ms"], "ms_runs": res["ms_runs"],
            "ms_median": float(np.median(res["ms_runs"])),
            "samples_per_s": n / res["ms"] * 1e3, "peak_mem_mb": peak}, one_step


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                    help="the conv towers' compute dtype (float32: the parity configuration)")
    ap.add_argument("--device", default=None, help="default: CUDA")
    ap.add_argument("--small", action="store_true",
                    help="narrow model, batch 2 at 32x32: a smoke test, never a measurement")
    args = ap.parse_args(argv)

    if args.small:
        cfg, train_b, crop, train_k = ModelConfig(dtype=args.dtype, **SMALL), 2, 32, 2
    else:
        cfg, train_b, crop, train_k = ModelConfig(dtype=args.dtype), 8, 384, TRAIN_STEPS
    train, _ = bench_train(SWEMConfig(model=cfg), train_batch(train_b, 3, crop, cfg.max_objs),
                           train_k, args.device)
    out = {
        "metric": "swem_s3_train_step_ms",
        "value": train["ms"],
        "unit": "ms",
        "dtype": args.dtype,
        "train_step_ms": train["ms"],
        "train_step_ms_median": train["ms_median"],
        "train_samples_per_s": train["samples_per_s"],
        "train_peak_mem_mb": train["peak_mem_mb"],
        "device": device_line(resolve_device(args.device)),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
