"""The port's benchmark: whole-video, chunked and online inference at 480p,
and the S3 train step.

    python -m swem_tpu_torch.bench [--dtype bfloat16|float32]
    python -m swem_tpu_torch.bench --device cpu --small   # smoke test only

Counterpart of ``bench.py``'s ``bench_scan``, ``bench_runner`` and
``bench_serve``: the flagship ``ModelConfig`` at ``--dtype`` (default
bfloat16, the dtype the JAX package publishes; float32 is the parity
configuration) with seeded random weights, B = 1, two box objects.

- scan: ``engine.run_video`` over a synthetic video of T = 30 frames,
  480x864 in and 480x854 out. The frames go to the device before any
  timing; one warm-up run, then 5 timed runs, each on a copy of the frames
  perturbed outside the timed span, each ending on a checksum ``.item()``
  of the predictions (no bulk copy to the host inside the span). frames/s =
  T / wall time of one run.
- runner: ``ChunkedVideoRunner(chunk=16)`` on a T = 69 uint8 HOST video at
  480x854 (a DAVIS-typical length, 16*4 + 4 + 1 chunks), preprocessed on
  the device to 480x864 (/255, bicubic); ``warmup``, then 4 timed calls,
  each with its uploads and its final uint8 fetch to the host inside the
  span (production semantics). ``runner_device_fps`` is T over the device's
  busy seconds in one more call under ``torch.profiler``.
- serve: a ``StreamingSession`` with raw frames 480x854, in-size 480x864,
  out-size 480x854, 24 pushes of uint8 frames after ``warmup`` and
  ``start``: the wall p50/p95 of a push that returns its map to the host,
  and the device's busy ms per push under ``torch.profiler``
  (``serve_latency_ms``, the JAX package's semantics).
- train: the S3 train step (``train.trainer.make_train_step``, AdamW,
  bootstrapped CE + IoU) at the flagship width, batch 8, 384x384 crops,
  T = 3, ``scripts/train_bench.py``'s ``step_ms``: a synthetic uint8 batch
  (two boxes) staged on the device, two warm-up steps, then K = 10 steps
  with one sync at the end. ``train_step_ms`` is their wall over K,
  ``train_step_ms_median`` the median of the per-step spans between CUDA
  events recorded before each step (no sync between them),
  ``train_samples_per_s`` = batch / ``train_step_ms``, ``train_peak_mem_mb``
  the peak device memory over the K steps.

Prints one JSON line: ``bench.py``'s keys ``metric``, ``value`` (the median
``scan_fps``), ``unit``, ``vs_baseline`` (over the paper's 36 frames/s on a
V100) and ``scan_fps``, plus ``dtype``, every scan run's frames/s, their
min and max, the peak device memory over the timed scan runs
(``run_video`` key-encodes all T - 1 frames in one batch, so it grows with
T), the runner's median frames/s, device frames/s and peak device memory
(bounded by the chunk), the serve numbers, the train numbers and the
device: the
``nvidia-smi`` name and power limit on CUDA. The device-derived fields are
null on the CPU. TF32 is off through the engine's and the train step's own
scopes. ``--small`` runs a narrow model at 64x64 (scan T = 3, runner T = 7
in chunks of 4, 3 pushes, train batch 2 at 32x32, K = 2) for the CPU test;
its numbers measure nothing.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Optional, Sequence

import numpy as np
import torch

from swem_tpu_torch import engine
from swem_tpu_torch.config import ModelConfig, SWEMConfig
from swem_tpu_torch.models.swem import SWEM
from swem_tpu_torch.ops.resize import resize
from swem_tpu_torch.serve import StreamingSession, measure_device_latency, measure_latency
from swem_tpu_torch.utils.profiling import device_busy_seconds

BASELINE_FPS = 36.0  # the SWEM paper, 480p on a V100
# (y0, y1, x0, x1) of the two objects at 480x854 (bench.py:63-68)
BOXES = ((100, 220, 150, 330), (260, 400, 500, 700))
RUNS = 5  # timed scan runs, as bench.py
RUNNER_RUNS = 4  # timed runner calls, as bench.py
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


def bench_scan(model: SWEM, T: int, in_size, out_size) -> dict:
    """Warm-up, then ``RUNS`` timed ``run_video`` calls -> frames/s per run
    and the peak device memory (MB) over the timed runs (None on the CPU)."""
    dev = model.device
    frames_np, mask_np = synthetic_video(T, in_size, out_size, model.cfg.max_objs)
    frames = torch.from_numpy(frames_np).to(dev)
    init_mask = torch.from_numpy(mask_np).to(dev)
    active = torch.ones((1, model.cfg.max_objs), dtype=torch.bool, device=dev)

    def run(f) -> int:
        preds = engine.run_video(model, torch.Generator().manual_seed(1), f, init_mask, active,
                                 out_size)
        # a checksum synchronizes without copying the predictions to the host
        return int(preds.sum(dtype=torch.int64).item())

    run(frames)  # warm-up: cuDNN plans, kernel builds, allocator
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    fps = []
    for i in range(RUNS):
        variant = frames + 1e-4 * (i + 1)  # made and finished outside the timed span
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        run(variant)
        fps.append(T / (time.perf_counter() - t0))
        del variant
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20 if dev.type == "cuda" else None
    return {"fps": fps, "peak_mem_mb": peak}


def bench_runner(model: SWEM, T: int, chunk: int, raw_hw, in_size, out_size) -> dict:
    """Warm-up, then ``RUNNER_RUNS`` timed ``ChunkedVideoRunner`` calls on a
    uint8 host video -> frames/s per call, the peak device memory (MB) over
    them and frames/s of device time in one profiled call (None on the CPU)."""
    dev, n = model.device, model.cfg.max_objs
    frames = uint8_frames((T, 1) + tuple(raw_hw) + (3,), 1)
    mask, active = box_mask(out_size, n), np.ones((1, n), bool)
    runner = engine.ChunkedVideoRunner(
        model, out_size, chunk=chunk,
        preprocess=lambda f: resize(f.float() / 255.0, tuple(in_size), "bicubic"))
    runner.warmup(raw_hw, 1, n, np.uint8)

    def run():
        return runner(torch.Generator().manual_seed(1), frames, mask, active)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    fps = []
    for _ in range(RUNNER_RUNS):
        t0 = time.perf_counter()
        preds = run()  # on the host: the call ends with the fetch
        fps.append(T / (time.perf_counter() - t0))
    if preds.shape != (T - 1, 1) + tuple(out_size) or preds.dtype != np.uint8:
        raise RuntimeError(f"runner predictions {preds.shape} {preds.dtype}")
    if dev.type != "cuda":
        return {"fps": fps, "device_fps": None, "peak_mem_mb": None}
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    return {"fps": fps, "device_fps": T / device_busy_seconds(prof), "peak_mem_mb": peak}


def bench_serve(cfg: ModelConfig, state_dict, n_push: int, raw_hw, in_size, out_size,
                device) -> dict:
    """``measure_latency`` and, on CUDA, ``measure_device_latency`` over the
    same ``n_push`` uint8 frames of one session."""
    frames = uint8_frames((n_push,) + tuple(raw_hw) + (3,), 2)
    frame0 = uint8_frames(tuple(raw_hw) + (3,), 3)
    labels = box_mask(out_size, cfg.max_objs)[0].argmax(-1).astype(np.uint8)
    session = StreamingSession(cfg, state_dict, raw_hw=raw_hw, in_size=in_size,
                               out_size=out_size, device=device)
    wall = measure_latency(session, frame0, labels, frames, percentiles=(50, 95))
    busy = (measure_device_latency(session, frame0, labels, frames)
            if session.device.type == "cuda" else None)
    return {"p50": wall["p50"], "p95": wall["p95"], "device_ms": busy}


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
                    help="narrow model at 64x64, few frames: a smoke test, never a measurement")
    args = ap.parse_args(argv)

    if args.small:
        cfg = ModelConfig(dtype=args.dtype, **SMALL)
        T, in_size, out_size = 3, (64, 64), (64, 64)
        runner_T, chunk, n_push, raw_hw = 7, 4, 3, (64, 64)
        train_b, crop, train_k = 2, 32, 2
    else:
        cfg = ModelConfig(dtype=args.dtype)
        T, in_size, out_size = 30, (480, 864), (480, 854)
        runner_T, chunk, n_push, raw_hw = 69, 16, 24, (480, 854)
        train_b, crop, train_k = 8, 384, TRAIN_STEPS
    model = SWEM(cfg, device=args.device).init_weights(0)
    res = bench_scan(model, T, in_size, out_size)
    runner = bench_runner(model, runner_T, chunk, raw_hw, in_size, out_size)
    state_dict, dev = model.state_dict(), model.device
    del model  # the session loads its own copy of the weights
    serve = bench_serve(cfg, state_dict, n_push, raw_hw, in_size, out_size, args.device)
    train, _ = bench_train(SWEMConfig(model=cfg), train_batch(train_b, 3, crop, cfg.max_objs),
                           train_k, args.device)
    median = float(np.median(res["fps"]))
    out = {
        "metric": "swem_480p_inference_fps",
        "value": median,
        "unit": "frames/s",
        "vs_baseline": median / BASELINE_FPS,
        "scan_fps": median,
        "dtype": args.dtype,
        "scan_fps_runs": res["fps"],
        "scan_fps_min": min(res["fps"]),
        "scan_fps_max": max(res["fps"]),
        "peak_mem_mb": res["peak_mem_mb"],
        "runner_fps": float(np.median(runner["fps"])),
        "runner_device_fps": runner["device_fps"],
        "runner_peak_mem_mb": runner["peak_mem_mb"],
        "serve_latency_ms": serve["device_ms"],
        "serve_wall_p50_ms": serve["p50"],
        "serve_wall_p95_ms": serve["p95"],
        "train_step_ms": train["ms"],
        "train_step_ms_median": train["ms_median"],
        "train_samples_per_s": train["samples_per_s"],
        "train_peak_mem_mb": train["peak_mem_mb"],
        "device": device_line(dev),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
