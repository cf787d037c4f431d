"""The port's benchmark: whole-video inference frames/s at 480p.

    python -m swem_tpu_torch.bench [--dtype bfloat16|float32]
    python -m swem_tpu_torch.bench --device cpu --small   # smoke test only

Counterpart of ``bench.py::bench_scan`` and the scan part of its ``main``:
the flagship ``ModelConfig`` at ``--dtype`` (default bfloat16, the dtype the
JAX package publishes; float32 is the parity configuration) with seeded
random weights, ``engine.run_video`` over a synthetic video of T = 30
frames, B = 1, 480x864 in and 480x854 out, two box objects. The frames go
to the device before any timing; one warm-up run, then 5 timed runs, each
on a copy of the frames perturbed outside the timed span, each ending on a
checksum ``.item()`` of the predictions (no bulk copy to the host inside
the span). frames/s = T / wall time of one run.

Prints one JSON line: ``bench.py``'s keys ``metric``, ``value`` (the median
``scan_fps``), ``unit``, ``vs_baseline`` (over the paper's 36 frames/s on a
V100) and ``scan_fps``, plus ``dtype``, every run's frames/s, their min and
max, the peak device memory over the timed runs (``run_video`` key-encodes
all T - 1 frames in one batch, so it grows with T) and the device: the
``nvidia-smi`` name and power limit on CUDA. TF32 is off through the
engine's own scope. ``--small`` runs a narrow model at 64x64 and T = 3 for
the CPU test; its numbers measure nothing.
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
from swem_tpu_torch.config import ModelConfig
from swem_tpu_torch.models.swem import SWEM

BASELINE_FPS = 36.0  # the SWEM paper, 480p on a V100
# (y0, y1, x0, x1) of the two objects at 480x854 (bench.py:63-68)
BOXES = ((100, 220, 150, 330), (260, 400, 500, 700))
RUNS = 5  # timed runs, as bench.py
SMALL = dict(backbone="resnet18", keydim=16, valdim=32, num_bases=8, num_em_iters=2, topl=4,
             mdim=32)


def synthetic_video(T: int, in_size, out_size, n_objs: int):
    """Frames (T,1,H,W,3) in [0,1], seeded, and the one-hot init mask
    (1,Ho,Wo,N+1): ``BOXES`` scaled to ``out_size``."""
    frames = np.random.default_rng(0).random((T, 1) + tuple(in_size) + (3,)).astype(np.float32)
    Ho, Wo = out_size
    mask = np.zeros((1, Ho, Wo, n_objs + 1), np.float32)
    mask[..., 0] = 1.0
    for ch, (y0, y1, x0, x1) in enumerate(BOXES[:n_objs], start=1):
        ys, xs = slice(y0 * Ho // 480, y1 * Ho // 480), slice(x0 * Wo // 854, x1 * Wo // 854)
        mask[:, ys, xs, ch] = 1.0
        mask[:, ys, xs, 0] = 0.0
    return frames, mask


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


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                    help="the conv towers' compute dtype (float32: the parity configuration)")
    ap.add_argument("--device", default=None, help="default: CUDA")
    ap.add_argument("--small", action="store_true",
                    help="narrow model, 64x64, T=3: a smoke test, never a measurement")
    args = ap.parse_args(argv)

    if args.small:
        cfg, T, in_size, out_size = ModelConfig(dtype=args.dtype, **SMALL), 3, (64, 64), (64, 64)
    else:
        cfg, T, in_size, out_size = ModelConfig(dtype=args.dtype), 30, (480, 864), (480, 854)
    model = SWEM(cfg, device=args.device).init_weights(0)
    res = bench_scan(model, T, in_size, out_size)
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
        "device": device_line(model.device),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
