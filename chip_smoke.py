#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: build, check, run.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit; imports nothing of JAX or of
``swem_tpu``. Phase 10 starts rank processes of its own through
``python -m torch.distributed.run``, each running this script as
``chip_smoke.py --rank <job> <out_dir> ...``. Phases, each fatal on failure:

0. setup: the card's name and power limit, and PyTorch's TF32 flags as
   found (its defaults, left in force: the engine turns TF32 off in its own
   scope, ``config.full_float32``, and the kernel phases' float32 yardsticks
   run inside that scope too).
1. build: compile ``swem_tpu_torch/csrc/*.cu`` for sm_90a, one nvcc each,
   in parallel.
2. K1 (EM loop kernel: one cooperative launch, tensor cores in 3xTF32)
   against its plain version run in float64 on the same inputs, at the
   flagship shape (1 and 4 rounds), a ragged shape with an empty slot, L =
   256, and N = 8 at P = 3600 (more tile items than CTAs); a second run must
   give the same bits. Each case prints the worst error over its limit for
   the kernel and for the float32 plain loop. ``ms`` times the kernel alone
   at the flagship shape, 4 rounds; its 8 products as ``torch.matmul`` calls
   are timed beside it for information (no one PyTorch call computes the
   loop, so ``library_ms`` is null).
3. K2 (fused memory read kernel, tensor cores in 3xTF32) against its plain
   version run in float64 on the same normalized keys, at the flagship shape,
   two ragged ones and one with Lm = 512 (the kernel's 32-pixel tiling),
   each with all bases valid, an update bank invalid and an object never
   seen (which must read exactly 0); a second run must give the same bits.
   Each case, and eight more flagship draws, print the worst error over
   its limit for the kernel and for the float32 plain read.
   ``ms`` times the kernel alone on normalized keys, beside the wrapper
   (normalization + kernel); ``library_ms`` times
   ``F.scaled_dot_product_attention`` on the same normalized keys (never
   used by the port). Times are device times (``cuda_ms``).
3b. the gradient guard: neither kernel has a backward, so on a CUDA input
   that requires grad (gradients on) both wrappers raise and launch
   nothing; under ``no_grad`` the same inputs launch.
4. float32 main path: ``engine.run_video`` with the flagship
   ``ModelConfig()`` and seeded random weights on a synthetic 480x864 video
   of T=10 frames, two objects, output 480x854. A warm-up pass runs with a
   forward hook on every module that fails the run on a non-finite output
   or on a TF32 flag that reads True inside a forward. Each kernel must have
   been launched exactly T-1 times in the timed run. The first 3 frames are
   rerun on the CPU (plain versions) and the index maps compared. One more
   run under ``torch.profiler`` prints where the device time goes (by
   group, every kernel of the port's two groups with its launches) and the
   device's idle share.
5. bfloat16 main path, the configuration users run: the same weights and
   video with ``ModelConfig(dtype="bfloat16")``, the same hooks and launch
   counts, the memory float32. Its index maps are held against the float32
   run's by the JAX package's own bf16-versus-f32 bounds
   (``tests/test_bf16_margin.py``): under 1% of pixels over the video, and
   the last 3 frames' share at most 3x the first 3 frames' + 1e-4. Then its
   profile.
6. bfloat16 chunked runner, the production evaluation path: the same
   weights, a T=24 uint8 HOST video at 480x854 preprocessed on the card to
   480x864 (/255, bicubic), ``ChunkedVideoRunner(chunk=16)`` after
   ``warmup``, so its 23 frames run as 16 + 4 + 2 + 1. Each kernel must be
   launched 23 times in the call. Its index maps are held against
   ``engine.run_video`` on the same preprocessed frames and generator
   (>= 99% of pixels; cuDNN may pick other algorithms for batches of
   16/4/2/1 than for 23), a ``scores=True`` runner's argmax must equal them
   bit for bit, and an ``injectable=True`` runner started with slot 2
   inactive and given slot 2's box at frame 6 must hold index 2 on every
   pixel of the box there. Prints smoke frames/s and the runner's peak
   device memory beside ``run_video``'s.
7. bfloat16 streaming session, the online serving path: a
   ``StreamingSession`` with the same weights (raw 480x854, in 480x864, out
   480x854, two slots), ``warmup`` (which captures the push as a CUDA
   graph), ``start`` and 12 pushes, each a replay that launches no kernel
   from the host, held against ``engine.init_memory`` + ``engine.step`` on
   the same preprocessed frames and draw (>= 99% of pixels per frame); 12
   more replayed pushes under the profiler, whose records of the card's
   kernels must show each kernel run once per push (``launches_session``);
   then ``prepare_grow(3)``, ``grow(3)`` (a new capture) and
   ``add_objects`` with a third box, which must hold index 3, the memory
   in use growing by far less than one copy of the weights. Prints the
   push's wall p50/p95 and the device's busy ms per push.
7b. export: the same bfloat16 model exported (``io/export.py``) as an
   injectable artifact in chunks of 4 (programs init, chunk_4, chunk_2,
   chunk_1 and memorize), each program's export wall and every file's
   size printed, no program a tenth of the weights' bytes. A fresh
   process (``chip_smoke.py --replay <dir>``, which must import neither
   the port's models and engine nor JAX) loads it, replays a T = 12 uint8
   video with slot 2 injected at frame 5 (counted, again for the bits,
   then three timed calls) and runs a session of 6 steps, one of them
   ``add_objects``. Held against the live ``ChunkedVideoRunner(chunk=4,
   injectable=True)`` and ``StreamingSession`` on the artifact's bases:
   >= 99.9% of index pixels equal (the exact share printed), each kernel's
   launches equal to the live runner's (T - 1), the second replay
   bit-identical; frames/s (median of 3) and peak device memory of the
   replay and the live runner.
8. the evaluator, with the same weights: a DAVIS-shaped tree written to
   disk (3 videos of 12, 17 and 20 JPEG frames at 480x854 with 2, 2 and 3
   moving boxes and their palette-PNG annotations: slot buckets 2 and 4 of
   a budget of 8) and a YouTube-VOS-shaped one (one video of 10 frames at
   720x1280, inferred at 480x848, a second object injected at frame 4).
   Each evaluation runs once to build and warm its runners, then once with
   the launch counts read. bfloat16 ``Evaluator.val``: every frame gets a
   PNG, each kernel launches sum(T - 1) = 46 times, video 0's maps equal a
   direct ``ChunkedVideoRunner`` call on the same frames and bases bit for
   bit, the global J&F is finite, and the ground truth scored as a
   prediction gives J&F 1.000. ``video_batch=2``: T_max - 1 launches per
   batch, >= 99% of sequential per video. Scales (480, 600) with flip on
   video 0: 2 x 2 x (T - 1) launches, the flipped inputs negative-stride
   views. float32 on video 0: >= 99% of the bf16 maps. ``n_kernel=4``,
   sigma 7: K2 launches 0 times, K1 T - 1, the maps differ from
   ``n_kernel=0``. YouTube-VOS: T - 1 launches, only the listed frames
   saved, the injected box holding its annotation id on every pixel. Then
   the evaluation frames/s at a DAVIS val length (2 videos of T = 69, 2
   boxes each, so one batch of two): bfloat16 sequential and
   ``video_batch=2`` in turns, three timed runs each (sum(T - 1) and
   T - 1 launches), and float32; every frame a PNG, indices within the
   video's objects, and the three runs' agreement printed by quarter of
   the video (not gated: over 69 frames at tau = 0.05 one run may part
   from the others).
   Prints the frames/s of each evaluation (the short videos' are smoke
   numbers: they run mostly through the chunk ladder), the phase's peak
   memory and wall time, and the device's idle share in a profiled bf16
   ``evaluate`` of the DAVIS-length videos.
8b. training, the reference's S3 run at full width: a tree in the DAVIS
   and YouTube-VOS training layouts (4 videos each, named from the port's
   subset lists, 8 JPEG frames at 480x854 with 2 moving boxes and their
   palette PNGs). The loader alone (8 spawned workers, batch 8, 384x384
   crops, T = 3, each worker on one OpenMP/BLAS/OpenCV thread): ms per
   batch, beside the loader as it was before its workers were held to one
   thread (the host's thread counts), and ``Trainer.train()``'s wall and ms
   per step before and after. ``Trainer(cfg).train()`` for 10 steps at
   bfloat16 (checkpoints at 5 and 10), TF32 read off inside every module's
   forward and backward by hooks, K1 launched T - 1 = 2 times per step and
   K2 never; a resumed ``Trainer`` from its ``state.pth`` for 2 more steps
   (the step goes on from 10, the losses finite); the ``Evaluator`` on its
   ``variables.pth`` (one video, T - 1 launches each); 10 float32 steps
   with the same checks. One float32 step at B = 2 on the card and on the
   CPU (plain versions) from the same tamed weights (the CPU tests'),
   batch and bases: loss within 1e-3 relative, the gradients' global
   relative L2 difference within 1e-2; beside them, not gated, the card
   step against itself rerun, with K1's plain loop in K1's place and with
   cuDNN's benchmark algorithms. Then, per dtype, ms per step
   (``bench.bench_train``: the median of 6 per-step event spans on a
   staged batch, one sync; and the wall over them), samples/s, peak device
   memory and the device's idle share in one profiled step; remat
   "encoder" and "block" at bfloat16 (K1 2 and 3 launches per step, ms and
   peak memory).
9. the float64 checks of both kernels again, at every shape that phases
   4-8b, 10 and 11 handed them (recorded as they ran; the rank processes
   report theirs): the evaluator's slot buckets, video batches, multi-scale
   and YouTube-VOS pixel counts, the session's grown slots, the training
   shapes (B 8, 4 per rank and 2 at P = 576), the object shards' (N 1 and
   2 per shard, B 1 per grid row, B 2 with one slot in training); tolerances and
   the rerun check as in phases 2 and 3. Where the float32 plain loop
   itself leaves K1's n-round limit on a shape's draw (the training shapes'
   P = 576 at 4 rounds: chaos at tau), that shape is held at 1 round on
   the draw and at n rounds on a draw of x std 0.15, where float32 must
   be within the limit; on any other shape that is a failure. Then both
   kernels at the widths the CLIs take beyond the flagship's, padded inside
   the ops (``NEW_SHAPES``: (Ck, L) = (8, 4), (24, 12), (100, 300), (512,
   128), (256, 512) at P = 576, K2 at Lm = 2 L and Cv 512, so 2 Lm = 2048
   in column blocks at the last): K1 at 1 round at its tight limit and at 4
   rounds where the float32 loop itself is within that limit on the draw
   (else on x std 0.15; else the 4 rounds are reported, not held), K2 in
   the three cases; each rerun for the bits and timed beside its bound.
10. data parallelism, 2 ranks (Gloo, both on ``cuda:0``, on a one-card
   machine; NCCL with one card per rank where there are two or more), each
   rank a process with a timeout (a rank that fails or hangs fails the run)
   printing one JSON line with its launches and the kernel shapes it saw:
   (a) one float32 DDP step at S3 full width (global batch 8, 4 per rank,
   each rank its loader shard and its rows of the global draws, the CPU
   tests' tamed weights) against the one-process step on the same global
   batch and draws on the same card: loss within 1e-3 relative, the
   averaged gradients' global relative L2 difference within 1e-2 (phase
   8b's card-vs-CPU gates), both ranks' parameters and gradients bit-equal;
   (b) ``python -m swem_tpu_torch.train --distributed`` at bfloat16 on phase
   8b's tree (4 loader workers per rank): 10 steps, then 2 resumed, K1 2
   launches per step per rank, K2 none, rank 0 alone writing checkpoints
   and tensorboard files, then the ``Evaluator`` on its ``variables.pth``;
   its ms per step beside phase 8b's one process (Gloo on one card stages
   every gradient bucket through the host: a smoke number); (c) the same
   CLI in one process with the default backend (NCCL) for 2 steps; (d)
   ``python -m swem_tpu_torch.eval --distributed`` over phase 8's DAVIS tree
   sequentially and at ``video_batch=2``: disjoint slices covering the
   videos, K1 and K2 each T_max - 1 launches per batch on each rank (warm-up
   excluded), the PNGs' union against phase 8's one-process bf16 PNGs on
   >= 99.9% of pixels, J&F finite and from rank 0 alone.
11. object parallelism (run before phase 10, inside the shape recording),
   every grid of ``cuda:0`` repeated, each cell its own shard: the bfloat16
   model with 4 slots on a T = 12 uint8 video at 480x854 (two videos for
   B = 2) with four boxes, preprocessed on the card to 480x864.
   ``ChunkedVideoRunner(chunk=4, mesh=)`` on 1x2, 1x4 and 2x2 grids, each
   warmed up, then called once: each kernel n_shards x (T - 1) launches,
   the index maps >= 99% equal to the unsharded runner's on each grid
   row's video (the batch a row holds: at tau = 0.05 a convolution's batch
   size alone moves a few pixels, so the unsharded runner's own B = 2
   against B = 1 share is printed beside); frames/s and peak memory beside
   the unsharded runner's (smoke numbers: the shards share one card). A
   ``StreamingSession`` on 1x2 from 2 slots: 5 pushes, ``grow(4)``,
   ``add_objects`` of slots 3 and 4 (exactly their boxes), 6 pushes, each
   step 2 launches per kernel and >= 99% equal to the unsharded session's,
   which replays its CUDA graph: the profiler's kernel records count its
   12 steps and ``grow(4)``'s capture, 13 per kernel.
   The ``Evaluator`` with ``obj_parallel=2`` and ``eval_devices`` patched
   to [cuda:0, cuda:0] on phase 8's video 0: a 1x2 runner, 2 x (T - 1)
   launches, >= 99% equal to phase 8's PNGs. One float32 S3 train step
   (B = 2, tamed weights) on a 1x2 grid against the unsharded step: loss
   within 1e-3 relative, the gradients' global relative L2 difference
   within 1e-2, K1 2 x (T - 1) launches.
12. offline scoring, the profiling helpers and a converted optimizer state
   (run after phase 11, inside the shape recording): (a) on the card's
   host, where JAX is absent, ``python -m swem_tpu_torch.evaluation_method``
   in a subprocess on phase 8's DAVIS tree and bfloat16 PNGs, its
   ``global_results-DAVIS17.csv`` byte-equal to the one phase 8's
   ``get_metrics`` wrote; the unsupervised task on an
   ``Annotations_unsupervised`` copy of the ground truth with object ids
   permuted, the ground truth's own PNGs as proposals: J&F-Mean 1.000;
   ``python -m swem_tpu_torch.evaluation_codalab`` with the ground truth as
   the submission: ``GlobalMean: 1.000000``. (b) phase 5's bfloat16
   ``run_video`` (T = 10) once under ``utils.profiling.profile_trace``: K1
   and K2 T - 1 launches each, ``device_seconds_from_trace`` of the
   exported Chrome trace within 1% of ``device_busy_seconds`` of the same
   run, ``log_memory`` printed, its peak equal to
   ``torch.cuda.max_memory_allocated`` over the run. (c) flagship moments
   from a seed (mu ~ N(0, 1e-3), nu ~ |N(0, 1e-6)|, count 7, the S3 solver
   with a milestone at 5) through ``io.jax_import.train_snapshot`` and
   ``save_train_checkpoint``; a float32 S3 ``Trainer`` resumed from them on
   the card and on the CPU (plain versions), each taking one step at B = 2
   from phase 8b's tamed weights on the same batch and bases: the moments
   bit-equal to the inputs after the load, ``step`` and the moments placed
   as a native checkpoint's (device, dtype), step 7, LR base_lr *
   gamma; each side's step equal to AdamW's update computed in float64
   from the converted state at step 8 and its own gradients, within a
   float32 bound; card vs CPU the loss within 1e-3 and the gradients and
   the updated parameters within 1e-2 global relative L2 (phase 8b's
   gates), the updates' own gap printed; K1 T - 1 launches, K2 none.
13. one JSON line with every kernel's numbers (``launches`` from the
   bfloat16 run, ``launches_f32`` from the float32 one, ``launches_runner``
   from phase 6's index runner, ``launches_session`` over phase 7's 12
   replayed pushes, by the card's records, ``launches_export`` from phase 7b's replay (equal to the live
   runner's), ``launches_eval`` from phase 8's bfloat16 ``val``,
   ``launches_train`` and ``launches_train_f32`` from phase 8b's 10-step
   runs, ``launches_ddp`` from phase 10's 10-step bfloat16 run and
   ``launches_dist_eval`` from its sequential evaluation, each summed over
   the ranks, ``launches_obj`` from phase 11's three sharded runner calls,
   summed), then the card line, then the final ``{"ok": true, ...}`` line.

    python3 chip_smoke.py --obj-cards

needs two or more cards and runs phase 11's runner grids and session over
distinct cards (shard k on card k mod the count; the shards on cards other
than the model's run copies of it): K1 and K2 at a per-shard shape on each
card bit for bit against cuda:0, then each grid's launches and its index
maps against the unsharded runner and session on cuda:0, as phase 11 holds
them. It prints no JSON lines.
"""

from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
T_VIDEO = 10
T_RUNNER, CHUNK, N_PUSH = 24, 16, 12
# the export phase: an injectable artifact in chunks of EXPORT_CHUNK, a video
# of T_EXPORT frames with slot 2 injected at EXPORT_INJECT_AT, N_EXPORT_PUSH
# session steps; the fresh replay process's bound
T_EXPORT, EXPORT_CHUNK, EXPORT_INJECT_AT, N_EXPORT_PUSH, REPLAY_TIMEOUT_S = 12, 4, 5, 6, 300
IN_SIZE, OUT_SIZE = (480, 864), (480, 854)
# the evaluator phase: DAVIS videos (name, T, moving boxes) at EVAL_HW, run at
# EVAL_IN; multi-scale scales; one YouTube-VOS video with a late object
EVAL_VIDEOS = (("boxes0", 12, 2), ("boxes1", 17, 2), ("boxes2", 20, 3))
EVAL_HW, EVAL_IN, EVAL_SCALES = OUT_SIZE, IN_SIZE, (480, 600)
YT_RAW, YT_SSIZE, YT_T, YT_LATE, YT_LATE_ID = (720, 1280), 480, 10, 4, 5
# the evaluator's timed frames/s at a DAVIS val length (its videos run 25-104)
EVAL_LONG, LONG_REPS = (("long0", 69, 2), ("long1", 69, 2)), 3
# the training phase: the reference's S3 run (batch 8, 384x384 crops, T = 3
# frames per clip, 8 loader workers) on a tree of TRAIN_VIDEOS videos per
# dataset; TRAIN_ITERS = (milestone, max_iter), a checkpoint every TRAIN_SAVE
TRAIN_B, TRAIN_CROP, TRAIN_FRAMES, TRAIN_WORKERS = 8, 384, 3, 8
TRAIN_VIDEOS, TRAIN_FRAMES_ON_DISK = 4, 8
TRAIN_ITERS, TRAIN_SAVE, TRAIN_TIMED, LOADER_BATCHES = (8, 10), 5, 6, 8
# the loader as it was before its workers ran on one thread: batches timed;
# the remat steps timed per mode
VARIANT_BATCHES, REMAT_STEPS = 4, 3
# the data-parallel phase: ranks, loader workers per rank (the host's 8 in
# all), the DDP CLI run's (milestone, max_iter) and a bound on each launch
DDP_WORLD = 2
DDP_WORKERS = TRAIN_WORKERS // DDP_WORLD
DDP_ITERS, RANK_TIMEOUT_S = TRAIN_ITERS, 300
# K1's shapes in training, (B, N, P, Ck, L) at B = 8, a DDP rank's 4 and the
# card-vs-CPU step's B = 2 (and its object shards'): at 4 rounds the float32 plain loop itself leaves
# K1's limit on the x std 0.3 draw (chaos at tau), so phase 9 holds them at
# 4 rounds on a draw of CHAOTIC_X_STD (and at 1 round on the std 0.3 draw)
TRAIN_EM_SHAPES = {(b, 2, (TRAIN_CROP // 16) ** 2, 128, 128)
                   for b in (TRAIN_B, TRAIN_B // DDP_WORLD, 2)}
# ... and phase 11's train step over a 1x2 object grid: B = 2, one slot per shard
TRAIN_EM_SHAPES.add((2, 1, (TRAIN_CROP // 16) ** 2, 128, 128))
CHAOTIC_X_STD = 0.15
# phase 9's new shapes (Ck, L) at B 1, N 2, P NEW_P, K2's Lm = 2 L and Cv 512:
# widths of --key_dim and --num_bases off the flagship's, padded inside the
# ops; K1 also at NEW_ROUNDS rounds
NEW_SHAPES, NEW_P, NEW_ROUNDS = ((8, 4), (24, 12), (100, 300), (512, 128), (256, 512)), 576, 4
# the object-parallel phase: a T_OBJ uint8 video of B = 2 at OUT_SIZE with four
# boxes in four slots, runners in chunks of OBJ_CHUNK over grids (n_data, n_obj)
# of cuda:0 repeated, the session's N_PUSH steps growing 2 -> 4 slots after
# OBJ_GROW_AT pushes
T_OBJ, OBJ_CHUNK, OBJ_GRIDS, OBJ_GROW_AT = 12, 4, ((1, 2), (1, 4), (2, 2)), 5
OBJ_BOXES = ((100, 220, 150, 330), (260, 400, 500, 700), (30, 150, 560, 820), (300, 450, 40, 260))
# peak rates of an H100 (NVIDIA data sheet): FP32 outside the tensor cores, memory,
# dense TF32 on the tensor cores
PEAKS = {"sxm": (67e12, 3.35e12, 495e12), "pcie": (51e12, 2.0e12, 378e12)}
READ_CASES = ("all valid", "update bank invalid", "object never seen")
# phase 12: a bound on each scoring CLI's process
SCORING_TIMEOUT_S = 120
# a run still going after this many seconds prints every thread's stack and
# exits with 1, inside the 1200 s that a run may take
WATCHDOG_S = 1100


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line() -> str:
    """The card's ``nvidia-smi`` name and power limit."""
    import torch
    from swem_tpu_torch.bench import device_line

    return device_line(torch.device("cuda", 0))


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after warm-up.

    A spin kernel of about 1 ms runs before each start event, so the host
    has queued the whole call before the card reaches it: the time is the
    device's alone, without the host's Python and launch gaps."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def compare(name: str, got, ref, rtol: float, atol: float) -> float:
    """Fail unless |got - ref| <= atol + rtol |ref| everywhere; return max |got - ref|."""
    import torch

    got, ref = got.double(), ref.double()
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite values")
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bool(bad.any()):
        fail(f"{name}: {int(bad.sum())} of {bad.numel()} elements outside rtol {rtol} "
             f"atol {atol} (max abs err {float(err.max()):.3e})")
    return float(err.max())


def worst_ratio(got, ref, rtol: float, atol: float) -> float:
    """max |got - ref| / (atol + rtol |ref|): 1.0 is the edge of the tolerance."""
    got, ref = got.double(), ref.double()
    return float(((got - ref).abs() / (atol + rtol * ref.abs())).max())


def bound_ms(flops: float, nbytes: float, peaks) -> tuple:
    t_ops, t_bytes = flops / peaks[0] * 1e3, nbytes / peaks[1] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def em_inputs(rng, B, N, P, Ck, L, x_std, empty_slot=None):
    import torch

    x = rng.standard_normal((B, P, Ck)).astype(np.float32) * np.float32(x_std)
    fg = (rng.random((B, N, P)) > 0.5).astype(np.float32)
    masks = np.stack([1.0 - fg, fg], axis=2)
    if empty_slot is not None:
        masks[:, empty_slot] = 0.0
    kappa0 = rng.standard_normal((B, N, 2, Ck, L)).astype(np.float32)
    kappa0 /= np.linalg.norm(kappa0, axis=-2, keepdims=True) + 1e-6
    zita0 = np.full((B, N, 2, 1, L), 1e-6, np.float32)
    return [torch.from_numpy(a).cuda() for a in (x, masks, kappa0, zita0)]


def em_case(name: str, inputs, n_iters: int, tau: float, tol, empty=None) -> float:
    """K1 on ``inputs`` against its plain version in float64, rerun bit for
    bit; returns the max abs error."""
    import torch
    from swem_tpu_torch.ops import em_kernel

    rtol, atol = tol
    got = em_kernel.em_loop(*inputs, n_iters=n_iters, tau=tau)
    again = em_kernel.em_loop(*inputs, n_iters=n_iters, tau=tau)
    # float64 referee; the float32 plain loop beside it shows the limit's margin
    ref = em_kernel.em_loop_plain(*(t.double() for t in inputs), n_iters=n_iters, tau=tau)
    plain32 = em_kernel.em_loop_plain(*inputs, n_iters=n_iters, tau=tau)
    torch.cuda.synchronize()
    errs = [compare(f"K1 {name} {o}", g, r, rtol, atol)
            for o, g, r in zip(("z", "kappa", "zita"), got, ref)]
    if empty is not None:
        compare(f"K1 {name} empty slot kappa unchanged", got[1][:, empty], inputs[2][:, empty],
                1e-5, 1e-6)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"K1 {name}: two runs on the same inputs gave different bits")
    ratios = [worst_ratio(g, r, rtol, atol) for g, r in zip(got + plain32, ref + ref)]
    print(f"K1 {name}: max abs err vs float64 z {errs[0]:.3e} kappa {errs[1]:.3e} "
          f"zita {errs[2]:.3e}; worst err/limit (z, kappa, zita) kernel {ratios[0]:.3f} "
          f"{ratios[1]:.3f} {ratios[2]:.3f}, float32 plain {ratios[3]:.3f} {ratios[4]:.3f} "
          f"{ratios[5]:.3f}; rerun bit-identical", flush=True)
    return max(errs)


def em_tolerance(n_iters: int) -> tuple:
    """rtol/atol from the JAX package's kernel test: tight for one round; at 4
    rounds tau = 0.05 makes the loop chaotic, so summation-order ulps grow."""
    return (1e-4, 1e-5) if n_iters == 1 else (5e-2, 1e-2)


def em_bound(B, N, P, Ck, L, n_iters: int, peaks) -> tuple:
    """K1's least time at (B, N, P, Ck, L) and ``n_iters`` rounds: (route
    bound ms, its limit, FP32 bound ms, its limit). The E and M products
    each round; the W step's product is the next E step's scaled by 1/|x|
    per pixel, so the least work has no third GEMM. Bytes: x, masks,
    kappa0, zita0 read once; z, kappa, zita written once. The kernel runs
    its products as 3xTF32 on the tensor cores: the route's bound is three
    TF32 products each; the FP32 CUDA-core bound beside it."""
    flops = 2.0 * B * P * Ck * 2 * N * L * 2 * n_iters
    nbytes = 4.0 * (B * P * Ck + B * N * 2 * P + 2 * (B * N * 2 * Ck * L + B * N * 2 * L)
                    + B * N * 2 * P * L)
    return bound_ms(3 * flops, nbytes, (peaks[2], peaks[1])) + bound_ms(flops, nbytes, peaks)


def check_em(peaks) -> dict:
    """K1 against its plain version in float64; returns the kernel's JSON entry."""
    import torch
    from swem_tpu_torch.ops import em_kernel

    rng = np.random.default_rng(0)
    tau = 0.05
    # em_tolerance's bounds. Flagship x has std 0.3 (|x| about 3.4): with std 1
    # even float32 against float64 of the same plain code leaves them at 4 rounds.
    # (B, N, P, Ck, L): flagship; ragged P with narrow Ck and L and an empty
    # slot; the reference's default L = 256; more tile items than CTAs.
    cases = [
        ("flagship 1 round", (1, 2, 1620, 128, 128), 0.3, 1, None, em_tolerance(1)),
        ("flagship 4 rounds", (1, 2, 1620, 128, 128), 0.3, 4, None, em_tolerance(4)),
        ("ragged, empty slot", (2, 8, 130, 16, 8), 1.0, 4, 5, em_tolerance(4)),
        ("flagship L=256", (1, 2, 1620, 128, 256), 0.3, 4, None, em_tolerance(4)),
        ("N=8 P=3600", (1, 8, 3600, 128, 128), 0.3, 4, None, em_tolerance(4)),
    ]
    max_err = 0.0
    for name, shape, x_std, n_iters, empty, tol in cases:
        inputs = em_inputs(rng, *shape, x_std, empty)
        max_err = max(max_err, em_case(name, inputs, n_iters, tau, tol, empty))
    B, N, P, Ck, L = cases[1][1]
    n_iters = 4
    x, masks, kappa0, zita0 = em_inputs(rng, B, N, P, Ck, L, 0.3)
    ms = cuda_ms(lambda: em_kernel.em_loop(x, masks, kappa0, zita0, n_iters=n_iters, tau=tau))
    plain = cuda_ms(lambda: em_kernel.em_loop_plain(x, masks, kappa0, zita0, n_iters=n_iters,
                                                    tau=tau))
    # information only: the loop's 8 products alone as torch.matmul calls (TF32 off)
    k_all = kappa0.permute(0, 3, 1, 2, 4).reshape(B, Ck, N * 2 * L)
    z_all = torch.rand((B, P, N * 2 * L), device="cuda")
    xt = x.transpose(1, 2)

    def products():
        for _ in range(n_iters):
            torch.matmul(x, k_all)
            torch.matmul(xt, z_all)

    matmul_ms = cuda_ms(products)
    b_ms, b_by, fp32_ms, fp32_by = em_bound(B, N, P, Ck, L, n_iters, peaks)
    print(f"K1 time: kernel {ms:.4f} ms (one launch, {2 * n_iters} grid barriers), plain "
          f"{plain:.4f} ms, its 8 products as torch.matmul {matmul_ms:.4f} ms; bound {b_ms:.4f} "
          f"ms ({b_by}, 3xTF32 on the tensor cores), FP32 bound {fp32_ms:.4f} ms ({fp32_by}, "
          f"CUDA cores)", flush=True)
    return {"name": "em_loop", "route": "cuda", "source": "swem_tpu_torch/csrc/em_loop.cu",
            "replaces": "swem_tpu/ops/em_pallas.py:56 (_em_kernel, pallas_call at :196)",
            "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def read_inputs(rng, B, N, P, Ck, Lm, Cv, valid_case):
    """Std-normal qk, mk, mv on the card and base_valid for one of READ_CASES
    (the object never seen is object 1, or object 0 when it is the only one,
    as on an object shard of one slot)."""
    import torch

    qk, mk, mv = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).cuda()
                  for s in ((B, P, Ck), (B, N, 2, Ck, Lm), (B, N, 2, Cv, Lm)))
    valid = torch.ones((B, N, 2, Lm), dtype=torch.bool, device="cuda")
    if valid_case != "all valid":
        valid[:, 0, :, Lm // 2:] = False  # object 0: update bank not yet valid
    if valid_case == "object never seen":
        valid[:, min(1, N - 1)] = False
    return qk, mk, mv, valid


def read_case(name: str, inputs, tau: float) -> float:
    """K2 on ``inputs`` (raw keys, normalized here) against its plain version
    in float64 at rtol 1e-4 / atol 1e-6, rerun bit for bit; returns the max
    abs error."""
    import torch
    from swem_tpu_torch.ops import read_kernel
    from swem_tpu_torch.ops.em_kernel import l2norm

    qk, mk, mv, valid = inputs
    qn, mkn = l2norm(qk, -1), l2norm(mk, -2)
    got = read_kernel.read_normalized(qn, mkn, mv, valid, tau=tau)
    # float64 referee: 3xTF32 and FP32 each lie about 3e-6 from it
    ref = read_kernel.read_plain(qn.double(), mkn.double(), mv.double(), valid, tau=tau)
    again = read_kernel.read_normalized(qn, mkn, mv, valid, tau=tau)
    torch.cuda.synchronize()
    errs = [compare(f"K2 {name} {o}", g, r, 1e-4, 1e-6)
            for o, g, r in zip(("mem_out", "exp_aff"), got, ref)]
    unseen = min(1, valid.shape[1] - 1)
    if not valid[:, unseen].any() and bool(got[0][:, unseen].any() or got[1][:, unseen].any()):
        fail(f"K2 {name}: an object with no valid base must read exactly 0")
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"K2 {name}: two runs on the same inputs gave different bits")
    plain32 = read_kernel.read_plain(qn, mkn, mv, valid, tau=tau)
    ratios = [worst_ratio(g, r, 1e-4, 1e-6) for g, r in zip(got + plain32, ref + ref)]
    print(f"K2 {name}: max abs err vs float64 mem_out {errs[0]:.3e} "
          f"exp_aff {errs[1]:.3e}; worst err/limit (mem_out, exp_aff) kernel "
          f"{ratios[0]:.3f} {ratios[1]:.3f}, float32 plain {ratios[2]:.3f} "
          f"{ratios[3]:.3f}; rerun bit-identical", flush=True)
    return max(errs)


def read_bound(B, N, P, Ck, Lm, Cv, peaks) -> tuple:
    """K2's least time at (B, N, P, Ck, Lm, Cv): (route bound ms, its limit,
    FP32 bound ms, its limit). The affinity and the value read; bytes: qk,
    mk, mv and base_valid read once, mem_out and exp_aff written once. The
    kernel runs its products as 3xTF32 on the tensor cores (three TF32
    products each); the FP32 CUDA-core bound beside it."""
    flops = B * (2.0 * P * Ck * (2 * N * Lm) + 2.0 * P * (2 * Lm) * Cv * N)
    nbytes = 4.0 * (B * P * Ck + B * N * 2 * Lm * (Ck + Cv) + B * N * P * Cv + B * N * 2 * Lm * P) \
        + B * N * 2 * Lm
    return bound_ms(3 * flops, nbytes, (peaks[2], peaks[1])) + bound_ms(flops, nbytes, peaks)


def check_read(peaks) -> dict:
    """K2 against its plain version in float64; returns the kernel's JSON entry."""
    import torch
    import torch.nn.functional as F
    from swem_tpu_torch.ops import read_kernel
    from swem_tpu_torch.ops.em_kernel import l2norm

    rng = np.random.default_rng(1)
    tau = 0.05
    # (B, N, P, Ck, Lm, Cv): flagship; ragged P, narrow Ck, Lm and Cv; 2 Lm > 512
    shapes = (("flagship", (1, 2, 1620, 128, 256, 512)), ("ragged Cv=8", (2, 8, 130, 16, 16, 8)),
              ("ragged Cv=64", (2, 8, 130, 16, 16, 64)), ("Lm=512", (1, 2, 300, 128, 512, 512)))
    max_err = 0.0
    for shape_name, shape in shapes:
        for valid_case in READ_CASES:
            inputs = read_inputs(rng, *shape, valid_case)
            max_err = max(max_err, read_case(f"{shape_name}, {valid_case}", inputs, tau))
    # the tolerance's margin over more flagship draws, for the kernel and for
    # the float32 plain read: reported, not checked (float32 itself sits near 1)
    for seed in range(2, 10):
        qk, mk, mv, valid = read_inputs(np.random.default_rng(seed), *shapes[0][1], "all valid")
        qn, mkn = l2norm(qk, -1), l2norm(mk, -2)
        ref = read_kernel.read_plain(qn.double(), mkn.double(), mv.double(), valid, tau=tau)
        routes = (("kernel", read_kernel.read_normalized(qn, mkn, mv, valid, tau=tau)),
                  ("float32 plain", read_kernel.read_plain(qn, mkn, mv, valid, tau=tau)))
        print(f"K2 margin, flagship seed {seed}: worst err/limit (mem_out, exp_aff) " + "; ".join(
            f"{route} {worst_ratio(out[0], ref[0], 1e-4, 1e-6):.3f} "
            f"{worst_ratio(out[1], ref[1], 1e-4, 1e-6):.3f}" for route, out in routes), flush=True)
    B, N, P, Ck, Lm, Cv = shapes[0][1]
    qk, mk, mv, valid = read_inputs(rng, *shapes[0][1], "all valid")
    qn, mkn = l2norm(qk, -1), l2norm(mk, -2)
    ms = cuda_ms(lambda: read_kernel.read_normalized(qn, mkn, mv, valid, tau=tau))
    wrapper = cuda_ms(lambda: read_kernel.read_affinity(qk, mk, mv, valid, tau=tau))
    plain = cuda_ms(lambda: read_kernel.read_plain(qn, mkn, mv, valid, tau=tau))
    # yardstick: one library attention call for mem_out on the same normalized keys
    q = qn[:, None].expand(B, N, P, Ck).reshape(B * N, 1, P, Ck).contiguous()
    k = mkn.transpose(-1, -2).reshape(B * N, 1, 2 * Lm, Ck).contiguous()
    v = mv.transpose(-1, -2).reshape(B * N, 1, 2 * Lm, Cv).contiguous()
    mask = valid.reshape(B * N, 1, 1, 2 * Lm)
    library = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                             scale=1.0 / tau))
    b_ms, b_by, fp32_ms, fp32_by = read_bound(B, N, P, Ck, Lm, Cv, peaks)
    print(f"K2 time: kernel {ms:.4f} ms, wrapper (normalization + kernel) {wrapper:.4f} ms, "
          f"plain {plain:.4f} ms, sdpa {library:.4f} ms; bound {b_ms:.4f} ms ({b_by}, 3xTF32 "
          f"on the tensor cores), FP32 bound {fp32_ms:.4f} ms ({fp32_by}, CUDA cores)", flush=True)
    return {"name": "read_memory", "route": "cuda", "source": "swem_tpu_torch/csrc/read_memory.cu",
            "replaces": "swem_tpu/ops/read_pallas.py:57 (_read_kernel, pallas_call at :161)",
            "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library, "wrapper_ms": wrapper}


@contextlib.contextmanager
def recording_shapes(log: dict):
    """Record into ``log`` ({kernel name: set of keys}) the shapes that the
    paths run inside hand each kernel's wrapper on the card, so that
    ``check_path_shapes`` can hold the kernels against float64 at each of
    them. The wrappers and their launch counts are untouched."""
    from swem_tpu_torch.models import em
    from swem_tpu_torch.ops import read_kernel

    em_loop, read_normalized = em.em_loop, read_kernel.read_normalized

    def em_seen(x, masks, kappa0, zita0, *, n_iters, tau):
        if x.is_cuda:
            B, P, Ck = x.shape
            log["em_loop"].add((B, masks.shape[1], P, Ck, kappa0.shape[-1], n_iters, tau))
        return em_loop(x, masks, kappa0, zita0, n_iters=n_iters, tau=tau)

    def read_seen(qk, mk, mv, base_valid, *, tau):
        if qk.is_cuda:
            B, P, Ck = qk.shape
            log["read_memory"].add((B, mk.shape[1], P, Ck, mk.shape[-1], mv.shape[-2], tau))
        return read_normalized(qk, mk, mv, base_valid, tau=tau)

    em.em_loop, read_kernel.read_normalized = em_seen, read_seen
    try:
        yield
    finally:
        em.em_loop, read_kernel.read_normalized = em_loop, read_normalized


def plain32_ratio(inputs, n_iters: int, tau: float, tol) -> float:
    """The float32 plain loop's worst err/limit against float64 on ``inputs``."""
    import torch
    from swem_tpu_torch.ops import em_kernel

    plain32 = em_kernel.em_loop_plain(*inputs, n_iters=n_iters, tau=tau)
    ref = em_kernel.em_loop_plain(*(t.double() for t in inputs), n_iters=n_iters, tau=tau)
    torch.cuda.synchronize()
    return max(worst_ratio(g, r, *tol) for g, r in zip(plain32, ref))


def check_path_shapes(log: dict, peaks) -> dict:
    """Both kernels against their plain versions in float64 at every shape
    the paths handed them (``recording_shapes``): the evaluator's slot
    buckets, video batches, multi-scale and YouTube-VOS sizes among them.
    Tolerances and the rerun check are ``check_em``'s and ``check_read``'s;
    a bucket wider than 2 slots leaves its last slot empty, as padding does.
    Returns each kernel's max abs error."""
    rng = np.random.default_rng(2)
    errs = {"em_loop": 0.0, "read_memory": 0.0}
    for B, N, P, Ck, L, n_iters, tau in sorted(log["em_loop"]):
        empty = N - 1 if N > 2 else None
        name = f"path shape (B, N, P, Ck, L) {(B, N, P, Ck, L)}, {n_iters} rounds"
        inputs = em_inputs(rng, B, N, P, Ck, L, 0.3, empty)
        # the referee must be able to tell the kernel from float32: where the
        # float32 plain loop itself leaves the n-round limit on this draw
        # (chaos at tau), a training shape is held at 1 round on this draw
        # and at n rounds on a draw of x std CHAOTIC_X_STD; any other shape fails
        tol = em_tolerance(n_iters)
        yardstick = plain32_ratio(inputs, n_iters, tau, tol)
        if yardstick > 1.0:
            if (B, N, P, Ck, L) not in TRAIN_EM_SHAPES:
                fail(f"K1 {name}: the float32 plain loop itself is at {yardstick:.3f} of the "
                     f"limit on the x std 0.3 draw; only the training shapes "
                     f"{sorted(TRAIN_EM_SHAPES)} may be held on a narrower draw")
            print(f"K1 {name}: the float32 plain loop itself is at {yardstick:.3f} of the limit "
                  f"on the x std 0.3 draw (chaotic); held at 1 round on it and at {n_iters} "
                  f"rounds on a draw of x std {CHAOTIC_X_STD}", flush=True)
            errs["em_loop"] = max(errs["em_loop"], em_case(
                name.replace(f"{n_iters} rounds", "1 round"), inputs, 1, tau, em_tolerance(1),
                empty))
            inputs = em_inputs(rng, B, N, P, Ck, L, CHAOTIC_X_STD, empty)
            name += f", x std {CHAOTIC_X_STD}"
            yardstick = plain32_ratio(inputs, n_iters, tau, tol)
            if yardstick > 1.0:
                fail(f"K1 {name}: the float32 plain loop itself is at {yardstick:.3f} of the "
                     f"limit: this draw cannot tell the kernel from float32")
        errs["em_loop"] = max(errs["em_loop"], em_case(name, inputs, n_iters, tau, tol, empty))
        if (B, N, P, Ck, L) in TRAIN_EM_SHAPES:
            from swem_tpu_torch.ops import em_kernel

            ms = cuda_ms(lambda: em_kernel.em_loop(*inputs, n_iters=n_iters, tau=tau))
            b_ms, b_by, fp32_ms, fp32_by = em_bound(B, N, P, Ck, L, n_iters, peaks)
            print(f"K1 time at the training shape {(B, N, P, Ck, L)}, {n_iters} rounds: kernel "
                  f"{ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}, 3xTF32), FP32 bound "
                  f"{fp32_ms:.4f} ms ({fp32_by})", flush=True)
    for B, N, P, Ck, Lm, Cv, tau in sorted(log["read_memory"]):
        for valid_case in READ_CASES:
            name = f"path shape (B, N, P, Ck, Lm, Cv) {(B, N, P, Ck, Lm, Cv)}, {valid_case}"
            inputs = read_inputs(rng, B, N, P, Ck, Lm, Cv, valid_case)
            errs["read_memory"] = max(errs["read_memory"], read_case(name, inputs, tau))
    print(f"path shapes checked against float64: em_loop {sorted(log['em_loop'])}, "
          f"read_memory {sorted(log['read_memory'])}", flush=True)
    return errs


def check_new_shapes(peaks) -> dict:
    """Both kernels against their plain versions in float64 at NEW_SHAPES,
    widths that the CLIs take and the kernels reach padded (Ck to 16 or 4, L
    to 8, Lm to 4), in 16-pixel tiles (K1 at Ck 512, or Ck 256 with L 512)
    or in column blocks (K2 above 2 Lm = 1024). K1 at 1 round at its tight
    limit, and at NEW_ROUNDS rounds where the float32 plain loop itself is
    within that limit on the draw (else, as for the training shapes, on a
    draw of x std CHAOTIC_X_STD; where float32 leaves it there too, the
    rounds are reported, not held); K2 in the three READ_CASES. Each case is
    rerun for the bits and timed beside its bound. Returns each kernel's max
    abs error."""
    from swem_tpu_torch.ops import em_kernel, read_kernel
    from swem_tpu_torch.ops.em_kernel import l2norm

    rng = np.random.default_rng(4)
    tau, n = 0.05, NEW_ROUNDS
    B, N, P, Cv = 1, 2, NEW_P, 512
    errs = {"em_loop": 0.0, "read_memory": 0.0}
    for Ck, L in NEW_SHAPES:
        name = f"new shape (B, N, P, Ck, L) {(B, N, P, Ck, L)}"
        inputs = em_inputs(rng, B, N, P, Ck, L, 0.3)
        errs["em_loop"] = max(errs["em_loop"], em_case(f"{name}, 1 round", inputs, 1, tau,
                                                       em_tolerance(1)))
        held = None
        for x_std in (0.3, CHAOTIC_X_STD):
            draw = inputs if x_std == 0.3 else em_inputs(rng, B, N, P, Ck, L, x_std)
            yardstick = plain32_ratio(draw, n, tau, em_tolerance(n))
            if yardstick <= 1.0:
                held = x_std
                errs["em_loop"] = max(errs["em_loop"], em_case(
                    f"{name}, {n} rounds, x std {x_std}", draw, n, tau, em_tolerance(n)))
                break
            got = em_kernel.em_loop(*draw, n_iters=n, tau=tau)
            ref = em_kernel.em_loop_plain(*(t.double() for t in draw), n_iters=n, tau=tau)
            kernel = max(worst_ratio(g, r, *em_tolerance(n)) for g, r in zip(got, ref))
            print(f"K1 {name}, {n} rounds, x std {x_std}: the float32 plain loop itself is at "
                  f"{yardstick:.3f} of the limit (chaotic at tau), the kernel at {kernel:.3f}",
                  flush=True)
        if held is None:
            print(f"K1 {name}: not held at {n} rounds (float32 itself leaves the limit on both "
                  f"draws); held at 1 round", flush=True)
        ms = cuda_ms(lambda: em_kernel.em_loop(*inputs, n_iters=n, tau=tau))
        b_ms, b_by, fp32_ms, fp32_by = em_bound(B, N, P, Ck, L, n, peaks)
        print(f"K1 time at the new shape {(B, N, P, Ck, L)}, {n} rounds, "
              f"{em_kernel.kernel_tile(Ck, L)}-pixel tiles: kernel {ms:.4f} ms; bound {b_ms:.4f} "
              f"ms ({b_by}, 3xTF32), FP32 bound {fp32_ms:.4f} ms ({fp32_by})", flush=True)

        Lm = 2 * L
        for valid_case in READ_CASES:
            draw = read_inputs(rng, B, N, P, Ck, Lm, Cv, valid_case)
            errs["read_memory"] = max(errs["read_memory"], read_case(
                f"new shape (B, N, P, Ck, Lm, Cv) {(B, N, P, Ck, Lm, Cv)}, {valid_case}", draw,
                tau))
        qn, mkn = l2norm(draw[0], -1), l2norm(draw[1], -2)
        ms = cuda_ms(lambda: read_kernel.read_normalized(qn, mkn, draw[2], draw[3], tau=tau))
        b_ms, b_by, fp32_ms, fp32_by = read_bound(B, N, P, Ck, Lm, Cv, peaks)
        print(f"K2 time at the new shape {(B, N, P, Ck, Lm, Cv)}: kernel {ms:.4f} ms; bound "
              f"{b_ms:.4f} ms ({b_by}, 3xTF32), FP32 bound {fp32_ms:.4f} ms ({fp32_by})",
              flush=True)
    return errs


def drive(model, frames, init_mask, active, card: str, label: str):
    """One main path: a checked warm-up pass, then the timed ``run_video``
    with every launch count set to 0 just before it and read just after.
    Returns (preds, launches)."""
    import torch
    from swem_tpu_torch import engine

    # warm-up pass: every module's output finite, and TF32 off inside every
    # forward with PyTorch's default flags in force outside
    bad, tf32, calls = [], [], [0]

    def guard_hook(mod, _inp, out):
        calls[0] += 1
        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
            tf32.append(type(mod).__name__)
        outs = out if isinstance(out, tuple) else (out,)
        if any(isinstance(o, torch.Tensor) and not bool(torch.isfinite(o).all()) for o in outs):
            bad.append(type(mod).__name__)

    hooks = [m.register_forward_hook(guard_hook) for m in model.modules()]
    mem = engine.init_memory(model, torch.Generator().manual_seed(1), frames[0], init_mask, active)
    mem, _, _ = engine.run_chunk(model, mem, frames[1:], active, OUT_SIZE)
    for h in hooks:
        h.remove()
    for bank in (mem.first, mem.update):
        for t in (bank.kappa, bank.nu, bank.zita):
            if t.dtype != torch.float32:
                fail(f"{label} main path: the memory is {t.dtype}, expected float32")
            if not bool(torch.isfinite(t).all()):
                bad.append("memory")
    if bad:
        fail(f"{label} main path: non-finite values in {sorted(set(bad))}")
    if tf32 or not calls[0]:
        fail(f"{label} main path: TF32 on inside {sorted(set(tf32))} ({calls[0]} forwards)")
    print(f"{label} main path: TF32 off in all {calls[0]} module forwards (outside: "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}); every output "
          f"finite; memory float32", flush=True)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    preds, launches = counted(
        lambda: engine.run_video(model, torch.Generator().manual_seed(1), frames, init_mask,
                                 active, OUT_SIZE), T_VIDEO - 1, f"{label} main path")
    dt = time.perf_counter() - t0
    if preds.shape != (T_VIDEO - 1, 1) + OUT_SIZE or preds.dtype != torch.uint8:
        fail(f"{label} main path: preds {tuple(preds.shape)} {preds.dtype}")
    if int(preds.max()) > model.cfg.max_objs:
        fail(f"{label} main path: index out of range")
    print(f"{label} main path: run_video T={T_VIDEO} in {dt:.3f} s = {T_VIDEO / dt:.2f} frames/s "
          f"(smoke number, not a benchmark) on {card}; launches {launches}", flush=True)
    return preds, launches


def main_path(card: str) -> tuple:
    """Flagship run_video on the card in float32, then in bfloat16; returns
    the kernels' launch counts of each run."""
    import torch
    from swem_tpu_torch import engine
    from swem_tpu_torch.bench import synthetic_video
    from swem_tpu_torch.config import ModelConfig
    from swem_tpu_torch.models.swem import SWEM
    from swem_tpu_torch.ops import em_kernel, read_kernel

    cfg = ModelConfig()
    model = SWEM(cfg).init_weights(0)  # device None: CUDA
    # the benchmark's video (two boxes), T = 10
    frames_np, mask_np = synthetic_video(T_VIDEO, IN_SIZE, OUT_SIZE, cfg.max_objs)
    frames = torch.from_numpy(frames_np).cuda()
    init_mask = torch.from_numpy(mask_np).cuda()
    active = torch.ones((1, cfg.max_objs), dtype=torch.bool, device="cuda")
    preds, launches = drive(model, frames, init_mask, active, card, "float32")

    # the same weights and draw on the CPU, plain versions, first 3 frames
    cpu = SWEM(cfg, device="cpu")
    cpu.load_state_dict(model.state_dict())
    t0 = time.perf_counter()
    ref = engine.run_video(cpu, torch.Generator().manual_seed(1), frames[:3].cpu(),
                           init_mask.cpu(), active.cpu(), OUT_SIZE)
    same = float((ref == preds[:2].cpu()).double().mean())
    counts = lambda p: np.bincount(p.flatten().numpy(), minlength=cfg.max_objs + 1).tolist()  # noqa: E731
    print(f"CPU rerun of frames 0-2 ({time.perf_counter() - t0:.1f} s): identical index pixels "
          f"{same:.6f}; per-label pixels card {counts(preds[:2].cpu())} cpu {counts(ref)}",
          flush=True)
    if same < 0.99:
        fail(f"main path: only {same:.4f} of index pixels agree with the CPU run")
    if em_kernel.launches != T_VIDEO - 1 or read_kernel.launches != T_VIDEO - 1:
        fail("the CPU run must not launch kernels")
    profile_main_path(model, frames, init_mask, active, "float32")

    # the configuration users run: the same seeded weights at bfloat16
    bf16 = SWEM(ModelConfig(dtype="bfloat16")).init_weights(0)
    preds16, launches16 = drive(bf16, frames, init_mask, active, card, "bfloat16")
    flip = (preds16 != preds).flatten(1).double().mean(dim=1).cpu().numpy()  # per frame
    early, late = float(flip[:3].mean()), float(flip[-3:].mean())
    print(f"bfloat16 against float32 on the card: index pixels that differ per frame "
          f"{' '.join(f'{f:.6f}' for f in flip)}; over the video {flip.mean():.6f}, first 3 "
          f"frames {early:.6f}, last 3 {late:.6f}; per-label pixels bf16 {counts(preds16.cpu())}",
          flush=True)
    profile_main_path(bf16, frames, init_mask, active, "bfloat16")
    # the JAX package's own bf16-versus-f32 bounds (tests/test_bf16_margin.py)
    if flip.mean() >= 0.01:
        fail(f"bfloat16 main path: {flip.mean():.4f} of index pixels differ from float32")
    if late > 3.0 * early + 1e-4:
        fail(f"bfloat16 main path: the disagreement grows through the video: first 3 frames "
             f"{early:.4f}, last 3 {late:.4f}")
    return launches16, launches, bf16


def counted(fn, expect, label: str):
    """Run ``fn`` with every launch count set to 0 just before it and read
    just after; fail unless each kernel launched ``expect`` times (one count
    for both, or a dict by kernel). Returns (fn's result, the counts)."""
    import torch
    from swem_tpu_torch.ops import em_kernel, read_kernel

    em_kernel.launches = read_kernel.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {"em_loop": em_kernel.launches, "read_memory": read_kernel.launches}
    for name, n in launches.items():
        want = expect[name] if isinstance(expect, dict) else expect
        if n != want:
            fail(f"{label}: kernel {name} launched {n} times, expected {want}")
    return out, launches


def kernels_ran(fn):
    """Run ``fn`` under the profiler; returns (fn's result, the card's
    records of each kernel): the launches that ran, from the host or
    replayed from a CUDA graph, which ``counted``'s host counts miss."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, {k: sum(bool(re.search(rf"\b{kernel}\b", n)) for n in names)
                 for k, kernel in (("em_loop", "em_loop_kernel"), ("read_memory", "read_kernel"))}


def runner_path(model, card: str) -> dict:
    """Phase 6: the chunked runner at bfloat16; returns the index runner's
    launch counts."""
    import torch
    from swem_tpu_torch import engine
    from swem_tpu_torch.bench import box_mask, uint8_frames
    from swem_tpu_torch.ops.resize import resize

    n = model.cfg.max_objs
    frames = uint8_frames((T_RUNNER, 1) + OUT_SIZE + (3,), 1)  # host, raw 480x854
    mask, active = box_mask(OUT_SIZE, n), np.ones((1, n), bool)

    def pre(f):
        return resize(f.float() / 255.0, IN_SIZE, "bicubic")

    def runner(**kw):
        r = engine.ChunkedVideoRunner(model, OUT_SIZE, chunk=CHUNK, preprocess=pre, **kw)
        r.warmup(OUT_SIZE, 1, n, np.uint8)
        return r

    index, scores, injectable = runner(), runner(scores=True), runner(injectable=True)
    gen = lambda: torch.Generator().manual_seed(1)  # noqa: E731
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    preds, launches = counted(lambda: index(gen(), frames, mask, active), T_RUNNER - 1,
                              "runner")
    dt = time.perf_counter() - t0
    runner_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    if preds.shape != (T_RUNNER - 1, 1) + OUT_SIZE or preds.dtype != np.uint8:
        fail(f"runner: preds {preds.shape} {preds.dtype}, expected host uint8")

    torch.cuda.reset_peak_memory_stats()
    x = pre(torch.from_numpy(frames).cuda())
    ref = engine.run_video(model, gen(), x, torch.from_numpy(mask).cuda(),
                           torch.from_numpy(active).cuda(), OUT_SIZE).cpu().numpy()
    video_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    del x
    same = float((preds == ref).mean())
    print(f"runner (bfloat16): T={T_RUNNER} as {index._sizes(T_RUNNER - 1)} in {dt:.3f} s = "
          f"{T_RUNNER / dt:.2f} frames/s with uploads and the fetch (smoke number) on {card}; "
          f"launches {launches}; index pixels identical to run_video's {same:.6f}; peak device "
          f"memory runner {runner_peak:.1f} MB, run_video {video_peak:.1f} MB (frames "
          f"preprocessed on the card beforehand)", flush=True)
    if same < 0.99:
        fail(f"runner: only {same:.4f} of index pixels agree with run_video")

    soft, _ = counted(lambda: scores(gen(), frames, mask, active), T_RUNNER - 1, "scores runner")
    if soft.dtype != torch.float32 or soft.shape != (T_RUNNER - 1, 1) + OUT_SIZE + (n + 1,):
        fail(f"scores runner: {soft.dtype} {tuple(soft.shape)}")
    if not np.array_equal(soft.argmax(-1).to(torch.uint8).cpu().numpy(), preds):
        fail("scores runner: its argmax differs from the index runner's maps")

    first = mask.copy()  # slot 2 absent from frame 0, injected at frame 6
    first[..., 0] += first[..., 2]
    first[..., 2] = 0.0
    idx_map = (mask[..., 2] > 0).astype(np.uint8) * 2
    injections = {6: (idx_map, np.asarray([[False, True]]))}
    got, _ = counted(lambda: injectable(gen(), frames, first, np.asarray([[True, False]]),
                                        injections), T_RUNNER - 1, "injectable runner")
    box = idx_map[0] > 0
    if not (got[5, 0][box] == 2).all() or (got[:5] == 2).any():
        fail("injectable runner: slot 2 is not exactly its injected box at frame 6")
    print(f"runner (bfloat16): scores runner's argmax equals the index maps bit for bit; "
          f"injected slot 2 holds all {int(box.sum())} pixels of its box at frame 6, and "
          f"{float((got[6:] == 2).mean()):.4f} of pixels after it", flush=True)
    return launches


def session_path(model, card: str) -> dict:
    """Phase 7: the streaming session at bfloat16, whose pushes replay its
    CUDA graph; returns the card's K1 and K2 records summed over 12 replayed
    pushes."""
    import torch
    from swem_tpu_torch import engine
    from swem_tpu_torch.bench import box_mask, uint8_frames
    from swem_tpu_torch.ops.resize import resize
    from swem_tpu_torch.serve import StreamingSession, measure_device_latency

    cfg = model.cfg
    frames = uint8_frames((N_PUSH + 2,) + OUT_SIZE + (3,), 2)
    labels = box_mask(OUT_SIZE, cfg.max_objs)[0].argmax(-1).astype(np.uint8)
    sess = StreamingSession(cfg, model.state_dict(), raw_hw=OUT_SIZE, in_size=IN_SIZE,
                            out_size=OUT_SIZE, n_slots=cfg.max_objs)
    sess.warmup()
    sess.start(frames[0], labels)

    def pre(f):  # the session's own preprocess, frame by frame
        return resize(torch.from_numpy(f[None]).cuda().float() / 255.0, IN_SIZE, "bicubic")

    onehot = torch.from_numpy(box_mask(OUT_SIZE, cfg.max_objs)).cuda()
    active = torch.ones((1, cfg.max_objs), dtype=torch.bool, device="cuda")
    mem = engine.init_memory(model, torch.Generator().manual_seed(0), pre(frames[0]), onehot,
                             active)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall, shares = [], []
    for f in frames[1:N_PUSH + 1]:
        t0 = time.perf_counter()
        got, _ = counted(lambda: sess.push(f), 0, "session push (a replay)")
        wall.append((time.perf_counter() - t0) * 1e3)
        mem, ref, _ = engine.step(model, mem, pre(f), active, OUT_SIZE)
        shares.append(float((got == ref[0].cpu().numpy()).mean()))
    peak2 = torch.cuda.max_memory_allocated() / 2 ** 20
    _, totals = kernels_ran(lambda: [sess.push(f) for f in frames[1:N_PUSH + 1]])
    print(f"session (bfloat16): {N_PUSH} pushes, index pixels identical to init_memory + step "
          f"per frame {' '.join(f'{s:.6f}' for s in shares)}; host launches 0 per push (each "
          f"replays the session's graph); the card's kernel records over {N_PUSH} more replayed "
          f"pushes {totals}", flush=True)
    if min(shares) < 0.99:
        fail(f"session: only {min(shares):.4f} of a frame's pixels agree with step")
    if totals != {k: N_PUSH for k in totals}:
        fail(f"session: the card ran {totals} over {N_PUSH} replayed pushes, expected one each")
    busy = measure_device_latency(sess, frames[0], labels, frames[1:N_PUSH + 1])

    weights = sum(t.numel() * t.element_size() for t in sess.model.state_dict().values())
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sess.prepare_grow(3)
    sess.grow(3)
    grown = torch.cuda.memory_allocated() - held
    third = np.zeros(OUT_SIZE, np.uint8)
    third[20:90, 600:800] = 3
    t0 = time.perf_counter()
    got = sess.add_objects(frames[N_PUSH + 1], third, [3])
    first_ms = (time.perf_counter() - t0) * 1e3
    peak3 = torch.cuda.max_memory_allocated() / 2 ** 20
    t0 = time.perf_counter()
    sess.push(frames[N_PUSH])
    next_ms = (time.perf_counter() - t0) * 1e3
    if not (got[third > 0] == 3).all():
        fail("session: the injected slot 3 does not hold its box")
    if grown >= weights / 2:
        fail(f"session: grow(3) added {grown / 2 ** 20:.1f} MB, a second copy of the weights "
             f"({weights / 2 ** 20:.1f} MB)?")
    print(f"session (bfloat16): push wall p50 {np.percentile(wall, 50):.3f} ms, p95 "
          f"{np.percentile(wall, 95):.3f} ms (with the map on the host; smoke numbers); device "
          f"busy {busy:.3f} ms per push; grow(3) after prepare_grow(3) added {grown / 2 ** 20:.3f}"
          f" MB in use (weights {weights / 2 ** 20:.1f} MB); peak {peak2:.1f} MB over the "
          f"2-slot pushes, {peak3:.1f} MB over prepare_grow + grow + the first 3-slot "
          f"add_objects ({first_ms:.1f} ms wall; the 3-slot push after it {next_ms:.1f} ms), "
          f"which holds slot 3 on all {int((third > 0).sum())} pixels of its box; on {card}",
          flush=True)
    return totals


def export_path(model, card: str) -> dict:
    """Phase 7b: the bfloat16 model exported as an injectable artifact and
    replayed in a fresh process (``--replay``), held against the live
    runner and session on the same bases; returns the replay's launch
    counts."""
    import shutil
    import subprocess

    import torch
    from swem_tpu_torch import engine
    from swem_tpu_torch.bench import box_mask, uint8_frames
    from swem_tpu_torch.io.export import export_runner
    from swem_tpu_torch.models import em
    from swem_tpu_torch.ops.resize import resize
    from swem_tpu_torch.serve import StreamingSession

    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke_export"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    art = work / "art"
    n = model.cfg.max_objs

    def pre(f):
        return resize(f.float() / 255.0, IN_SIZE, "bicubic")

    manifest = export_runner(model, str(art), frame_hw=OUT_SIZE, out_size=OUT_SIZE,
                             chunk=EXPORT_CHUNK, preprocess=pre, injectable=True)
    sizes = {str(f.relative_to(art)): f.stat().st_size / 2 ** 20
             for f in sorted(art.rglob("*")) if f.is_file()}
    print(f"export (bfloat16, injectable, chunk {EXPORT_CHUNK}, programs "
          f"{['init'] + [f'chunk_{k}' for k in manifest['sizes']] + ['memorize']}): export wall "
          + ", ".join(f"{k} {v:.1f} s" for k, v in manifest["export_seconds"].items())
          + "; files " + ", ".join(f"{k} {v:.2f} MB" for k, v in sizes.items()), flush=True)
    weights_mb = sizes["weights.pt"]
    if any(v >= weights_mb / 10 for k, v in sizes.items() if k.startswith("programs")):
        fail("export: a program file holds a tenth of the weights' bytes or more")

    # slot 2 absent from frame 0 and injected at EXPORT_INJECT_AT
    frames = uint8_frames((T_EXPORT, 1) + OUT_SIZE + (3,), 3)
    mask = box_mask(OUT_SIZE, n)
    first = mask.copy()
    first[..., 0] += first[..., 2]
    first[..., 2] = 0.0
    idx_map = (mask[..., 2] > 0).astype(np.uint8) * 2
    active = np.asarray([[True, False]])
    new = np.asarray([[False, True]])
    labels = first[0].argmax(-1).astype(np.uint8)
    np.savez(work / "video.npz", frames=frames, first=first, active=active, idx_map=idx_map,
             new=new, labels=labels)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--replay", str(work)],
                          cwd=ROOT, capture_output=True, text=True, timeout=REPLAY_TIMEOUT_S)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-6000:], file=sys.stderr, flush=True)
        fail(f"export: the replay process exited with {proc.returncode}")
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"export: fresh replay process ({time.perf_counter() - t0:.1f} s wall): "
          f"{json.dumps(rep)}", flush=True)
    got = np.load(work / "replay.npz")

    bases = em.Bases(*torch.load(art / "bases.pt"))
    injections = {EXPORT_INJECT_AT: (idx_map, new)}
    live = engine.ChunkedVideoRunner(model, OUT_SIZE, chunk=EXPORT_CHUNK, preprocess=pre,
                                     injectable=True)
    live.warmup(OUT_SIZE, 1, n, np.uint8)

    def run():
        return live(None, frames, first, active, injections, bases=bases)

    want, launches = counted(run, T_EXPORT - 1, "live injectable runner (chunk 4)")
    if rep["launches"] != launches:
        fail(f"export: the replay launched {rep['launches']}, the live runner {launches}")
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2 ** 20
    torch.cuda.reset_peak_memory_stats()
    wall = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        wall.append(time.perf_counter() - t0)
    live_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    same = float((got["preds"] == want).mean())
    box = idx_map[0] > 0
    if not (got["preds"][EXPORT_INJECT_AT - 1, 0][box] == 2).all():
        fail("export: the injected slot 2 does not hold its box in the replay")

    sess = StreamingSession(model.cfg, model.state_dict(), raw_hw=OUT_SIZE, in_size=IN_SIZE,
                            out_size=OUT_SIZE, n_slots=n)
    sess.start(frames[0, 0], labels, bases=bases)
    live_steps = [sess.add_objects(frames[t, 0], idx_map[0], [2]) if t == EXPORT_INJECT_AT
                  else sess.push(frames[t, 0]) for t in range(1, N_EXPORT_PUSH + 1)]
    same_sess = float((got["session"] == np.stack(live_steps)).mean())
    fps_live = T_EXPORT / float(np.median(wall))
    print(f"export (bfloat16): replay index pixels equal to the live ChunkedVideoRunner's "
          f"{same:.6f} (gate 0.999), the replayed session's to the live StreamingSession's "
          f"{same_sess:.6f} over {N_EXPORT_PUSH} steps (one add_objects); launches replay "
          f"{rep['launches']} = live {launches}; second replay bit-identical "
          f"{rep['rerun_identical']}; T={T_EXPORT} frames/s (median of 3, with uploads and the "
          f"fetch) replay {rep['fps']:.2f}, live {fps_live:.2f}; peak device memory over the "
          f"calls replay {rep['peak_mb']:.1f} MB ({rep['peak_mb'] - rep['held_mb']:.1f} above "
          f"what its process held before them), live {live_peak:.1f} MB "
          f"({live_peak - held:.1f} above; this process holds other phases' models too); "
          f"replay process: programs loaded "
          f"and warmed in {rep['load_s']:.1f} s; phase wall {time.perf_counter() - t_phase:.1f} s; "
          f"on {card}", flush=True)
    if same < 0.999 or same_sess < 0.999:
        fail(f"export: the replay agrees with the live paths on only {same:.6f} (runner) and "
             f"{same_sess:.6f} (session) of pixels")
    if not rep["rerun_identical"]:
        fail("export: two replays of the same video gave different bits")
    return rep["launches"]


def replay_main(argv) -> int:
    """Phase 7b's fresh process (``--replay <dir>``): loads ``<dir>/art`` with
    torch and the port's ops alone, replays ``<dir>/video.npz`` (counted,
    again for the bits, then three timed calls) and the session steps,
    writes ``<dir>/replay.npz`` and prints one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke replay: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from swem_tpu_torch.io.export import ExportedRunner, ExportedSession
    from swem_tpu_torch.ops import em_kernel, read_kernel

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "swem_tpu")
                    or m in ("swem_tpu_torch.models", "swem_tpu_torch.engine"))
    if loaded:
        print(f"chip_smoke replay: the loader imported {loaded}", file=sys.stderr)
        return 1
    work = Path(argv[0])
    v = np.load(work / "video.npz")
    frames, first, active, labels = v["frames"], v["first"], v["active"], v["labels"]
    injections = {EXPORT_INJECT_AT: (v["idx_map"], v["new"])}
    t0 = time.perf_counter()
    runner = ExportedRunner(str(work / "art"))
    runner.warmup()
    load_s = time.perf_counter() - t0
    em_kernel.launches = read_kernel.launches = 0
    preds = runner(frames, first, active, injections)
    torch.cuda.synchronize()
    launches = {"em_loop": em_kernel.launches, "read_memory": read_kernel.launches}
    again = runner(frames, first, active, injections)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2 ** 20
    torch.cuda.reset_peak_memory_stats()
    wall = []
    for _ in range(3):
        t0 = time.perf_counter()
        runner(frames, first, active, injections)
        wall.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    sess = ExportedSession(str(work / "art"))
    sess.start(frames[0, 0], labels)
    steps = [sess.add_objects(frames[t, 0], v["idx_map"][0], [2]) if t == EXPORT_INJECT_AT
             else sess.push(frames[t, 0]) for t in range(1, N_EXPORT_PUSH + 1)]
    np.savez(work / "replay.npz", preds=preds, session=np.stack(steps))
    print(json.dumps({"launches": launches, "rerun_identical": bool(np.array_equal(preds, again)),
                      "fps": T_EXPORT / float(np.median(wall)), "peak_mb": peak, "held_mb": held,
                      "load_s": load_s, "frames_seen": sess.frames_seen}), flush=True)
    return 0


def write_box_video(jdir: Path, adir: Path, hw, T: int, n_boxes: int, rng) -> None:
    """Seeded noise frames at ``hw`` with ``n_boxes`` coloured boxes moving
    across them: JPEGs in ``jdir``, palette-PNG annotations in ``adir``."""
    import cv2
    from swem_tpu_torch.data.palette import davis_palette, save_seg_mask

    H, W = hw
    palette = davis_palette()
    jdir.mkdir(parents=True)
    adir.mkdir(parents=True)
    colours = rng.integers(60, 256, (n_boxes, 3))
    for t in range(T):
        img = (rng.random((H, W, 3)) * 60).astype(np.uint8)
        label = np.zeros((H, W), np.uint8)
        for k in range(n_boxes):
            y0, x0 = (60 + 130 * k) * H // 480, (40 + 12 * t + 250 * k) * W // 854
            ys, xs = slice(y0, y0 + 100 * H // 480), slice(x0, x0 + 140 * W // 854)
            img[ys, xs] = colours[k]
            label[ys, xs] = k + 1
        cv2.imwrite(str(jdir / f"{t:05d}.jpg"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        save_seg_mask(label, str(adir / f"{t:05d}.png"), palette)


def write_davis_tree(root: Path, videos) -> None:
    """A DAVIS-shaped tree: ``videos`` is [(name, T, n_boxes)]; each video is
    ``write_box_video`` at EVAL_HW, listed in ImageSets/2017/val.txt."""
    (root / "ImageSets" / "2017").mkdir(parents=True, exist_ok=True)
    (root / "ImageSets" / "2017" / "val.txt").write_text("".join(f"{v[0]}\n" for v in videos))
    for vid, (name, T, n_boxes) in enumerate(videos):
        write_box_video(root / "JPEGImages" / "480p" / name, root / "Annotations" / "480p" / name,
                        EVAL_HW, T, n_boxes, np.random.default_rng(100 + vid))


def write_ytvos_tree(root: Path, T: int, late: int, late_id: int):
    """A YouTube-VOS-shaped tree: one video at YT_RAW, object 1 from frame 0
    and object ``late_id`` from frame ``late`` (annotated there only, as the
    valid split is); every other frame is listed for saving. Returns the
    late object's box mask."""
    import cv2
    from swem_tpu_torch.data.palette import davis_palette, save_seg_mask

    H, W = YT_RAW
    jdir, adir = root / "JPEGImages" / "video0", root / "Annotations" / "video0"
    jdir.mkdir(parents=True)
    adir.mkdir(parents=True)
    rng = np.random.default_rng(7)
    box1 = (slice(H // 6, H // 2), slice(W // 8, W // 3))
    box2 = (slice(H // 2, 5 * H // 6), slice(W // 2, 3 * W // 4))
    for t in range(T):
        img = (rng.random((H, W, 3)) * 60).astype(np.uint8)
        img[box1] = (220, 80, 60)
        if t >= late:
            img[box2] = (60, 90, 230)
        cv2.imwrite(str(jdir / f"{t:05d}.jpg"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    for t, (box, obj) in ((0, (box1, 1)), (late, (box2, late_id))):
        label = np.zeros((H, W), np.uint8)
        label[box] = obj
        save_seg_mask(label, str(adir / f"{t:05d}.png"), davis_palette())
    names = [f"{t:05d}" for t in range(T)]
    meta = {"videos": {"video0": {"objects": {
        "1": {"frames": names[0::2]}, str(late_id): {"frames": names[late::2]}}}}}
    (root / "meta.json").write_text(json.dumps(meta))
    mask = np.zeros((H, W), bool)
    mask[box2] = True
    return mask


def read_pngs(out_dir: Path) -> np.ndarray:
    """(T, H, W) uint8 of a video's saved palette PNGs, in frame order."""
    from swem_tpu_torch.data.palette import load_label_mask

    return np.stack([load_label_mask(str(p)) for p in sorted(out_dir.glob("*.png"))])


def eval_path(model, card: str) -> tuple:
    """Phase 8: the evaluator on DAVIS- and YouTube-VOS-shaped trees; returns
    the launch counts of the bf16 DAVIS ``val`` and what phase 10 compares
    with: the DAVIS tree, the weights as a ``.pth``, and the output trees of
    the sequential and ``video_batch=2`` evaluations."""
    import dataclasses
    import shutil

    import torch
    from swem_tpu_torch import engine
    from swem_tpu_torch.config import EvalConfig, SWEMConfig
    from swem_tpu_torch.data.davis_test import DavisTestSet
    from swem_tpu_torch.eval.benchmark import DavisEvaluation, write_reports
    from swem_tpu_torch.eval.evaluator import Evaluator
    from swem_tpu_torch.ops.resize import resize
    from swem_tpu_torch.utils import setup_logger
    from swem_tpu_torch.utils.profiling import device_busy_seconds
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke_eval"
    shutil.rmtree(work, ignore_errors=True)
    davis, one, yt = work / "davis", work / "davis_one", work / "ytvos"
    write_davis_tree(davis, EVAL_VIDEOS)
    write_davis_tree(one, EVAL_VIDEOS[:1])  # video 0 alone, the same bits
    box = write_ytvos_tree(yt, YT_T, YT_LATE, YT_LATE_ID)
    state = model.state_dict()
    dev = model.device
    torch.cuda.reset_peak_memory_stats()

    def evaluator(tag, root, model_kw=None, **eval_kw):
        cfg = SWEMConfig(model=dataclasses.replace(model.cfg, **(model_kw or {})),
                         eval=EvalConfig(data_root=str(root), max_objs=8,
                                         davis_in_size=EVAL_IN, **eval_kw),
                         log_dir=str(work / "logs" / tag))
        # the evaluator's log (per-video lines, per-object series) to a file only
        logger = setup_logger(f"chip_smoke_eval_{tag}", str(work / "logs" / tag), screen=False)
        return Evaluator(cfg, state, logger=logger, device=dev)

    def run(ev, expect, label, fn=None):
        """The evaluation once to build and warm its runners, then once with
        the launch counts read."""
        ev.evaluate()
        return counted(fn or ev.evaluate, expect, label)[1]

    # bf16 sequential through val(): every frame a PNG, Σ(T - 1) launches
    seq = evaluator("bf16", davis)
    n_seq = sum(T - 1 for _, T, _ in EVAL_VIDEOS)
    launches = run(seq, n_seq, "evaluator DAVIS bf16", fn=lambda: seq.val())
    results = read_global_csv(Path(seq.save_dir))
    maps = {name: read_pngs(Path(seq.out_root) / name) for name, _, _ in EVAL_VIDEOS}
    for name, T, _ in EVAL_VIDEOS:
        if maps[name].shape != (T,) + EVAL_HW:
            fail(f"evaluator DAVIS: {name} has PNGs {maps[name].shape}, expected {T} frames")
    if not all(np.isfinite(v) for v in results.values()):
        fail(f"evaluator DAVIS: non-finite global results {results}")
    # video 0 by hand: the same frames, bases and runner sizes, the same bits
    v0 = DavisTestSet(str(davis), n_slots=8)[0]
    direct = engine.ChunkedVideoRunner(seq.model, EVAL_HW, chunk=16, preprocess=lambda f: resize(
        f.float() / 255.0, EVAL_IN, "bicubic"))(
        None, v0.frames[:, None], v0.init_mask[None, ..., :3],
        np.asarray([[True, True]]), bases=seq.initial_bases(2))
    if not np.array_equal(direct[:, 0], maps[v0.name][1:]):
        fail("evaluator DAVIS: video 0's maps differ from a direct ChunkedVideoRunner call")
    gt = write_reports(DavisEvaluation(str(davis)).evaluate(str(davis / "Annotations" / "480p")),
                       str(work / "gt_as_prediction"), "DAVIS17")
    if abs(gt["J&F-Mean"] - 1.0) > 1e-12:
        fail(f"evaluator DAVIS: the ground truth scored as a prediction gives {gt}")
    print(f"evaluator (bfloat16): DAVIS tree of {len(EVAL_VIDEOS)} videos at {EVAL_HW} "
          f"(T {[T for _, T, _ in EVAL_VIDEOS]}, boxes {[n for _, _, n in EVAL_VIDEOS]}): "
          f"{seq.fps:.2f} frames/s (FrameSecondMeter: uploads to the host fetch, PNGs excluded) "
          f"on {card}; launches {launches}; J&F {results['J&F-Mean']:.3f} (random weights); "
          f"video 0 equals a direct runner call bit for bit; ground truth as prediction J&F "
          f"{gt['J&F-Mean']:.3f}", flush=True)

    # two videos per batch: T_max - 1 launches per batch; here each slot
    # bucket's videos (2 boxes: bucket 2; 3 boxes: bucket 4) make one batch
    vb = evaluator("vb2", davis, video_batch=2)
    n_vb = sum(max(T for _, T, n in EVAL_VIDEOS if (n <= 2) == two) - 1 for two in (True, False))
    launches_vb = run(vb, n_vb, "evaluator DAVIS video_batch=2")
    shares = {name: float((read_pngs(Path(vb.out_root) / name) == maps[name]).mean())
              for name in maps}
    print(f"evaluator (bfloat16, video_batch=2): {vb.fps:.2f} frames/s on {card}; launches "
          f"{launches_vb} (T_max - 1 per batch); index pixels equal to sequential {shares}",
          flush=True)
    if min(shares.values()) < 0.99:
        fail(f"evaluator video_batch=2: {shares} of pixels agree with sequential")

    T0 = EVAL_VIDEOS[0][1]
    name0 = EVAL_VIDEOS[0][0]
    ms = evaluator("ms", one, scales=EVAL_SCALES, flip=True)
    launches_ms = run(ms, len(EVAL_SCALES) * 2 * (T0 - 1), "evaluator multi-scale + flip")
    ms_maps = read_pngs(Path(ms.out_root) / name0)
    print(f"evaluator (bfloat16, scales {EVAL_SCALES} + flip, one video): {ms.fps:.2f} frames/s; "
          f"launches {launches_ms}; index pixels equal to the single scale's "
          f"{float((ms_maps == maps[name0]).mean()):.6f}", flush=True)

    f32 = evaluator("f32", one, model_kw={"dtype": "float32"})
    launches_f32 = run(f32, T0 - 1, "evaluator float32")
    same = float((read_pngs(Path(f32.out_root) / name0) == maps[name0]).mean())
    print(f"evaluator (float32, one video): {f32.fps:.2f} frames/s on {card}; launches "
          f"{launches_f32}; index pixels equal to bf16 {same:.6f}", flush=True)
    if same < 0.99:
        fail(f"evaluator float32: only {same:.4f} of pixels agree with bf16")

    local = evaluator("n_kernel", one, model_kw={"n_kernel": 4, "kernel_sigma": 7.0})
    launches_nk = run(local, {"em_loop": T0 - 1, "read_memory": 0}, "evaluator n_kernel=4")
    nk_maps = read_pngs(Path(local.out_root) / name0)
    differ = float((nk_maps != maps[name0]).mean())
    print(f"evaluator (bfloat16, n_kernel=4 sigma=7, one video): {local.fps:.2f} frames/s; "
          f"launches {launches_nk}; index pixels that differ from n_kernel=0 {differ:.6f}",
          flush=True)
    if differ == 0.0 or int(nk_maps.max()) > 2:
        fail("evaluator n_kernel=4: maps equal to n_kernel=0's, or an index out of range")

    ytv = evaluator("ytvos", yt, eval_set="YTVOS19", ssize=YT_SSIZE)
    launches_yt = run(ytv, YT_T - 1, "evaluator YouTube-VOS")
    saved = sorted(p.stem for p in (Path(ytv.out_root) / "video0").glob("*.png"))
    late = read_pngs(Path(ytv.out_root) / "video0")[saved.index(f"{YT_LATE:05d}")]
    print(f"evaluator (bfloat16, YouTube-VOS {YT_RAW} raw -> in "
          f"{tuple(ytv.dataset[0].in_size)}, T={YT_T}): {ytv.fps:.2f} frames/s; launches "
          f"{launches_yt}; saved {saved}; object {YT_LATE_ID} injected at frame {YT_LATE} holds "
          f"{float((late[box] == YT_LATE_ID).mean()):.6f} of its box", flush=True)
    if not (late[box] == YT_LATE_ID).all() or saved != [f"{t:05d}" for t in range(0, YT_T, 2)]:
        fail("evaluator YouTube-VOS: the injected object's box or the saved frames are wrong")
    # frames/s at a DAVIS val length: full 16-frame chunks; sequential and
    # video_batch=2 in turns, so that the host's drift hits both alike
    long_root = work / "davis_long"
    write_davis_tree(long_root, EVAL_LONG)
    n_long, t_long = sum(T - 1 for _, T, _ in EVAL_LONG), EVAL_LONG[0][1]
    lseq, lvb = evaluator("long_bf16", long_root), evaluator("long_vb2", long_root, video_batch=2)
    lseq.evaluate()
    lvb.evaluate()
    long_fps = {"sequential": [], "video_batch=2": []}
    for _ in range(LONG_REPS):
        counted(lseq.evaluate, n_long, "evaluator DAVIS length bf16")
        long_fps["sequential"].append(lseq.fps)
        counted(lvb.evaluate, t_long - 1, "evaluator DAVIS length video_batch=2")
        long_fps["video_batch=2"].append(lvb.fps)
    lf32 = evaluator("long_f32", long_root, model_kw={"dtype": "float32"})
    run(lf32, n_long, "evaluator DAVIS length float32")
    long_maps = {tag: {name: read_pngs(Path(ev.out_root) / name) for name, _, _ in EVAL_LONG}
                 for tag, ev in (("seq", lseq), ("vb2", lvb), ("f32", lf32))}

    def quarters(a, b):  # the share of equal pixels in each quarter of the video
        eq = (a == b).reshape(a.shape[0], -1).mean(1)
        return " ".join(f"{float(q.mean()):.6f}" for q in np.array_split(eq, 4))

    print(f"evaluator at a DAVIS val length ({len(EVAL_LONG)} videos of T={t_long} at "
          f"{EVAL_HW}, one slot bucket): frames/s (FrameSecondMeter) on {card}: " + "; ".join(
              f"bf16 {mode} median {np.median(v):.2f} (runs {' '.join(f'{x:.2f}' for x in v)})"
              for mode, v in long_fps.items())
          + f"; float32 {lf32.fps:.2f}; launches {n_long} sequential, {t_long - 1} per batch of 2",
          flush=True)
    # checked: a PNG per frame, indices within the video's objects; the
    # agreements are reported only: over 69 frames at tau = 0.05 one run's
    # trajectory may part from the others' (the short videos are gated)
    for name, T, n_boxes in EVAL_LONG:
        m = {tag: maps_[name] for tag, maps_ in long_maps.items()}
        for tag, a in m.items():
            if a.shape != (T,) + EVAL_HW or int(a.max()) > n_boxes:
                fail(f"evaluator DAVIS length {tag}: {name} has PNGs {a.shape} with indices up "
                     f"to {int(a.max())}, expected {T} frames of at most {n_boxes}")
        for a, b in (("vb2", "seq"), ("f32", "seq"), ("f32", "vb2")):
            print(f"  {name}: {a} equal to {b} on {float((m[a] == m[b]).mean()):.6f} of pixels; "
                  f"by quarter of the video {quarters(m[a], m[b])}", flush=True)
    # where an evaluation's time goes: the device's busy share of the bf16
    # DAVIS-length evaluate(), last, so that the profiler's session times
    # nothing above
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lseq.evaluate()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = device_busy_seconds(prof)
    n_kernels = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())
    print(f"evaluator (bfloat16) under torch.profiler: evaluate() wall {wall * 1e3:.3f} ms for "
          f"{n_long + len(EVAL_LONG)} frames of T={t_long} videos, {n_kernels} device events, device busy "
          f"{busy * 1e3:.3f} ms, idle share {1 - busy / wall:.4f}", flush=True)
    print(f"evaluator phase: peak device memory {torch.cuda.max_memory_allocated() / 2 ** 20:.1f}"
          f" MB, wall {time.perf_counter() - t_phase:.1f} s", flush=True)
    torch.save(state, work / "weights.pth")
    return launches, {"davis": davis, "pth": work / "weights.pth",
                      "seq": Path(seq.out_root), "vb": Path(vb.out_root),
                      "save_dir": Path(seq.save_dir)}


def check_no_grad_launch() -> None:
    """Neither kernel has a backward: on a CUDA input that requires grad,
    with gradients on, both wrappers raise and launch nothing."""
    import torch
    from swem_tpu_torch.ops import em_kernel, read_kernel

    rng = np.random.default_rng(3)
    em_in = em_inputs(rng, 1, 2, 64, 16, 8, 0.3)
    rd_in = list(read_inputs(rng, 1, 2, 64, 16, 8, 16, "all valid"))
    before = (em_kernel.launches, read_kernel.launches)
    for name, fn, inputs, kw in (("em_loop", em_kernel.em_loop, em_in, dict(n_iters=2, tau=0.05)),
                                 ("read_normalized", read_kernel.read_normalized, rd_in,
                                  dict(tau=0.05))):
        for i in range(len(inputs)):
            if not inputs[i].is_floating_point():
                continue
            args = [t.detach().requires_grad_(j == i) for j, t in enumerate(inputs)]
            try:
                fn(*args, **kw)
            except RuntimeError as e:
                if "no backward" not in str(e):
                    raise
            else:
                fail(f"{name}: an input that requires grad did not raise")
        with torch.no_grad():  # under no_grad the same inputs launch
            fn(*[t.detach().requires_grad_(t.is_floating_point()) for t in inputs], **kw)
    torch.cuda.synchronize()
    after = (em_kernel.launches, read_kernel.launches)
    if after != (before[0] + 1, before[1] + 1):
        fail(f"gradient guard: launches went {before} -> {after}, expected one each under "
             f"no_grad and none otherwise")
    print("gradient guard: em_loop and read_normalized raise on every CUDA input that requires "
          "grad (gradients on) and launch nothing; under no_grad they launch", flush=True)


def write_train_tree(root: Path) -> str:
    """The S3 training layouts (DAVIS 480p and YouTube-VOS train_480p) with
    TRAIN_VIDEOS videos each, named from the port's subset lists,
    ``write_box_video`` at EVAL_HW; the first DAVIS video is also listed in
    ImageSets/2017/val.txt for the evaluator. Returns that video's name."""
    from swem_tpu_torch.data.factory import IMAGESETS_DIR

    lists = {}
    for key, fname in (("davis", "davis_subset.txt"), ("ytvos", "yv_subset.txt")):
        with open(Path(IMAGESETS_DIR) / fname) as f:
            lists[key] = [ln.strip() for ln in f if ln.strip()][:TRAIN_VIDEOS]
    dirs = {"davis": (root / "DAVIS" / "JPEGImages" / "480p", root / "DAVIS" / "Annotations" / "480p"),
            "ytvos": (root / "YTVOS19" / "train_480p" / "JPEGImages",
                      root / "YTVOS19" / "train_480p" / "Annotations")}
    for d, (key, names) in enumerate(lists.items()):
        jroot, aroot = dirs[key]
        for v, name in enumerate(names):
            write_box_video(jroot / name, aroot / name, EVAL_HW, TRAIN_FRAMES_ON_DISK, 2,
                            np.random.default_rng(200 + 10 * d + v))
    (root / "DAVIS" / "ImageSets" / "2017").mkdir(parents=True)
    (root / "DAVIS" / "ImageSets" / "2017" / "val.txt").write_text(lists["davis"][0] + "\n")
    return lists["davis"][0]


def s3_config(root: Path, log_dir: Path, dtype: str, total=TRAIN_ITERS, **kw):
    """The reference's S3 run at full width: stage 3 (DAVIS + YouTube-VOS),
    batch 8, 384x384 crops, T = 3, 8 loader workers, ``total`` = (milestone,
    max_iter); checkpoints every TRAIN_SAVE steps, no overlays."""
    from swem_tpu_torch.config import DataConfig, ModelConfig, SolverConfig, SWEMConfig

    data = dict(data_root=str(root), batch_size=TRAIN_B, num_workers=TRAIN_WORKERS,
                vid_crop_size=(TRAIN_CROP, TRAIN_CROP))
    data.update(kw.pop("data", {}))
    return SWEMConfig(model=ModelConfig(dtype=dtype), data=DataConfig(**data),
                      solver=SolverConfig(stage=3, maintrain_iters=total),
                      log_dir=str(log_dir), exp_name=dtype, log_period=5,
                      save_period=TRAIN_SAVE, vis_period=0, **kw)


@contextlib.contextmanager
def tf32_watch(model, label: str):
    """Fail the run if a TF32 flag reads True inside any module's forward or
    while autograd runs the backward of any module's output."""
    import torch

    seen, on = [0, 0], []

    def flags_on():
        return torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32

    def check_grad(name):
        def hook(grad):
            seen[1] += 1
            if flags_on():
                on.append(f"{name} (backward)")
        return hook

    def forward_hook(mod, _inp, out):
        seen[0] += 1
        if flags_on():
            on.append(type(mod).__name__)
        for o in out if isinstance(out, tuple) else (out,):
            if isinstance(o, torch.Tensor) and o.requires_grad:
                o.register_hook(check_grad(type(mod).__name__))

    hooks = [m.register_forward_hook(forward_hook) for m in model.modules()]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()
    if on or not all(seen):
        fail(f"{label}: TF32 on in {sorted(set(on))[:5]} ({seen[0]} forwards, {seen[1]} "
             f"backward hooks)")
    print(f"{label}: TF32 off in all {seen[0]} module forwards and {seen[1]} backward hooks "
          f"(outside: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32})", flush=True)


def recording_steps(trainer) -> tuple:
    """Wrap ``trainer.train_step`` to keep each step's losses and the host
    clock at each call; returns (losses, call times)."""
    losses, times, step = [], [], trainer.train_step

    def recording_step(*a, **kw):
        times.append(time.perf_counter())
        out = step(*a, **kw)
        losses.append(out)
        return out

    trainer.train_step = recording_step
    return losses, times


def step_ms(times) -> float:
    """The training loop's ms per step: the median gap between successive
    step calls (the loader's waits and the log periods' syncs included)."""
    return float(np.median(np.diff(times))) * 1e3


def run_trainer(cfg, label: str, watch: bool = False) -> tuple:
    """``Trainer(cfg).train()`` with every launch count set to 0 just before
    and read just after: K1 (T - 1) times per step, K2 never. Returns (the
    trainer, its losses per step, the launch counts, wall seconds, ms per
    step)."""
    from swem_tpu_torch.train.loop import Trainer
    from swem_tpu_torch.utils import setup_logger

    logger = setup_logger(f"chip_smoke_{label}", cfg.log_dir, label.replace(" ", "_"))
    trainer = Trainer(cfg, logger=logger)
    start, n_steps = trainer.state.step, trainer.max_iter - trainer.state.step
    losses, times = recording_steps(trainer)
    t0 = time.perf_counter()
    with tf32_watch(trainer.model, label) if watch else contextlib.nullcontext():
        _, launches = counted(trainer.train, {"em_loop": (TRAIN_FRAMES - 1) * n_steps,
                                              "read_memory": 0}, label)
    wall = time.perf_counter() - t0
    values = [float(m["total_loss"]) for m in losses]
    if trainer.state.step != start + n_steps or not np.isfinite(values).all():
        fail(f"{label}: step {trainer.state.step} (expected {start + n_steps}), losses {values}")
    return trainer, values, launches, wall, step_ms(times)


def loader_batch(cfg) -> dict:
    """The first batch of ``cfg``'s loader, without its ``skips``."""
    from swem_tpu_torch.data.factory import build_train_loader

    loader = build_train_loader(cfg)
    batch = next(iter(loader))
    loader.close()
    batch.pop("skips")
    return batch


def grad_difference(a: tuple, b: tuple) -> tuple:
    """(loss, gradients by name) of two steps -> the loss's relative
    difference, the gradients' global relative L2 difference (against
    ``b``) and each parameter's."""
    (la, ga), (lb, gb) = a, b
    rel = {n: float((ga[n] - gb[n]).norm() / max(float(gb[n].norm()), 1e-30)) for n in gb}
    diff2 = sum(float((ga[n] - gb[n]).norm() ** 2) for n in gb)
    glob = (diff2 / sum(float(g.norm() ** 2) for g in gb.values())) ** 0.5
    return abs(la - lb) / abs(lb), glob, rel


def tamed_weights(cfg) -> dict:
    """``cfg.model``'s seeded weights (``init_weights(0)``) tamed as the CPU
    tests tame them: keys of norm ~3, decoder logits O(1), so that float32
    rounding is not grown into chaos by the EM softmax at tau."""
    import torch
    from swem_tpu_torch.models.swem import SWEM

    tamed = SWEM(cfg.model, device="cpu").init_weights(0)
    with torch.no_grad():
        tamed.key_proj.key_proj.weight.mul_(0.03)
        tamed.decoder.pred.weight.mul_(0.01)
    return tamed.state_dict()


def card_vs_cpu_step(root: Path) -> dict:
    """One float32 train step at full width, B = 2, on the card and on the
    CPU (plain versions) from the same tamed weights, batch and bases:
    the loss's and the gradients' relative differences, gated. Beside
    them, not gated, what moves the card's gradients: the same card step
    again, with K1's plain loop in K1's place, and with the convolution
    algorithms that cuDNN's benchmark mode picks."""
    import torch
    from swem_tpu_torch.models import em
    from swem_tpu_torch.models.swem import SWEM
    from swem_tpu_torch.ops import em_kernel
    from swem_tpu_torch.train.trainer import batch_to_device, create_train_state, make_train_step

    cfg = s3_config(root, root, "float32", data={"batch_size": 2, "num_workers": 0})
    batch = loader_batch(cfg)
    weights = tamed_weights(cfg)
    m = cfg.model
    bases = em.init_bases(torch.Generator().manual_seed(5), 2, m.max_objs, m.keydim, m.valdim,
                          m.num_bases)
    step = make_train_step(cfg)
    k1 = TRAIN_FRAMES - 1

    def run(label, device, k1_launches):
        model = SWEM(cfg.model, device=device)
        model.load_state_dict(weights)
        state = create_train_state(model, cfg.solver)
        t0 = time.perf_counter()
        losses, _ = counted(lambda: step(state, batch_to_device(batch, model.device),
                                         bases=bases.to(model.device)),
                            {"em_loop": k1_launches, "read_memory": 0}, f"{label} step")
        grads = {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()}
        return float(losses["total_loss"]), grads, time.perf_counter() - t0

    runs = {"card": run("card", None, k1), "card again": run("card again", None, k1)}
    em_loop = em.em_loop
    em.em_loop = em_kernel.em_loop_plain
    try:
        runs["card, K1's plain loop"] = run("card with K1's plain loop", None, 0)
    finally:
        em.em_loop = em_loop
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        runs["card, cuDNN benchmark"] = run("card with cuDNN benchmark", None, k1)
    finally:
        torch.backends.cudnn.benchmark = benchmark
    runs["cpu"] = run("cpu", "cpu", 0)
    pair = {k: v[:2] for k, v in runs.items()}
    loss_rel, glob, rel = grad_difference(pair["card"], pair["cpu"])
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    print(f"train step card vs CPU (float32, B=2, {TRAIN_CROP}x{TRAIN_CROP}, T={TRAIN_FRAMES}, "
          f"tamed weights, same batch and bases): loss {runs['card'][0]:.8f} vs "
          f"{runs['cpu'][0]:.8f}, relative difference {loss_rel:.3e} (gate 1e-3); gradients' "
          f"global relative L2 difference {glob:.3e} (gate 1e-2), per parameter median "
          f"{float(np.median(list(rel.values()))):.3e}, worst "
          f"{', '.join(f'{n} {r:.3e}' for n, r in worst)}; {len(rel)} parameters; card "
          f"{runs['card'][2]:.1f} s, CPU {runs['cpu'][2]:.1f} s", flush=True)
    # what moves the gradients: loss and global gradient differences by pair
    spread = {}
    for a, b in (("card again", "card"), ("card, K1's plain loop", "card"),
                 ("card, K1's plain loop", "cpu"), ("card, cuDNN benchmark", "card")):
        l_rel, g_rel, r = grad_difference(pair[a], pair[b])
        spread[f"{a} vs {b}"] = g_rel
        print(f"train step {a} vs {b}: loss relative difference {l_rel:.3e}, gradients' global "
              f"relative L2 difference {g_rel:.3e}, per parameter median "
              f"{float(np.median(list(r.values()))):.3e}", flush=True)
    if not loss_rel <= 1e-3 or not glob <= 1e-2:
        fail(f"train step card vs CPU: loss {loss_rel:.3e} (gate 1e-3), gradients {glob:.3e} "
             f"(gate 1e-2)")
    return {"loss_rel": loss_rel, "grad_rel": glob, "spread": spread}


def time_train(root: Path, dtype: str, card: str) -> dict:
    """ms per S3 step (``bench.bench_train`` on a batch of the tree):
    TRAIN_TIMED steps with one sync (median of the per-step event spans,
    and wall over the steps), samples/s, peak device memory; then the
    device's idle share in one more step under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from swem_tpu_torch.bench import bench_train

    cfg = s3_config(root, root, dtype, data={"num_workers": 0})
    res, one_step = bench_train(cfg, loader_batch(cfg), TRAIN_TIMED)
    print(f"train step timing ({dtype}, S3: batch {TRAIN_B}, {TRAIN_CROP}x{TRAIN_CROP}, "
          f"T={TRAIN_FRAMES}, full width) on {card}: median {res['ms_median']:.3f} ms per step "
          f"over {TRAIN_TIMED} steps (event spans {' '.join(f'{x:.3f}' for x in res['ms_runs'])}"
          f"), wall {res['ms']:.3f} ms per step with one sync, "
          f"{TRAIN_B / res['ms_median'] * 1e3:.2f} samples/s; peak device memory "
          f"{res['peak_mem_mb']:.1f} MB", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    idle = report_profile(prof, wall * 1e6, f"profile ({dtype}): one S3 train step")
    del one_step
    torch.cuda.empty_cache()
    return {"median_ms": res["ms_median"], "wall_ms": res["ms"], "peak_mb": res["peak_mem_mb"],
            "idle": idle}


def remat_steps(root: Path, card: str) -> dict:
    """remat "encoder" and "block" at S3 bfloat16 (``bench.bench_train``:
    2 warm-up and REMAT_STEPS timed steps), every launch count set to 0
    just before and read just after: K1 T - 1 times per step under
    "encoder", 2 (T - 1) - 1 under "block" (its recomputation reruns every
    memorize but the last frame's, which has none), K2 never. Returns ms
    per step and peak memory by mode."""
    import torch
    from swem_tpu_torch.bench import bench_train

    base = s3_config(root, root, "bfloat16", data={"num_workers": 0})
    batch = loader_batch(base)
    per_step = {"encoder": TRAIN_FRAMES - 1, "block": 2 * (TRAIN_FRAMES - 1) - 1}
    out = {}
    for remat, k in per_step.items():
        cfg = base.replace(solver=dataclasses.replace(base.solver, remat=remat))
        (res, one_step), launches = counted(
            lambda: bench_train(cfg, batch, REMAT_STEPS),
            {"em_loop": k * (2 + REMAT_STEPS), "read_memory": 0}, f"remat {remat}")
        del one_step
        torch.cuda.empty_cache()
        print(f"train step (bfloat16, remat {remat!r}) on {card}: K1 {k} launches per step "
              f"({launches['em_loop']} over {2 + REMAT_STEPS} steps), K2 "
              f"{launches['read_memory']}; median {res['ms_median']:.3f} ms per step over "
              f"{REMAT_STEPS}, peak device memory {res['peak_mem_mb']:.1f} MB", flush=True)
        out[remat] = {"median_ms": res["ms_median"], "peak_mb": res["peak_mem_mb"],
                      "k1_per_step": k}
    return out


def _cv2_threads(n: int, factory):
    """A loader worker's dataset, built after OpenCV is set to ``n`` threads."""
    import cv2

    cv2.setNumThreads(n)
    return factory()


@contextlib.contextmanager
def loader_as_before():
    """The loader as it was before its workers ran on one thread: they start
    with the host's OpenMP/BLAS thread counts (no ``WORKER_THREAD_ENV``)
    and OpenCV at its default, the count this process has."""
    import functools

    import cv2
    from swem_tpu_torch.data import factory, loader

    env, build = loader.WORKER_THREAD_ENV, factory.build_dataset_factory
    threads = cv2.getNumThreads()
    loader.WORKER_THREAD_ENV = {}
    factory.build_dataset_factory = lambda cfg: functools.partial(_cv2_threads, threads,
                                                                  build(cfg))
    try:
        yield
    finally:
        loader.WORKER_THREAD_ENV, factory.build_dataset_factory = env, build


def time_loader(cfg, n_batches: int) -> tuple:
    """``cfg``'s loader: the first batch's ms (the pool's start) and ms per
    batch over the next ``n_batches``; returns (first ms, ms per batch, the
    first batch, the last)."""
    from swem_tpu_torch.data.factory import build_train_loader

    loader = build_train_loader(cfg)
    batches = iter(loader)
    t0 = time.perf_counter()
    first = next(batches)  # starts the pool
    t1 = time.perf_counter()
    for _ in range(n_batches):
        last = next(batches)
    ms = (time.perf_counter() - t1) / n_batches * 1e3
    batches.close()
    loader.close()
    return (t1 - t0) * 1e3, ms, first, last


def eval_trained(ckpt: Path, root: Path, log_dir: Path, val_video: str) -> None:
    """The ``Evaluator`` on a trained ``variables.pth`` (read directly, as a
    reference ``.pth``) over the training tree's one DAVIS val video: T - 1
    launches of each kernel, a PNG per frame, indices within its 2 boxes."""
    import torch
    from swem_tpu_torch import registry
    from swem_tpu_torch.config import EvalConfig
    from swem_tpu_torch.eval.evaluator import Evaluator
    from swem_tpu_torch.utils import setup_logger

    ev_cfg = s3_config(root, log_dir, "bfloat16").replace(
        eval=EvalConfig(data_root=str(root / "DAVIS"), max_objs=8, davis_in_size=EVAL_IN))
    ev = Evaluator(ev_cfg, registry.load_state_dict(ev_cfg, str(ckpt / "variables.pth")),
                   logger=setup_logger(f"chip_smoke_eval_{log_dir.name}", str(log_dir),
                                       screen=False))
    ev.evaluate()  # builds and warms its runners
    counted(ev.evaluate, TRAIN_FRAMES_ON_DISK - 1, f"evaluator on {ckpt}/variables.pth")
    pngs = read_pngs(Path(ev.out_root) / val_video)
    if pngs.shape != (TRAIN_FRAMES_ON_DISK,) + EVAL_HW or int(pngs.max()) > 2:
        fail(f"evaluator on variables.pth: PNGs {pngs.shape} with indices up to {int(pngs.max())}")
    print(f"evaluator on the trained {ckpt.parent.name}/variables.pth: {val_video}, "
          f"{pngs.shape[0]} PNGs at {EVAL_HW}, {ev.fps:.2f} frames/s, label pixels "
          f"{np.bincount(pngs.ravel(), minlength=3).tolist()}", flush=True)
    del ev
    torch.cuda.empty_cache()


def train_path(card: str) -> dict:
    """Phase 8b: training at S3 full width; returns the launch counts of the
    bfloat16 and float32 runs and what phase 10 reuses (the tree, the
    one-process run's wall and ms per step)."""
    import os
    import shutil

    import cv2
    import torch

    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(work, ignore_errors=True)
    root = work / "data"
    val_video = write_train_tree(root)
    print(f"training tree: DAVIS and YouTube-VOS train layouts, {TRAIN_VIDEOS} videos each of "
          f"T={TRAIN_FRAMES_ON_DISK} at {EVAL_HW}, 2 moving boxes ({time.perf_counter() - t_phase:.1f}"
          f" s)", flush=True)

    # the loader alone: ms per batch with TRAIN_WORKERS spawned workers
    s3 = s3_config(root, work, "bfloat16")
    first_ms, loader_ms, first, b = time_loader(s3, LOADER_BATCHES)
    if b["frames"].shape != (TRAIN_B, TRAIN_FRAMES, TRAIN_CROP, TRAIN_CROP, 3) \
            or b["frames"].dtype != np.uint8 or int(b["label"].max()) > 2:
        fail(f"loader: frames {b['frames'].shape} {b['frames'].dtype}, labels up to "
             f"{int(b['label'].max())}")
    print(f"loader ({TRAIN_WORKERS} workers on one OpenMP/BLAS/OpenCV thread each, batch "
          f"{TRAIN_B} at {TRAIN_CROP}x{TRAIN_CROP}, T={TRAIN_FRAMES}): first batch "
          f"{first_ms:.1f} ms (pool start), then {loader_ms:.1f} ms per batch over "
          f"{LOADER_BATCHES}; valid slots per clip {first['valid_obj'].sum(1).tolist()}",
          flush=True)
    with loader_as_before():
        before_first, before_ms, _, _ = time_loader(s3, VARIANT_BATCHES)
    print(f"loader as before (the workers on the host's OpenMP/BLAS/OpenCV thread counts): "
          f"first batch {before_first:.1f} ms, then {before_ms:.1f} ms per batch over "
          f"{VARIANT_BATCHES}; now {loader_ms:.1f}", flush=True)
    counts = {}
    bf16, losses, counts["bfloat16"], wall, ms = run_trainer(
        s3_config(root, work, "bfloat16"), "train bfloat16", watch=True)
    ckpt = Path(bf16.ckpt_dir)
    print(f"train (bfloat16): Trainer.train() {TRAIN_ITERS[1]} steps in {wall:.1f} s (loader "
          f"pool start included), {ms:.1f} ms per step (median gap between step calls) on "
          f"{card}; losses {' '.join(f'{v:.4f}' for v in losses)}; launches "
          f"{counts['bfloat16']}; checkpoints {sorted(p.name for p in ckpt.iterdir())}",
          flush=True)
    with loader_as_before():
        _, _, _, wall_before, ms_before = run_trainer(
            s3_config(root, work / "before", "bfloat16"), "train bfloat16 loader as before")
    print(f"train (bfloat16) with the loader as before: Trainer.train() {TRAIN_ITERS[1]} steps "
          f"in {wall_before:.1f} s, {ms_before:.1f} ms per step; now {wall:.1f} s, {ms:.1f} ms",
          flush=True)
    # resume: the whole state from state.pth, two more steps
    resumed, more, launches_resume, _, _ = run_trainer(
        s3_config(root, work, "bfloat16", total=(TRAIN_ITERS[0], TRAIN_ITERS[1] + 2),
                  resume=str(ckpt), from_scratch=False), "train bfloat16 resumed")
    print(f"train (bfloat16) resumed from {ckpt.name}/state.pth at step {TRAIN_ITERS[1]}: "
          f"step now {resumed.state.step}, losses {' '.join(f'{v:.4f}' for v in more)}; "
          f"launches {launches_resume}", flush=True)
    del bf16, resumed
    eval_trained(ckpt, root, work / "eval", val_video)

    f32, losses32, counts["float32"], wall32, _ = run_trainer(
        s3_config(root, work, "float32"), "train float32", watch=True)
    print(f"train (float32): Trainer.train() {TRAIN_ITERS[1]} steps in {wall32:.1f} s on {card}; "
          f"losses {' '.join(f'{v:.4f}' for v in losses32)}; launches {counts['float32']}",
          flush=True)
    del f32
    torch.cuda.empty_cache()

    parity = card_vs_cpu_step(root)
    timing = {dt: time_train(root, dt, card) for dt in ("bfloat16", "float32")}
    remat = remat_steps(root, card)
    print(f"loader host: {os.cpu_count()} CPUs, OpenCV {cv2.__version__} with "
          f"{cv2.getNumThreads()} threads in this process", flush=True)
    print(f"training phase: wall {time.perf_counter() - t_phase:.1f} s; S3 step median bf16 "
          f"{timing['bfloat16']['median_ms']:.3f} ms, float32 {timing['float32']['median_ms']:.3f}"
          f" ms; loader {loader_ms:.1f} ms per batch", flush=True)
    return {"launches": counts["bfloat16"], "launches_f32": counts["float32"],
            "parity": parity, "timing": timing, "remat": remat, "loader_ms": loader_ms,
            "root": root, "val_video": val_video, "train_wall_s": wall, "step_ms": ms}


# ---------------------------------------------------------------------------
# phase 10: data parallelism. The parent starts the ranks with
# ``python -m torch.distributed.run``; each rank runs this script as
# ``chip_smoke.py --rank <job> <out_dir> <args...>`` (``rank_main``).

def launch_ranks(nproc: int, job: str, out_dir: Path, args, label: str) -> list:
    """``nproc`` ranks of ``job`` through ``torch.distributed.run`` in a
    session of their own, bounded by RANK_TIMEOUT_S (then the whole session
    is killed and the run fails); a rank that fails fails the run. Relays
    each rank's JSON line and returns them in rank order."""
    import os
    import signal
    import subprocess

    out_dir.mkdir(parents=True, exist_ok=True)
    for old in out_dir.glob(f"{job}_rank*.json"):
        old.unlink()
    log = out_dir / f"{job}.log"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(nproc), str(ROOT / "chip_smoke.py"), "--rank", job, str(out_dir), *map(str, args)]
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, cwd=ROOT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            rc = None
            os.killpg(proc.pid, signal.SIGTERM)
            try:
                proc.wait(timeout=15)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    tail = log.read_text()[-6000:]
    if rc != 0:
        print(tail, file=sys.stderr, flush=True)
        fail(f"{label}: {nproc} ranks " + (f"still running after {RANK_TIMEOUT_S} s: killed"
                                           if rc is None else f"exited with {rc}"))
    results = [json.loads((out_dir / f"{job}_rank{r}.json").read_text()) for r in range(nproc)]
    for r in results:
        print(f"{label}, rank {r['rank']} of {r['world']} ({r['backend']}, {r['device']}): "
              f"{json.dumps(r)}", flush=True)
    print(f"{label}: {nproc} ranks in {time.perf_counter() - t0:.1f} s (process starts included)",
          flush=True)
    return results


def rank_main(argv) -> int:
    """One rank of phase 10 (``--rank <job> <out_dir> <args...>``): runs the
    job with the kernel shapes recorded, prints one JSON line with its
    launches and shapes and writes it to ``<out_dir>/<job>_rank<r>.json``."""
    import os

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke rank: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    job, out_dir, args = argv[0], Path(argv[1]), argv[2:]
    shapes = {"em_loop": set(), "read_memory": set()}
    with recording_shapes(shapes):
        result = {"step": rank_step, "train": rank_train, "eval": rank_eval}[job](args)
    result.update(job=job, rank=int(os.environ["RANK"]), world=int(os.environ["WORLD_SIZE"]),
                  shapes={k: sorted(v) for k, v in shapes.items()})
    line = json.dumps(result)
    print(line, flush=True)
    (out_dir / f"{job}_rank{result['rank']}.json").write_text(line)
    return 0


def launch_counts() -> dict:
    from swem_tpu_torch.ops import em_kernel, read_kernel

    return {"em_loop": em_kernel.launches, "read_memory": read_kernel.launches}


def digest(tensors: dict) -> str:
    """sha256 of the tensors' bytes in name order: equal digests, equal bits."""
    import hashlib

    h = hashlib.sha256()
    for name in sorted(tensors):
        h.update(tensors[name].detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def rank_step(args) -> dict:
    """Phase 10a, one rank: one float32 DDP step at S3 full width on this
    rank's loader shard and its rows of the global draws, from the tamed
    weights; rank 0 saves the averaged gradients and the global loss."""
    import torch
    import torch.distributed as dist
    from swem_tpu_torch import parallel
    from swem_tpu_torch.data.factory import build_train_loader
    from swem_tpu_torch.models.swem import SWEM
    from swem_tpu_torch.ops import em_kernel, read_kernel
    from swem_tpu_torch.train import trainer
    from swem_tpu_torch.train.loop import RNG_OFFSET

    backend, device, root, out = args
    with parallel.process_group(backend=backend,
                                device=None if device == "rank" else device) as dev:
        rank, world = parallel.process_index(), parallel.process_count()
        cfg = s3_config(Path(root), Path(out), "float32", data={"num_workers": 0})
        model = SWEM(cfg.model, device=dev)
        model.load_state_dict(tamed_weights(cfg))
        loader = build_train_loader(cfg, shard_id=rank, num_shards=world)
        batch = next(iter(loader))
        loader.close()
        batch.pop("skips")
        state = trainer.create_train_state(model, cfg.solver)
        step = trainer.make_train_step(cfg)
        staged = trainer.batch_to_device(batch, dev)
        em_kernel.launches = read_kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = step(state, staged, trainer.step_generator(cfg.data.seed + RNG_OFFSET, 0))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = launch_counts()
        glob = float(parallel.global_mean(losses["total_loss"]))
        grads = {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()}
        if rank == 0:
            torch.save({"loss": glob, "grads": grads}, Path(out) / "ddp_step.pt")
        result = {"backend": dist.get_backend(), "device": str(dev),
                  "ddp": isinstance(state.forward, torch.nn.parallel.DistributedDataParallel),
                  "rows": int(batch["frames"].shape[0]), "loss": float(losses["total_loss"]),
                  "global_loss": glob, "ms": ms, "launches": launches,
                  "params_sha": digest(dict(model.named_parameters())),
                  "grads_sha": digest(grads),
                  "peak_mb": torch.cuda.max_memory_allocated(dev) / 2 ** 20}
        dist.barrier()  # rank 0's file is written before any rank leaves
        return result


def rank_train(argv) -> dict:
    """Phase 10b/c, one rank: ``python -m swem_tpu_torch.train`` with
    ``argv``, its kernel launches counted over the whole call, each step's
    losses and host clock, and what the rank's ``Trainer`` held: the
    backend, the tensorboard writer, the checkpoints it handed its writer
    thread."""
    import importlib.util

    import torch
    import torch.distributed as dist
    from swem_tpu_torch.ops import em_kernel, read_kernel
    from swem_tpu_torch.train import __main__ as cli
    from swem_tpu_torch.train import loop

    seen, train = {}, loop.Trainer.train

    def recorded_train(self):
        losses, times = recording_steps(self)
        submits, submit = [0], self._saver.submit

        def counting_submit(*a, **kw):
            submits[0] += 1
            return submit(*a, **kw)

        self._saver.submit = counting_submit
        seen.update(backend=dist.get_backend(), device=str(self.device),
                    writer=self.writer is not None,
                    tensorboardx=importlib.util.find_spec("tensorboardX") is not None)
        t0 = time.perf_counter()
        try:
            return train(self)
        finally:
            seen.update(train_s=time.perf_counter() - t0, step_ms=step_ms(times),
                        losses=[float(m["total_loss"]) for m in losses],
                        checkpoints=submits[0],
                        peak_mb=torch.cuda.max_memory_allocated(self.device) / 2 ** 20)

    loop.Trainer.train = recorded_train
    em_kernel.launches = read_kernel.launches = 0
    state = cli.main(argv)
    return {**seen, "step": state.step, "launches": launch_counts()}


def rank_eval(argv) -> dict:
    """Phase 10d, one rank: ``python -m swem_tpu_torch.eval`` with ``argv``:
    its metrics, the batches of videos it ran (name, T), and its kernel
    launches over the call less those of the runners' warm-up."""
    import torch.distributed as dist
    from swem_tpu_torch.engine import ChunkedVideoRunner
    from swem_tpu_torch.eval import __main__ as cli
    from swem_tpu_torch.eval.evaluator import Evaluator
    from swem_tpu_torch.ops import em_kernel, read_kernel

    seen, batches = {}, []
    warm = {"em_loop": 0, "read_memory": 0}
    warmup, infer, val = ChunkedVideoRunner.warmup, Evaluator._infer, Evaluator.val

    def counted_warmup(self, *a, **kw):
        before = launch_counts()
        warmup(self, *a, **kw)
        for k, v in launch_counts().items():
            warm[k] += v - before[k]

    def recorded_infer(self, videos, *a, **kw):
        batches.append([(v.name, int(v.frames.shape[0])) for v in videos])
        return infer(self, videos, *a, **kw)

    def recorded_val(self):
        seen.update(backend=dist.get_backend(), device=str(self.model.device))
        return val(self)

    ChunkedVideoRunner.warmup, Evaluator._infer = counted_warmup, recorded_infer
    Evaluator.val = recorded_val
    em_kernel.launches = read_kernel.launches = 0
    metrics = cli.main(argv)
    launches = {k: v - warm[k] for k, v in launch_counts().items()}
    return {**seen, "metrics": metrics, "batches": batches, "launches": launches,
            "warmup_launches": warm}


def ddp_path(card: str, train: dict, eval_refs: dict) -> dict:
    """Phase 10: data parallelism on the card; returns the launches of the
    bf16 CLI run and of the sequential distributed evaluation (each summed
    over the ranks) and the shapes the ranks handed the kernels."""
    import shutil

    import torch
    from swem_tpu_torch.models.swem import SWEM
    from swem_tpu_torch.train import trainer
    from swem_tpu_torch.train.loop import RNG_OFFSET

    t_phase = time.perf_counter()
    root, work = train["root"], ROOT / "build" / "chip_smoke_ddp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    shapes = {"em_loop": set(), "read_memory": set()}

    def keep_shapes(results):
        for r in results:
            for k, v in r["shapes"].items():
                shapes[k] |= {tuple(x) for x in v}

    # one card: Gloo, both ranks on cuda:0 (NCCL refuses two ranks on one
    # card); two or more: NCCL, a card per rank
    one_card = torch.cuda.device_count() < DDP_WORLD
    backend, device = ("gloo", "cuda:0") if one_card else ("nccl", "rank")
    print(f"data parallel: {DDP_WORLD} ranks, {backend} on "
          f"{'cuda:0 twice' if one_card else 'a card each'} ({torch.cuda.device_count()} "
          f"visible)", flush=True)

    # (a) one float32 DDP step against one process on the global batch
    ranks = launch_ranks(DDP_WORLD, "step", work, [backend, device, root, work],
                         "DDP step (float32)")
    keep_shapes(ranks)
    for r in ranks:
        if not r["ddp"] or r["rows"] != TRAIN_B // DDP_WORLD or r["launches"] != {
                "em_loop": TRAIN_FRAMES - 1, "read_memory": 0}:
            fail(f"DDP step rank {r['rank']}: {r}")
    if len({(r["params_sha"], r["grads_sha"], r["global_loss"]) for r in ranks}) != 1:
        fail("DDP step: the ranks' parameters, gradients or global losses differ")
    cfg = s3_config(root, work, "float32", data={"num_workers": 0})
    model = SWEM(cfg.model)
    model.load_state_dict(tamed_weights(cfg))
    state = trainer.create_train_state(model, cfg.solver)
    (losses, _) = counted(lambda: trainer.make_train_step(cfg)(
        state, trainer.batch_to_device(loader_batch(cfg), model.device),
        trainer.step_generator(cfg.data.seed + RNG_OFFSET, 0)),
        {"em_loop": TRAIN_FRAMES - 1, "read_memory": 0}, "one-process step")
    one = (float(losses["total_loss"]),
           {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()})
    ddp = torch.load(work / "ddp_step.pt", weights_only=True)
    del model, state
    torch.cuda.empty_cache()
    loss_rel, glob, rel = grad_difference((ddp["loss"], ddp["grads"]), one)
    print(f"DDP step (float32, S3 full width, global batch {TRAIN_B} as {DDP_WORLD} x "
          f"{TRAIN_B // DDP_WORLD}, tamed weights, global draws) against one process on the same "
          f"card: loss {ddp['loss']:.8f} vs {one[0]:.8f}, relative difference {loss_rel:.3e} "
          f"(gate 1e-3); averaged gradients' global relative L2 difference {glob:.3e} (gate "
          f"1e-2), per parameter median {float(np.median(list(rel.values()))):.3e}; the ranks' "
          f"parameters and gradients bit-equal; rank step {ranks[0]['ms']:.1f} ms", flush=True)
    if not loss_rel <= 1e-3 or not glob <= 1e-2:
        fail(f"DDP step: loss {loss_rel:.3e} (gate 1e-3), gradients {glob:.3e} (gate 1e-2)")

    # (b) the training CLI at bfloat16, 10 steps, then 2 resumed
    exp = work / "SWEM" / "S3" / "ddp"
    argv = ["--distributed", "--stage", "3", "--data_root", root, "--dtype", "bfloat16",
            "--batch_size", TRAIN_B, "--num_workers", DDP_WORKERS, "--crop_size", TRAIN_CROP,
            "--log_dir", work, "--exp", "ddp", "--log_period", 5, "--save_period", TRAIN_SAVE,
            "--vis_period", 5]
    if one_card:
        argv += ["--dist_backend", "gloo", "--device", "cuda:0"]
    runs = {}
    for label, extra, steps in (("DDP train (bfloat16)", ["--total_iters", *DDP_ITERS],
                                 DDP_ITERS[1]),
                                ("DDP train resumed", ["--total_iters", DDP_ITERS[0],
                                                       DDP_ITERS[1] + 2, "--resume",
                                                       exp / "checkpoints"], 2)):
        ranks = launch_ranks(DDP_WORLD, "train", work, argv + extra, label)
        keep_shapes(ranks)
        for r in ranks:
            want = {"em_loop": (TRAIN_FRAMES - 1) * steps, "read_memory": 0}
            if r["launches"] != want or not np.isfinite(r["losses"]).all() \
                    or len(r["losses"]) != steps or r["backend"] != backend:
                fail(f"{label} rank {r['rank']}: {r} (expected launches {want})")
            # tensorboard scalars where tensorboardX imports
            if r["writer"] != (r["rank"] == 0 and r["tensorboardx"]) or (
                    r["rank"] != 0 and r["checkpoints"]):
                fail(f"{label}: rank {r['rank']} writer {r['writer']} (tensorboardX "
                     f"{r['tensorboardx']}), checkpoints {r['checkpoints']}: rank 0 alone writes")
        if ranks[0]["checkpoints"] < 1 or ranks[0]["step"] != DDP_ITERS[1] + (
                2 if "resumed" in label else 0):
            fail(f"{label}: rank 0 wrote {ranks[0]['checkpoints']} checkpoints, step "
                 f"{ranks[0]['step']}")
        runs[label] = ranks
    files = sorted(p.name for p in (exp / "checkpoints").iterdir())
    events = list((exp / "tb").glob("*tfevents*")) if (exp / "tb").exists() else []
    writers = sum(r["writer"] for run in runs.values() for r in run)  # rank 0's, one per run
    if files != ["state.pth", "variables.pth"] or len(events) != writers:
        fail(f"DDP train: checkpoints {files}, tensorboard files {events}, {writers} writers")
    first = runs["DDP train (bfloat16)"]
    launches_ddp = {k: sum(r["launches"][k] for r in first) for k in ("em_loop", "read_memory")}
    print(f"DDP train (bfloat16, {DDP_WORLD} ranks x {DDP_WORKERS} loader workers): "
          f"{DDP_ITERS[1]} steps, Trainer.train() {first[0]['train_s']:.1f} s, "
          f"{first[0]['step_ms']:.1f} ms per step (rank 0; median gap between step calls) "
          f"against one process's {train['train_wall_s']:.1f} s, {train['step_ms']:.1f} ms "
          f"(phase 8b) on {card}; peak device memory per rank "
          f"{[round(r['peak_mb'], 1) for r in first]} MB; a smoke number: Gloo on one card stages every gradient "
          f"bucket through the host; rank 0's own losses {first[0]['losses']}; launches "
          f"{launches_ddp} over both ranks; checkpoints {files} and {len(events)} tensorboard "
          f"files, rank 0's alone", flush=True)
    eval_trained(exp / "checkpoints", root, work / "eval", train["val_video"])

    # (c) the production init in one process: the default backend, NCCL
    (nccl,) = launch_ranks(1, "train", work, [
        "--distributed", "--stage", "3", "--data_root", root, "--dtype", "bfloat16",
        "--batch_size", TRAIN_B, "--num_workers", DDP_WORKERS, "--crop_size", TRAIN_CROP,
        "--log_dir", work / "nccl", "--exp", "nccl", "--vis_period", 0, "--total_iters", 1, 2],
        "DDP train, 1 rank")
    keep_shapes([nccl])
    if nccl["backend"] != "nccl" or nccl["step"] != 2 or nccl["launches"] != {
            "em_loop": 2 * (TRAIN_FRAMES - 1), "read_memory": 0}:
        fail(f"DDP train, 1 rank (NCCL): {nccl}")

    # (d) distributed evaluation over phase 8's DAVIS tree
    n_videos = len(EVAL_VIDEOS)
    launches_eval = None
    for tag, extra in (("seq", []), ("vb", ["--video_batch", 2])):
        label = f"distributed evaluation ({'video_batch=2' if extra else 'sequential'})"
        ranks = launch_ranks(DDP_WORLD, "eval", work, [
            "--distributed", "--eval_set", "DAVIS17", "--data_root", eval_refs["davis"],
            "--resume", eval_refs["pth"], "--log_dir", work / f"eval_{tag}", "--dtype",
            "bfloat16", "--max_objs", 8, "--davis_in_size", *EVAL_IN,
            *(["--device", "cuda:0"] if one_card else []), *extra], label)
        keep_shapes(ranks)
        names = [[v for batch in r["batches"] for v, _ in batch] for r in ranks]
        if sorted(sum(names, [])) != sorted(v[0] for v in EVAL_VIDEOS) or any(
                set(a) & set(b) for a in names for b in names if a is not b):
            fail(f"{label}: slices {names} are not disjoint or do not cover the videos")
        for r in ranks:
            want = sum(max(t for _, t in batch) - 1 for batch in r["batches"])
            if r["launches"] != {"em_loop": want, "read_memory": want}:
                fail(f"{label} rank {r['rank']}: launches {r['launches']}, expected {want} each")
        if ranks[1]["metrics"] is not None or not ranks[0]["metrics"] or not all(
                np.isfinite(v) for v in ranks[0]["metrics"].values()):
            fail(f"{label}: metrics {[r['metrics'] for r in ranks]}: finite J&F from rank 0 "
                 f"alone expected")
        out = work / f"eval_{tag}" / "SWEM" / "S3" / "swem" / "results" / "DAVIS17" / "output"
        eq = total = 0
        for name, T, _ in EVAL_VIDEOS:
            a, b = read_pngs(out / name), read_pngs(eval_refs[tag] / name)
            if a.shape != b.shape:
                fail(f"{label}: {name} PNGs {a.shape}, one process {b.shape}")
            eq, total = eq + int((a == b).sum()), total + a.size
        print(f"{label}: {n_videos} videos over {DDP_WORLD} ranks as {names}; PNGs equal to "
              f"phase 8's one process on {eq / total:.6f} of pixels (gate 0.999); J&F "
              f"{ranks[0]['metrics']['J&F-Mean']:.3f} from rank 0 alone; launches per rank "
              f"{[r['launches'] for r in ranks]}", flush=True)
        if eq / total < 0.999:
            fail(f"{label}: only {eq / total:.6f} of pixels equal one process's")
        if tag == "seq":
            launches_eval = {k: sum(r["launches"][k] for r in ranks)
                             for k in ("em_loop", "read_memory")}
    print(f"data-parallel phase: wall {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"launches_ddp": launches_ddp, "launches_dist_eval": launches_eval,
            "shapes": shapes}


# ---------------------------------------------------------------------------
# phase 11: object parallelism over grids of cuda:0 repeated
def obj_box_labels(n: int) -> np.ndarray:
    """(Ho, Wo) uint8 labels 1..n of the first n OBJ_BOXES at OUT_SIZE."""
    labels = np.zeros(OUT_SIZE, np.uint8)
    for k, (y0, y1, x0, x1) in enumerate(OBJ_BOXES[:n], start=1):
        labels[y0:y1, x0:x1] = k
    return labels


def obj_model(model):
    """The 4-slot copy of ``model`` that the object grids run."""
    from swem_tpu_torch.models.swem import SWEM

    m4 = SWEM(dataclasses.replace(model.cfg, max_objs=4), device=next(model.parameters()).device)
    m4.load_state_dict(model.state_dict())
    return m4


def obj_runners(m4, card: str, cards: list) -> dict:
    """The runner over each of OBJ_GRIDS, the k-th shard on ``cards[k % len(cards)]``,
    against the unsharded runner on the model's card; returns the sharded
    runners' launch counts, summed over the grids."""
    import torch
    from swem_tpu_torch import engine
    from swem_tpu_torch.bench import uint8_frames
    from swem_tpu_torch.ops.resize import resize
    from swem_tpu_torch.parallel import make_mesh2

    n = m4.cfg.max_objs
    frames = np.stack([uint8_frames((T_OBJ,) + OUT_SIZE + (3,), 11 + b) for b in range(2)], 1)
    labels = obj_box_labels(n)
    mask = np.repeat((labels[None, ..., None] == np.arange(n + 1)).astype(np.float32), 2, 0)
    active = np.ones((2, n), bool)

    def pre(f):
        return resize(f.float() / 255.0, IN_SIZE, "bicubic")

    def peak_mb() -> float:
        return sum(torch.cuda.max_memory_allocated(d) for d in cards) / 2 ** 20

    def run(grid, videos: slice):
        """A warmed runner on ``grid`` (None: unsharded) for ``videos``, called
        once with the counts read: (maps, launches, frames/s, peak MB summed
        over ``cards``)."""
        B = len(range(2)[videos])
        shards = 1 if grid is None else grid[0] * grid[1]
        mesh = None if grid is None else make_mesh2(
            *grid, devices=[cards[k % len(cards)] for k in range(shards)])
        runner = engine.ChunkedVideoRunner(m4, OUT_SIZE, chunk=OBJ_CHUNK, preprocess=pre,
                                           mesh=mesh)
        runner.warmup(OUT_SIZE, B, n, np.uint8)
        for d in cards:
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
        t0 = time.perf_counter()
        maps, launches = counted(
            lambda: runner(torch.Generator().manual_seed(3), frames[:, videos], mask[videos],
                           active[videos]), shards * (T_OBJ - 1), f"object runner {grid}")
        dt = time.perf_counter() - t0
        return maps, launches, T_OBJ * B / dt, peak_mb()

    # the unsharded runner on each video alone, the batch a grid row holds, and
    # on both videos at once: its own B = 2 against B = 1 shows what a
    # convolution's batch size alone moves at tau = 0.05 (reported, not gated)
    alone = [run(None, slice(b, b + 1)) for b in range(2)]
    both = run(None, slice(0, 2))
    batch_share = float((both[0] == np.concatenate([a[0] for a in alone], 1)).mean())
    launches_obj = {"em_loop": 0, "read_memory": 0}
    where = ", ".join(map(str, cards))
    for grid in OBJ_GRIDS:
        B = grid[0]
        maps, launches, fps, peak = run(grid, slice(0, B))
        ref = np.concatenate([a[0] for a in alone[:B]], 1)  # per grid row: one video
        ref_fps, ref_peak = (alone[0] if B == 1 else both)[2:]
        same = float((maps == ref).mean())
        for k in launches_obj:
            launches_obj[k] += launches[k]
        print(f"object runner (bfloat16) {grid[0]}x{grid[1]} grid over [{where}], B={B}, "
              f"T={T_OBJ}, {n} objects: index pixels identical to the unsharded runner's on "
              f"each row's video {same:.6f} (gate 0.99)"
              + ("" if B == 1 else f", to its B = 2 call {float((maps == both[0]).mean()):.6f}"
                 f" (its own B = 2 against B = 1: {batch_share:.6f})")
              + f"; launches {launches} (n_shards x (T - 1)); {fps:.2f} frames/s, peak "
              f"{peak:.1f} MB, unsharded B={B} {ref_fps:.2f} frames/s, {ref_peak:.1f} MB (smoke "
              f"numbers) on {card}", flush=True)
        if same < 0.99:
            fail(f"object runner {grid}: only {same:.4f} of index pixels agree with unsharded")
    return launches_obj


def obj_session(m4, cards: list) -> None:
    """The session on a 1x2 grid over ``cards`` (repeated if it holds one):
    2 slots, OBJ_GROW_AT pushes, grow(4), slots 3 and 4 added, then pushes
    up to N_PUSH steps; per step against the unsharded session."""
    from swem_tpu_torch.bench import uint8_frames
    from swem_tpu_torch.parallel import make_mesh2
    from swem_tpu_torch.serve import StreamingSession

    dev = next(m4.parameters()).device
    labels = obj_box_labels(m4.cfg.max_objs)
    sframes = uint8_frames((N_PUSH + 1,) + OUT_SIZE + (3,), 21)
    first, late = np.where(labels <= 2, labels, 0), np.where(labels > 2, labels, 0)

    def steps(sess):
        maps = [sess.push(f) for f in sframes[1:OBJ_GROW_AT + 1]]
        sess.grow(4)
        maps.append(sess.add_objects(sframes[OBJ_GROW_AT + 1], late, [3, 4]))
        return np.stack(maps + [sess.push(f) for f in sframes[OBJ_GROW_AT + 2:]])

    grid = [cards[k % len(cards)] for k in range(2)]
    streams = {}
    for shards, mesh in ((1, None), (2, make_mesh2(1, 2, devices=grid))):
        sess = StreamingSession(m4.cfg, m4.state_dict(), raw_hw=OUT_SIZE, in_size=IN_SIZE,
                                out_size=OUT_SIZE, n_slots=2, device=dev, mesh=mesh)
        sess.warmup()
        sess.start(sframes[0], first)
        if mesh is not None:
            streams[shards] = counted(lambda: steps(sess), shards * N_PUSH, f"session {shards}")[0]
            continue
        # unsharded, the pushes replay the session's graph: counted on the
        # card, where grow(4)'s capture runs one eager push besides
        streams[shards], ran = kernels_ran(lambda: steps(sess))
        if ran != {k: N_PUSH + 1 for k in ran}:
            fail(f"object session: the unsharded session ran {ran} over {N_PUSH} steps and a "
                 f"capture, expected {N_PUSH + 1} each")
    shares = (streams[2] == streams[1]).reshape(N_PUSH, -1).mean(1)
    held = float((streams[2][OBJ_GROW_AT][late > 0] == late[late > 0]).mean())
    print(f"object session (bfloat16) 1x2 grid over [{', '.join(map(str, grid))}]: {N_PUSH} "
          f"steps, grow(4) after {OBJ_GROW_AT}, index pixels identical to the unsharded "
          f"session's per step {' '.join(f'{v:.6f}' for v in shares)} (gate 0.99); added slots "
          f"hold {held:.6f} of their boxes", flush=True)
    if shares.min() < 0.99 or held < 1.0:
        fail(f"object session: {shares.min():.4f} of a step's pixels agree with unsharded, the "
             f"added slots hold {held:.4f} of their boxes")


def obj_path(model, card: str, eval_refs: dict, train_root: Path) -> dict:
    """Phase 11: the runner, the session, the evaluator and the train step
    sharded over object grids of one card; returns the sharded runners'
    launch counts, summed over the grids."""
    import torch
    from swem_tpu_torch import parallel
    from swem_tpu_torch.config import EvalConfig, SWEMConfig
    from swem_tpu_torch.eval.evaluator import Evaluator
    from swem_tpu_torch.models import em
    from swem_tpu_torch.models.swem import SWEM
    from swem_tpu_torch.parallel import EngineSharding, make_mesh2
    from swem_tpu_torch.train.trainer import batch_to_device, create_train_state, make_train_step
    from swem_tpu_torch.utils import setup_logger

    t_phase = time.perf_counter()
    dev = next(model.parameters()).device  # cuda:0
    m4 = obj_model(model)
    launches_obj = obj_runners(m4, card, [dev])
    obj_session(m4, [dev])

    # the evaluator on phase 8's video 0 with two object shards on cuda:0
    work = eval_refs["davis"].parent
    ecfg = SWEMConfig(model=model.cfg, log_dir=str(work / "logs" / "obj"),
                      eval=EvalConfig(data_root=str(work / "davis_one"), max_objs=8,
                                      davis_in_size=EVAL_IN, obj_parallel=2))
    name, T0, _ = EVAL_VIDEOS[0]
    eval_devices = parallel.eval_devices
    parallel.eval_devices = lambda device=None: [dev, dev]
    try:
        ev = Evaluator(ecfg, model.state_dict(), device=dev,
                       logger=setup_logger("chip_smoke_eval_obj", str(work / "logs" / "obj"),
                                           screen=False))
        ev.evaluate()
        counted(ev.evaluate, 2 * (T0 - 1), "object evaluator")
    finally:
        parallel.eval_devices = eval_devices
    meshes = [k[-1] for k in ev._runners]
    got, ref = read_pngs(Path(ev.out_root) / name), read_pngs(eval_refs["seq"] / name)
    same = float((got == ref).mean()) if got.shape == ref.shape else 0.0
    print(f"object evaluator (bfloat16) obj_parallel=2 on [cuda:0, cuda:0]: runner meshes "
          f"{meshes}; {name}'s PNGs identical to phase 8's {same:.6f} (gate 0.99)", flush=True)
    if same < 0.99 or meshes != [(("data", "obj"), (1, 2), (str(dev), str(dev)))]:
        fail(f"object evaluator: {same:.4f} of pixels agree with phase 8, meshes {meshes}")

    # one float32 S3 step on a 1x2 grid against the unsharded step
    tcfg = s3_config(train_root, train_root, "float32", data={"batch_size": 2, "num_workers": 0})
    batch, weights = loader_batch(tcfg), tamed_weights(tcfg)
    mc = tcfg.model
    bases = em.init_bases(torch.Generator().manual_seed(5), 2, mc.max_objs, mc.keydim,
                          mc.valdim, mc.num_bases)

    def train_step(sharding, k1):
        tm = SWEM(mc, device=dev)
        tm.load_state_dict(weights)
        state = create_train_state(tm, tcfg.solver)
        step = make_train_step(tcfg, sharding=sharding)
        losses, _ = counted(lambda: step(state, batch_to_device(batch, tm.device),
                                         bases=bases.to(tm.device)),
                            {"em_loop": k1, "read_memory": 0}, f"train step {k1 // 2} shards")
        return (float(losses["total_loss"]),
                {k: p.grad.detach().double().cpu() for k, p in tm.named_parameters()})

    plain = train_step(None, TRAIN_FRAMES - 1)
    sharded = train_step(EngineSharding(make_mesh2(1, 2, devices=[dev] * 2)),
                         2 * (TRAIN_FRAMES - 1))
    loss_rel, glob, _ = grad_difference(sharded, plain)
    print(f"object train step (float32, B=2, {TRAIN_CROP}x{TRAIN_CROP}, T={TRAIN_FRAMES}, tamed "
          f"weights) 1x2 grid against unsharded: loss {sharded[0]:.8f} vs {plain[0]:.8f}, "
          f"relative difference {loss_rel:.3e} (gate 1e-3); gradients' global relative L2 "
          f"difference {glob:.3e} (gate 1e-2)", flush=True)
    if not loss_rel <= 1e-3 or not glob <= 1e-2:
        fail(f"object train step: loss {loss_rel:.3e} (gate 1e-3), gradients {glob:.3e} "
             f"(gate 1e-2)")
    print(f"object-parallel phase: wall {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches_obj


def obj_cards_main() -> int:
    """``chip_smoke.py --obj-cards``: phase 11's runner grids and session over
    distinct cards (two or more), the k-th shard on card k mod the count,
    each held against the unsharded runner or session on cuda:0; first each
    kernel's per-shard launch on every card against its launch on cuda:0,
    bit for bit (the cards are alike, the kernels deterministic)."""
    import torch

    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < 2:
        print(f"chip_smoke --obj-cards: needs two or more CUDA devices, found {n_cards}",
              file=sys.stderr)
        return 1
    if not (ROOT / "swem_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    from swem_tpu_torch.config import ModelConfig
    from swem_tpu_torch.models.swem import SWEM
    from swem_tpu_torch.ops import build, em_kernel, read_kernel
    from swem_tpu_torch.ops.em_kernel import l2norm

    t_start = time.perf_counter()
    card = card_line()
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    print(f"cards: {n_cards} x {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    report = build.build()
    print(f"build: {time.perf_counter() - t_start:.1f} s wall", flush=True)

    rng = np.random.default_rng(12)
    x, masks, kappa0, zita0 = em_inputs(rng, 1, 1, 1620, 128, 128, 0.3)
    qk, mk, mv, valid = read_inputs(rng, 1, 1, 1620, 128, 256, 512, "update bank invalid")
    qn, mkn = l2norm(qk, -1), l2norm(mk, -2)
    ref = None
    for d in cards:
        em_in = [t.to(d) for t in (x, masks, kappa0, zita0)]
        got = [t.cpu() for t in list(em_kernel.em_loop(*em_in, n_iters=4, tau=0.05))
               + list(read_kernel.read_normalized(*(t.to(d) for t in (qn, mkn, mv, valid)),
                                                  tau=0.05))]
        ref = got if ref is None else ref
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            fail(f"the kernels on {d} gave other bits than on {cards[0]}")
    print(f"K1 (1, 1, 1620, 128, 128) x 4 rounds and K2 (1, 1, 1620, 128, 256, 512) on each of "
          f"{n_cards} cards: bit-identical to cuda:0", flush=True)

    m4 = obj_model(SWEM(ModelConfig(dtype="bfloat16")).init_weights(0))
    launches = obj_runners(m4, card, cards)
    obj_session(m4, cards)
    faulthandler.cancel_dump_traceback_later()
    print(f"chip_smoke --obj-cards: passed in {time.perf_counter() - t_start:.1f} s; "
          f"sharded runners' launches {launches}; build {sorted(report)}", flush=True)
    return 0


# ---------------------------------------------------------------------------
# phase 12: offline scoring, the profiling helpers, a converted optimizer state
def run_module(args, label: str) -> str:
    """``python -m <args>`` from the checkout's root; fails the run on a
    non-zero exit, returns its stdout."""
    import subprocess

    out = subprocess.run([sys.executable, "-m"] + [str(a) for a in args], cwd=ROOT,
                         capture_output=True, text=True, timeout=SCORING_TIMEOUT_S)
    if out.returncode != 0:
        fail(f"{label}: exit {out.returncode}: {out.stderr[-2000:]}")
    return out.stdout


def scoring_clis(eval_refs: dict, work: Path) -> str:
    """Phase 12(a): the port's scoring CLIs on phase 8's DAVIS tree, on the
    card's host (no JAX there): the semi-supervised CSV of phase 8's bf16
    PNGs byte-equal to the one its ``get_metrics`` wrote; the unsupervised
    task on the ground truth with object ids permuted, its own PNGs as
    proposals, J&F 1.000; CodaLab with the ground truth as the submission,
    ``GlobalMean: 1.000000``. Returns a summary."""
    import shutil

    from swem_tpu_torch.data.palette import davis_palette, load_label_mask, save_seg_mask

    davis, ann = eval_refs["davis"], eval_refs["davis"] / "Annotations" / "480p"
    res = work / "res_bf16"
    shutil.copytree(eval_refs["seq"], res)
    t0 = time.perf_counter()
    run_module(["swem_tpu_torch.evaluation_method", "--davis_path", davis, "--results_path", res],
               "evaluation_method (semi-supervised)")
    semi_s = time.perf_counter() - t0
    csv = "global_results-DAVIS17.csv"
    got, want = (res / csv).read_bytes(), (eval_refs["save_dir"] / csv).read_bytes()
    if got != want:
        fail(f"evaluation_method: {csv} {got!r} differs from phase 8's get_metrics {want!r}")

    unsup = work / "davis_unsup"
    shutil.copytree(davis / "ImageSets", unsup / "ImageSets")
    rng, palette = np.random.default_rng(12), davis_palette()
    for seq in sorted(p.name for p in ann.iterdir()):
        pngs = sorted((ann / seq).glob("*.png"))
        n = int(load_label_mask(str(pngs[0])).max())
        perm = np.concatenate([[0], rng.permutation(n) + 1, np.arange(n + 1, 256)]).astype(np.uint8)
        (unsup / "Annotations_unsupervised" / "480p" / seq).mkdir(parents=True)
        for png in pngs:
            save_seg_mask(perm[load_label_mask(str(png))],
                          str(unsup / "Annotations_unsupervised" / "480p" / seq / png.name),
                          palette)
    proposals = work / "proposals"
    shutil.copytree(ann, proposals)
    t0 = time.perf_counter()
    run_module(["swem_tpu_torch.evaluation_method", "--davis_path", unsup, "--task",
                "unsupervised", "--results_path", proposals], "evaluation_method (unsupervised)")
    unsup_s = time.perf_counter() - t0
    unsup_jf = read_global_csv(proposals)["J&F-Mean"]
    if unsup_jf != 1.0:
        fail(f"evaluation_method --task unsupervised: ground truth as proposals J&F {unsup_jf}")

    codalab = work / "codalab"
    shutil.copytree(davis / "ImageSets", codalab / "ref" / "ImageSets")
    shutil.copytree(ann, codalab / "ref" / "Annotations" / "480p")
    shutil.copytree(ann, codalab / "res")
    t0 = time.perf_counter()
    run_module(["swem_tpu_torch.evaluation_codalab", codalab, work / "codalab_out", "--set",
                "val"], "evaluation_codalab")
    codalab_s = time.perf_counter() - t0
    scores = (work / "codalab_out" / "scores.txt").read_text()
    if not scores.startswith("GlobalMean: 1.000000\n"):
        fail(f"evaluation_codalab: ground truth as the submission scored {scores!r}")
    return (f"evaluation_method's {csv} byte-equal to phase 8's ({got.decode().split()[1]}; "
            f"{semi_s:.1f} s); unsupervised, ids permuted, J&F {unsup_jf:.3f} ({unsup_s:.1f} s); "
            f"CodaLab {scores.splitlines()[0]} ({codalab_s:.1f} s)")


def profiling_helpers(model, card: str, work: Path) -> dict:
    """Phase 12(b): phase 5's bfloat16 ``run_video`` (T = 10) once under
    ``utils.profiling.profile_trace``: K1 and K2 T - 1 launches, the exported
    trace's kernel time (``device_seconds_from_trace``) within 1% of
    ``device_busy_seconds`` of the same run, ``log_memory``'s peak equal to
    ``torch.cuda.max_memory_allocated`` over the run. Returns the launches."""
    import torch
    from swem_tpu_torch import engine
    from swem_tpu_torch.bench import synthetic_video
    from swem_tpu_torch.utils import setup_logger
    from swem_tpu_torch.utils.profiling import (
        device_busy_seconds,
        device_memory_stats,
        device_seconds_from_trace,
        log_memory,
        profile_trace,
    )

    frames_np, mask_np = synthetic_video(T_VIDEO, IN_SIZE, OUT_SIZE, model.cfg.max_objs)
    frames, init_mask = torch.from_numpy(frames_np).cuda(), torch.from_numpy(mask_np).cuda()
    active = torch.ones((1, model.cfg.max_objs), dtype=torch.bool, device="cuda")
    trace_dir = work / "trace"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def profiled():
        with profile_trace(str(trace_dir)) as prof:
            engine.run_video(model, torch.Generator().manual_seed(1), frames, init_mask, active,
                             OUT_SIZE)
            torch.cuda.synchronize()
        return prof

    prof, launches = counted(profiled, T_VIDEO - 1, "profile_trace run_video (bfloat16)")
    busy, from_trace = device_busy_seconds(prof), device_seconds_from_trace(str(trace_dir))
    gap = abs(from_trace - busy) / busy
    size = sum(p.stat().st_size for p in trace_dir.iterdir())
    print(f"profile_trace (bfloat16 run_video T={T_VIDEO}) on {card}: trace {size / 2 ** 20:.1f} "
          f"MiB; device_seconds_from_trace {from_trace * 1e3:.3f} ms, device_busy_seconds "
          f"{busy * 1e3:.3f} ms, relative gap {gap:.2e} (gate 1e-2); launches {launches}",
          flush=True)
    if not gap <= 1e-2:
        fail(f"device_seconds_from_trace {from_trace} against device_busy_seconds {busy}")
    stats = device_memory_stats(model.device)
    peak = torch.cuda.max_memory_allocated(model.device)
    log_memory(setup_logger("chip_smoke_memory", None), model.device,
               prefix="log_memory after the profiled run_video: ")
    if stats["peak_bytes_in_use"] != peak or not 0 < stats["bytes_in_use"] <= peak \
            or stats["bytes_limit"] < peak:
        fail(f"device_memory_stats {stats} against max_memory_allocated {peak}")
    return launches


def converted_resume(train_root: Path, work: Path) -> dict:
    """Phase 12(c): flagship optax-like moments from a seed (mu ~ N(0, 1e-3),
    nu ~ |N(0, 1e-6)|, count 7, the S3 solver with a milestone at 5)
    through ``io.jax_import.train_snapshot`` and ``save_train_checkpoint``;
    a float32 S3 ``Trainer`` resumed from it on the card and on the CPU
    (plain versions), each one step at B = 2 on the same batch and bases
    from phase 8b's tamed weights: the moments bit-equal to the inputs
    after the load and placed as a native checkpoint's, step 7, LR base_lr
    * gamma, each step AdamW's from the converted state (``adamw_worst``);
    card vs CPU the loss within 1e-3, the gradients and the updated
    parameters within 1e-2 relative L2 (phase 8b's gates); K1 T - 1
    launches on the card. Returns the card step's launches."""
    import torch
    from swem_tpu_torch.io.checkpoint import load_train_checkpoint, save_train_checkpoint
    from swem_tpu_torch.io.jax_import import train_snapshot
    from swem_tpu_torch.models import em
    from swem_tpu_torch.models.swem import SWEM
    from swem_tpu_torch.train.loop import Trainer
    from swem_tpu_torch.train.solver import make_optimizer
    from swem_tpu_torch.train.trainer import batch_to_device
    from swem_tpu_torch.utils import setup_logger

    ckpt, count = work / "converted", 7
    cfg = s3_config(train_root, work / "logs", "float32", total=(5, 10),
                    data={"batch_size": 2, "num_workers": 0}, resume=str(ckpt),
                    from_scratch=False)
    with torch.device("meta"):
        names = SWEM(cfg.model, device="meta")
    rng = np.random.default_rng(7)
    shapes = {n: tuple(p.shape) for n, p in names.named_parameters()}
    mu = {n: torch.from_numpy(rng.standard_normal(s, dtype=np.float32) * np.float32(1e-3))
          for n, s in shapes.items()}
    nu = {n: torch.from_numpy(np.abs(rng.standard_normal(s, dtype=np.float32)) * np.float32(1e-6))
          for n, s in shapes.items()}
    save_train_checkpoint(ckpt, train_snapshot(names, cfg.solver, tamed_weights(cfg), count,
                                               {"mu": mu, "nu": nu}))
    batch = loader_batch(cfg)
    m = cfg.model
    bases = em.init_bases(torch.Generator().manual_seed(5), 2, m.max_objs, m.keydim, m.valdim,
                          m.num_bases)
    lr = cfg.solver.base_lr * cfg.solver.gamma

    def native_placement(device) -> tuple:
        """(device, dtype) of ``step`` and ``exp_avg`` after a natively
        stepped optimizer's checkpoint is loaded as ``Trainer`` loads one
        (``load_train_checkpoint`` onto its device, ``load_state_dict``)."""
        p = torch.nn.Parameter(torch.zeros(4, device=device))
        opt, _ = make_optimizer(cfg.solver, [p])
        p.grad = torch.ones_like(p)
        opt.step()
        torch.save(opt.state_dict(), work / "native_opt.pth")
        fresh, _ = make_optimizer(cfg.solver, [torch.nn.Parameter(torch.zeros(4, device=device))])
        fresh.load_state_dict(load_train_checkpoint(work / "native_opt.pth", map_location=device))
        s = fresh.state[fresh.param_groups[0]["params"][0]]
        return (s["step"].device, s["step"].dtype, s["exp_avg"].device, s["exp_avg"].dtype)

    def resumed(label, device, k1):
        tr = Trainer(cfg, logger=setup_logger(f"chip_smoke_resume_{label}", str(work / "logs"),
                                              label, screen=False), device=device)
        native = native_placement(tr.device)
        opt, params = tr.state.optimizer, dict(tr.model.named_parameters())
        if tr.state.step != count or abs(opt.param_groups[0]["lr"] / lr - 1) > 1e-12:
            fail(f"{label}: resumed at step {tr.state.step}, lr {opt.param_groups[0]['lr']}")
        for n, p in params.items():
            s = opt.state[p]
            if not (torch.equal(s["exp_avg"].cpu(), mu[n]) and torch.equal(s["exp_avg_sq"].cpu(),
                                                                            nu[n])):
                fail(f"{label}: {n}'s loaded moments differ from the converted ones")
            placed = (s["step"].device, s["step"].dtype, s["exp_avg"].device, s["exp_avg"].dtype)
            if placed != native or float(s["step"]) != count:
                fail(f"{label}: {n}'s step and exp_avg {placed} (a native checkpoint's {native}), "
                     f"step {float(s['step'])}")
        before = {n: p.detach().double().cpu() for n, p in params.items()}
        t0 = time.perf_counter()
        losses, launches = counted(
            lambda: tr.train_step(tr.state, batch_to_device(batch, tr.device),
                                  bases=bases.to(tr.device)),
            {"em_loop": k1, "read_memory": 0}, f"{label} resumed step")
        wall = time.perf_counter() - t0
        after = {n: p.detach().double().cpu() for n, p in params.items()}
        grads = {n: p.grad.detach().double().cpu() for n, p in params.items()}
        worst, where = adamw_worst(before, after, grads)
        if not worst <= 1.0 or any(float(s["step"]) != count + 1 for s in opt.state.values()):
            fail(f"{label}: the resumed step is not AdamW's from the converted moments at step "
                 f"{count + 1} ({worst:.3f} of the float32 bound at {where})")
        return (float(losses["total_loss"]), grads, launches, wall, native,
                {n: after[n] - before[n] for n in params}, after, worst)

    def adamw_worst(before, after, grads) -> float:
        """The step against AdamW's update computed in float64 from the
        converted moments (mu, nu), step count + 1, the LR past the
        milestone and the step's own gradients: the worst element's
        |got - want| over its float32 bound: two ulps of the stored parameter
        (the decay's and the update's roundings, each at most one ulp of a
        neighbouring binade) + 1e-4 of the update taken with the first
        moment's two terms added in magnitude (float32 rounds them before
        they cancel)."""
        b1, b2 = cfg.solver.momentum
        t, wd = count + 1, cfg.solver.weight_decay
        worst = (0.0, "")
        for n, g in grads.items():
            m = b1 * mu[n].double() + (1 - b1) * g
            m_abs = b1 * mu[n].double().abs() + (1 - b1) * g.abs()
            v = b2 * nu[n].double() + (1 - b2) * g * g
            denom = v.sqrt() / (1 - b2 ** t) ** 0.5 + 1e-8
            want = before[n] * (1 - lr * wd) - lr / (1 - b1 ** t) * m / denom
            w32 = want.float().abs()
            ulp = (torch.nextafter(w32, torch.full_like(w32, float("inf"))) - w32).double()
            bound = 2 * ulp + 1e-4 * lr / (1 - b1 ** t) * m_abs / denom
            ratio = ((after[n] - want).abs() / bound).flatten()
            i = int(ratio.argmax())
            if float(ratio[i]) > worst[0]:
                got, ref = float(after[n].flatten()[i]), float(want.flatten()[i])
                worst = (float(ratio[i]), f"{n}[{i}]: got {got!r}, want {ref!r}, bound "
                                          f"{float(bound.flatten()[i]):.3e}")
        return worst

    def placement(p) -> str:
        return "step {} {}, exp_avg {} {}".format(*(str(x).replace("torch.", "") for x in p))

    card = resumed("card", None, TRAIN_FRAMES - 1)
    cpu = resumed("cpu", "cpu", 0)
    loss_rel, grad_rel, _ = grad_difference(card[:2], cpu[:2])
    _, param_rel, _ = grad_difference((1.0, card[6]), (1.0, cpu[6]))
    _, upd_rel, _ = grad_difference((1.0, card[5]), (1.0, cpu[5]))
    print(f"converted optimizer state (AdamW moments of the flagship, count {count}, milestone "
          f"5): resumed at step {count}, lr {lr:.3e}, moments bit-equal on the card and the CPU, "
          f"step and moments placed as a native checkpoint's (card {placement(card[4])}, CPU "
          f"{placement(cpu[4])}); one float32 step at B=2: AdamW's update from the converted "
          f"state at step {count + 1} in float64 within {card[7]:.3f} (card) and {cpu[7]:.3f} "
          f"(CPU) of the float32 bound (gate 1); card vs CPU: loss {card[0]:.8f} vs "
          f"{cpu[0]:.8f}, relative difference {loss_rel:.3e} (gate 1e-3), gradients' global "
          f"relative L2 difference {grad_rel:.3e} (gate 1e-2), updated parameters' {param_rel:.3e} "
          f"(gate 1e-2), the updates' {upd_rel:.3e} (not gated: Adam divides by the seeded "
          f"second moments); card {card[3]:.1f} s, CPU {cpu[3]:.1f} s; launches {card[2]}",
          flush=True)
    if not loss_rel <= 1e-3 or not grad_rel <= 1e-2 or not param_rel <= 1e-2:
        fail(f"converted resume card vs CPU: loss {loss_rel:.3e}, gradients {grad_rel:.3e}, "
             f"parameters {param_rel:.3e}")
    return card[2]


def scoring_path(model, card: str, eval_refs: dict, train_root: Path) -> dict:
    """Phase 12: (a) the scoring CLIs, (b) the profiling helpers on the
    bfloat16 main path, (c) a converted optimizer state resumed on the card.
    Returns the launches of (b) and (c)."""
    import shutil

    t_phase = time.perf_counter()
    work = ROOT / "build" / "chip_smoke_phase12"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    print(f"scoring CLIs on phase 8's DAVIS tree: {scoring_clis(eval_refs, work)}", flush=True)
    launches = {"profiled run_video": profiling_helpers(model, card, work),
                "converted resume step": converted_resume(train_root, work)}
    print(f"phase 12: launches {launches}; wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


def read_global_csv(save_dir: Path) -> dict:
    names, values = (save_dir / "global_results-DAVIS17.csv").read_text().split()
    return dict(zip(names.split(","), map(float, values.split(","))))


def profile_main_path(model, frames, init_mask, active, label: str) -> None:
    """Where the main path's time goes: one more ``run_video`` under
    ``torch.profiler`` (``report_profile``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from swem_tpu_torch import engine

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_video(model, torch.Generator().manual_seed(1), frames, init_mask, active,
                         OUT_SIZE)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    report_profile(prof, wall_us, f"profile ({label}): run_video T={T_VIDEO}")


def report_profile(prof, wall_us: float, header: str) -> float:
    """Print device time summed by kernel group (every kernel of the port's
    two groups, the three largest of the others) and the share of the
    run's wall time in which no kernel ran on the card; returns that
    share."""
    import torch
    from swem_tpu_torch.utils.profiling import device_busy_seconds

    # cuBLAS's GEMMs are named *xmma_gemm* too: only these keys mark a convolution
    groups = (("em_loop kernel", ("em_loop_kernel",)),
              ("read_memory kernel", ("read_kernel",)),
              ("convolution", ("fprop", "dgrad", "wgrad", "implicit", "conv", "cudnn")),
              ("matmul", ("gemm", "gemv")))
    port_groups = ("em_loop kernel", "read_memory kernel")
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = device_busy_seconds(prof) * 1e6  # raises when no kernel was recorded
    by_group, by_name = {}, {}  # by_name: name -> [group, device us, count]
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        name = e.name.lower()
        group = next((g for g, keys in groups if any(k in name for k in keys)), "other")
        by_group[group] = by_group.get(group, 0.0) + dur
        entry = by_name.setdefault(e.name[:90], [group, 0.0, 0])
        entry[1] += dur
        entry[2] += 1
    total = sum(by_group.values())
    print(f"{header} wall {wall_us / 1e3:.3f} ms, {len(kernels)} kernels, device busy "
          f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.4f}", flush=True)
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {g}: {us / 1e3:.3f} ms ({us / total:.4f} of device time)", flush=True)
        names = sorted(((n, v) for n, v in by_name.items() if v[0] == g), key=lambda kv: -kv[1][1])
        for n, (_, us_n, count) in names if g in port_groups else names[:3]:
            print(f"    {us_n / 1e3:.3f} ms, {count} launches: {n}", flush=True)
    return 1 - busy / wall_us


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "swem_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    from swem_tpu_torch.config import full_float32
    from swem_tpu_torch.ops import build

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(f"TF32 flags as found (left in force): cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    peaks = PEAKS["pcie" if "PCIe" in card else "sxm"]

    t0 = time.perf_counter()
    report = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall, "
          + ", ".join(f"{k} {v['seconds']:.1f} s" for k, v in report.items()), flush=True)
    for name, r in report.items():
        for line in r["log"].splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "error")):
                print(f"  {name}: {line.strip()}", flush=True)

    with full_float32():  # the float32 yardsticks: plain versions, torch.matmul, SDPA
        entries = [check_em(peaks), check_read(peaks)]
    check_no_grad_launch()
    shapes = {"em_loop": set(), "read_memory": set()}
    with recording_shapes(shapes):
        launches, launches_f32, bf16 = main_path(card)
        launches_runner = runner_path(bf16, card)
        launches_session = session_path(bf16, card)
        launches_export = export_path(bf16, card)
        launches_eval, eval_refs = eval_path(bf16, card)
        train = train_path(card)
        launches_obj = obj_path(bf16, card, eval_refs, train["root"])
        scoring_path(bf16, card, eval_refs, train["root"])
        del bf16
    ddp = ddp_path(card, train, eval_refs)
    for k, v in ddp["shapes"].items():
        shapes[k] |= v
    with full_float32():
        path_errs = check_path_shapes(shapes, peaks)
        new_errs = check_new_shapes(peaks)
    for e in entries:
        e["max_abs_err"] = max(e["max_abs_err"], path_errs[e["name"]], new_errs[e["name"]])
        e["launches"] = launches[e["name"]]
        e["launches_f32"] = launches_f32[e["name"]]
        e["launches_runner"] = launches_runner[e["name"]]
        e["launches_session"] = launches_session[e["name"]]
        e["launches_export"] = launches_export[e["name"]]
        e["launches_eval"] = launches_eval[e["name"]]
        e["launches_train"] = train["launches"][e["name"]]
        e["launches_train_f32"] = train["launches_f32"][e["name"]]
        e["launches_ddp"] = ddp["launches_ddp"][e["name"]]
        e["launches_dist_eval"] = ddp["launches_dist_eval"][e["name"]]
        e["launches_obj"] = launches_obj[e["name"]]
    faulthandler.cancel_dump_traceback_later()
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--obj-cards"]:
        sys.exit(obj_cards_main())
    sys.exit(replay_main(sys.argv[2:]) if sys.argv[1:2] == ["--replay"] else main())
