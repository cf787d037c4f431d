#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: build, check, run.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit; imports nothing of JAX or of
``swem_tpu``. Phases, each fatal on failure:

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
   480x854, two slots), ``warmup``, ``start`` and 12 pushes, each launching
   each kernel exactly once, held against ``engine.init_memory`` +
   ``engine.step`` on the same preprocessed frames and draw (>= 99% of
   pixels per frame); then ``prepare_grow(3)``, ``grow(3)`` and
   ``add_objects`` with a third box, which must hold index 3, the memory
   in use growing by far less than one copy of the weights. Prints the
   push's wall p50/p95 and the device's busy ms per push.
8. one JSON line with every kernel's numbers (``launches`` from the
   bfloat16 run, ``launches_f32`` from the float32 one, ``launches_runner``
   from phase 6's index runner, ``launches_session`` over phase 7's 12
   pushes), then the card line, then the final ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
T_VIDEO = 10
T_RUNNER, CHUNK, N_PUSH = 24, 16, 12
IN_SIZE, OUT_SIZE = (480, 864), (480, 854)
# peak rates of an H100 (NVIDIA data sheet): FP32 outside the tensor cores, memory,
# dense TF32 on the tensor cores
PEAKS = {"sxm": (67e12, 3.35e12, 495e12), "pcie": (51e12, 2.0e12, 378e12)}
READ_CASES = ("all valid", "update bank invalid", "object never seen")


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


def check_em(peaks) -> dict:
    """K1 against its plain version in float64; returns the kernel's JSON entry."""
    import torch
    from swem_tpu_torch.ops import em_kernel

    rng = np.random.default_rng(0)
    tau = 0.05
    # rtol/atol from the JAX package's kernel test: tight for one round; at 4
    # rounds tau = 0.05 makes the loop chaotic, so summation-order ulps grow.
    # Flagship x has std 0.3 (|x| about 3.4): with std 1 even float32 against
    # float64 of the same plain code leaves these bounds at 4 rounds.
    # (B, N, P, Ck, L): flagship; ragged P with narrow Ck and L and an empty
    # slot; the reference's default L = 256; more tile items than CTAs.
    cases = [
        ("flagship 1 round", (1, 2, 1620, 128, 128), 0.3, 1, None, (1e-4, 1e-5)),
        ("flagship 4 rounds", (1, 2, 1620, 128, 128), 0.3, 4, None, (5e-2, 1e-2)),
        ("ragged, empty slot", (2, 8, 130, 16, 8), 1.0, 4, 5, (5e-2, 1e-2)),
        ("flagship L=256", (1, 2, 1620, 128, 256), 0.3, 4, None, (5e-2, 1e-2)),
        ("N=8 P=3600", (1, 8, 3600, 128, 128), 0.3, 4, None, (5e-2, 1e-2)),
    ]
    max_err = 0.0
    for name, shape, x_std, n_iters, empty, (rtol, atol) in cases:
        inputs = em_inputs(rng, *shape, x_std, empty)
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
        max_err = max(max_err, *errs)
        print(f"K1 {name}: max abs err vs float64 z {errs[0]:.3e} kappa {errs[1]:.3e} "
              f"zita {errs[2]:.3e}; worst err/limit (z, kappa, zita) kernel {ratios[0]:.3f} "
              f"{ratios[1]:.3f} {ratios[2]:.3f}, float32 plain {ratios[3]:.3f} {ratios[4]:.3f} "
              f"{ratios[5]:.3f}; rerun bit-identical", flush=True)
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
    gemm = 2.0 * P * Ck * 2 * N * L  # one (P,Ck)@(Ck,N*2*L) product
    # E and M each round; the W step's product is the next E step's scaled by
    # 1/|x| per pixel, so the least work has no third GEMM
    flops = gemm * 2 * n_iters
    nbytes = 4.0 * (x.numel() + masks.numel() + kappa0.numel() + zita0.numel()
                    + B * N * 2 * P * L + kappa0.numel() + zita0.numel())
    # the kernel runs its products as 3xTF32 on the tensor cores: the route's
    # bound is three TF32 products each; the FP32 CUDA-core bound beside it
    b_ms, b_by = bound_ms(3 * flops, nbytes, (peaks[2], peaks[1]))
    fp32_ms, fp32_by = bound_ms(flops, nbytes, peaks)
    print(f"K1 time: kernel {ms:.4f} ms (one launch, {2 * n_iters} grid barriers), plain "
          f"{plain:.4f} ms, its 8 products as torch.matmul {matmul_ms:.4f} ms; bound {b_ms:.4f} "
          f"ms ({b_by}, 3xTF32 on the tensor cores), FP32 bound {fp32_ms:.4f} ms ({fp32_by}, "
          f"CUDA cores), bytes {nbytes / peaks[1] * 1e3:.4f} ms", flush=True)
    return {"name": "em_loop", "route": "cuda", "source": "swem_tpu_torch/csrc/em_loop.cu",
            "replaces": "swem_tpu/ops/em_pallas.py:56 (_em_kernel, pallas_call at :196)",
            "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def read_inputs(rng, B, N, P, Ck, Lm, Cv, valid_case):
    """Std-normal qk, mk, mv on the card and base_valid for one of READ_CASES."""
    import torch

    qk, mk, mv = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).cuda()
                  for s in ((B, P, Ck), (B, N, 2, Ck, Lm), (B, N, 2, Cv, Lm)))
    valid = torch.ones((B, N, 2, Lm), dtype=torch.bool, device="cuda")
    if valid_case != "all valid":
        valid[:, 0, :, Lm // 2:] = False  # object 0: update bank not yet valid
    if valid_case == "object never seen":
        valid[:, 1] = False
    return qk, mk, mv, valid


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
            name = f"{shape_name}, {valid_case}"
            qk, mk, mv, valid = read_inputs(rng, *shape, valid_case)
            qn, mkn = l2norm(qk, -1), l2norm(mk, -2)
            got = read_kernel.read_normalized(qn, mkn, mv, valid, tau=tau)
            # float64 referee: 3xTF32 and FP32 each lie about 3e-6 from it
            ref = read_kernel.read_plain(qn.double(), mkn.double(), mv.double(), valid, tau=tau)
            again = read_kernel.read_normalized(qn, mkn, mv, valid, tau=tau)
            torch.cuda.synchronize()
            errs = [compare(f"K2 {name} {o}", g, r, 1e-4, 1e-6)
                    for o, g, r in zip(("mem_out", "exp_aff"), got, ref)]
            if valid_case == "object never seen" and bool(got[0][:, 1].any() or got[1][:, 1].any()):
                fail(f"K2 {name}: an object with no valid base must read exactly 0")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"K2 {name}: two runs on the same inputs gave different bits")
            plain32 = read_kernel.read_plain(qn, mkn, mv, valid, tau=tau)
            ratios = [worst_ratio(g, r, 1e-4, 1e-6) for g, r in zip(got + plain32, ref + ref)]
            max_err = max(max_err, *errs)
            print(f"K2 {name}: max abs err vs float64 mem_out {errs[0]:.3e} "
                  f"exp_aff {errs[1]:.3e}; worst err/limit (mem_out, exp_aff) kernel "
                  f"{ratios[0]:.3f} {ratios[1]:.3f}, float32 plain {ratios[2]:.3f} "
                  f"{ratios[3]:.3f}; rerun bit-identical", flush=True)
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
    flops = 2.0 * P * Ck * (2 * N * Lm) + 2.0 * P * (2 * Lm) * Cv * N
    nbytes = 4.0 * (qk.numel() + mk.numel() + mv.numel() + B * N * P * Cv + B * N * 2 * Lm * P) \
        + valid.numel()
    # the kernel runs its products as 3xTF32: three TF32 products each, on the
    # tensor cores; the FP32 CUDA-core bound is printed beside it
    b_ms, b_by = bound_ms(3 * flops, nbytes, (peaks[2], peaks[1]))
    fp32_ms, fp32_by = bound_ms(flops, nbytes, peaks)
    print(f"K2 time: kernel {ms:.4f} ms, wrapper (normalization + kernel) {wrapper:.4f} ms, "
          f"plain {plain:.4f} ms, sdpa {library:.4f} ms; bound {b_ms:.4f} ms ({b_by}, 3xTF32 "
          f"on the tensor cores), FP32 bound {fp32_ms:.4f} ms ({fp32_by}, CUDA cores)", flush=True)
    return {"name": "read_memory", "route": "cuda", "source": "swem_tpu_torch/csrc/read_memory.cu",
            "replaces": "swem_tpu/ops/read_pallas.py:57 (_read_kernel, pallas_call at :161)",
            "launches": None, "max_abs_err": max_err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library, "wrapper_ms": wrapper}


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


def counted(fn, expect: int, label: str):
    """Run ``fn`` with every launch count set to 0 just before it and read
    just after; fail unless each kernel launched ``expect`` times.
    Returns (fn's result, the counts)."""
    import torch
    from swem_tpu_torch.ops import em_kernel, read_kernel

    em_kernel.launches = read_kernel.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {"em_loop": em_kernel.launches, "read_memory": read_kernel.launches}
    for name, n in launches.items():
        if n != expect:
            fail(f"{label}: kernel {name} launched {n} times, expected {expect}")
    return out, launches


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
    """Phase 7: the streaming session at bfloat16; returns the launch counts
    summed over its pushes."""
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
    totals = {"em_loop": 0, "read_memory": 0}
    for f in frames[1:N_PUSH + 1]:
        t0 = time.perf_counter()
        got, launches = counted(lambda: sess.push(f), 1, "session push")
        wall.append((time.perf_counter() - t0) * 1e3)
        for k in totals:
            totals[k] += launches[k]
        mem, ref, _ = engine.step(model, mem, pre(f), active, OUT_SIZE)
        shares.append(float((got == ref[0].cpu().numpy()).mean()))
    peak2 = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"session (bfloat16): {N_PUSH} pushes, index pixels identical to init_memory + step "
          f"per frame {' '.join(f'{s:.6f}' for s in shares)}; launches {totals}", flush=True)
    if min(shares) < 0.99:
        fail(f"session: only {min(shares):.4f} of a frame's pixels agree with step")
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


def profile_main_path(model, frames, init_mask, active, label: str) -> None:
    """Where the main path's time goes: one more ``run_video`` under
    ``torch.profiler``, device time summed by kernel group, and the share of
    the run's wall time in which no kernel ran on the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from swem_tpu_torch import engine
    from swem_tpu_torch.utils.profiling import device_busy_seconds

    # cuBLAS's GEMMs are named *xmma_gemm* too: only these keys mark a convolution
    groups = (("em_loop kernel", ("em_loop_kernel",)),
              ("read_memory kernel", ("read_kernel",)),
              ("convolution", ("fprop", "dgrad", "wgrad", "implicit", "conv", "cudnn")),
              ("matmul", ("gemm", "gemv")))
    port_groups = ("em_loop kernel", "read_memory kernel")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_video(model, torch.Generator().manual_seed(1), frames, init_mask, active,
                         OUT_SIZE)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
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
    print(f"profile ({label}): run_video T={T_VIDEO} wall {wall_us / 1e3:.3f} ms, "
          f"{len(kernels)} kernels, device busy {busy / 1e3:.3f} ms, idle share "
          f"{1 - busy / wall_us:.4f}", flush=True)
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {g}: {us / 1e3:.3f} ms ({us / total:.4f} of device time)", flush=True)
        # every kernel of the port's own groups; the three largest of the others
        names = sorted(((n, v) for n, v in by_name.items() if v[0] == g), key=lambda kv: -kv[1][1])
        for n, (_, us_n, count) in names if g in port_groups else names[:3]:
            print(f"    {us_n / 1e3:.3f} ms, {count} launches: {n}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "swem_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
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
    launches, launches_f32, bf16 = main_path(card)
    launches_runner = runner_path(bf16, card)
    launches_session = session_path(bf16, card)
    for e in entries:
        e["launches"] = launches[e["name"]]
        e["launches_f32"] = launches_f32[e["name"]]
        e["launches_runner"] = launches_runner[e["name"]]
        e["launches_session"] = launches_session[e["name"]]
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
