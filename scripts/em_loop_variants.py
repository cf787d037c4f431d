#!/usr/bin/env python3
"""Compare builds of the EM loop kernel on one GPU, in turns.

    python3 scripts/em_loop_variants.py [--cycles] A.cu [B.cu ...]

Each source has the C interface of ``swem_tpu_torch/csrc/em_loop.cu`` (the
kernel as it stands, or an exploratory copy of it). Each is built with
``nvcc`` and the port's flags (``ops/build.py``), all at once, into
``build/em_loop_variants/``, and run through ``em_kernel.em_loop`` at three
shapes, 4 rounds: flagship (B=1, N=2, P=1620, Ck=128, L=128), L=256, and N=8
at P=3600. For each build it prints the worst error over the 4-round limit
against the plain loop in float64, whether its bits equal the first
build's, and its device time (``chip_smoke.cuda_ms``), the builds timed in
turns A B .. B A. With ``--cycles`` the builds define ``SWEM_EM_CYCLES``, and
a build that has the kernel's checkpoints also prints CTA 0's cycles in each
part of one launch (its times then include the checkpoints' barriers).
Needs a CUDA device and the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SHAPES = (("flagship", (1, 2, 1620, 128, 128)), ("L=256", (1, 2, 1620, 128, 256)),
          ("N=8 P=3600", (1, 8, 3600, 128, 128)))
SLOTS = ("prep", "x staging", "affinity", "W and E", "tile partials", "partial loads", "zita",
         "kappa and norms", "column writes", "tile barrier", "column barrier")


def build_all(sources, cycles: bool) -> dict:
    """{name: ctypes library}, built in parallel; exits if a build fails."""
    from swem_tpu_torch.ops import build

    out = ROOT / "build" / "em_loop_variants"
    out.mkdir(parents=True, exist_ok=True)
    flags = [*build.NVCC_FLAGS, f"-I{build.CSRC}"] + (["-DSWEM_EM_CYCLES"] if cycles else [])
    nvcc = build.nvcc_path()
    procs = {}
    for i, src in enumerate(sources):
        name = f"{i}:{Path(src).stem}"
        lib = out / f"lib{i}_{Path(src).stem}.so"
        procs[name] = (subprocess.Popen([nvcc, *flags, "-o", str(lib), str(src)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "error")):
                print(f"{name}: {line.strip()}", flush=True)
        if proc.returncode:
            raise SystemExit(f"{name}: build failed")
        lib = ctypes.CDLL(str(path))
        lib.swem_em_loop.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_void_p]
        lib.swem_em_loop.restype = ctypes.c_int
        lib.swem_em_loop_error.argtypes = [ctypes.c_int]
        lib.swem_em_loop_error.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sources", nargs="+")
    parser.add_argument("--cycles", action="store_true")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("em_loop_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from swem_tpu_torch.ops import em_kernel

    # the only plain loop here is the float64 referee: no TF32 flag applies
    print(f"card: {chip_smoke.card_line()}", flush=True)
    libs = build_all(args.sources, args.cycles)
    names = list(libs)

    def use(name):
        em_kernel._lib = lambda: libs[name]

    tau, n_iters = 0.05, 4
    rng = np.random.default_rng(0)
    for shape_name, shape in SHAPES:
        inputs = chip_smoke.em_inputs(rng, *shape, 0.3)
        ref = em_kernel.em_loop_plain(*(t.double() for t in inputs), n_iters=n_iters, tau=tau)
        first = None
        for name in names:
            use(name)
            got = em_kernel.em_loop(*inputs, n_iters=n_iters, tau=tau)
            torch.cuda.synchronize()
            first = first or got
            ratios = [chip_smoke.worst_ratio(g, r, 5e-2, 1e-2) for g, r in zip(got, ref)]
            same = all(torch.equal(a, b) for a, b in zip(got, first))
            print(f"{shape_name} {name}: worst err/limit (z, kappa, zita) "
                  f"{' '.join(f'{r:.4f}' for r in ratios)}; bits as {names[0]}: {same}",
                  flush=True)
        times = {name: [] for name in names}
        for name in names + names[::-1]:
            use(name)
            times[name].append(chip_smoke.cuda_ms(
                lambda: em_kernel.em_loop(*inputs, n_iters=n_iters, tau=tau)))
        for name in names:
            print(f"{shape_name} {name}: {' '.join(f'{t:.4f}' for t in times[name])} ms",
                  flush=True)
            if not hasattr(libs[name], "swem_em_loop_cycles"):
                continue
            use(name)
            em_kernel.em_loop(*inputs, n_iters=n_iters, tau=tau)
            torch.cuda.synchronize()
            cycles = (ctypes.c_longlong * len(SLOTS))()
            libs[name].swem_em_loop_cycles(cycles)
            print(f"{shape_name} {name} cycles of CTA 0, one launch: " + ", ".join(
                f"{slot} {c}" for slot, c in zip(SLOTS, cycles)) + f"; total {sum(cycles)}",
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
