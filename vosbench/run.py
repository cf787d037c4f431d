"""The benchmark of ``swem_tpu_torch`` on one NVIDIA H100: one cell, one run.

    python3 vosbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell's set-up (import, weights made on
the card from the seed, the program built and warmed for the cell's own
shapes, the kernels built on a checkout's first run) is ``setup_s``; then
the window measures for ``--seconds``; then the outputs are judged against
the plain reference in ``vosbench/reference``. With ``--trace 1`` a
bounded part of the window runs under ``torch.profiler`` and the line
carries the per-layer metrics instead of the end-to-end ones.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number judged beside its
limit), which the last lines of standard error repeat. Without a CUDA
device, or with JAX, Flax or the JAX package loaded once the window has
closed, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# build and kernel caches at fixed places inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "vosbench" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "vosbench" / "triton"))
os.environ.setdefault("USE_FLAX", "0")


def parse(argv=None):
    ap = argparse.ArgumentParser(description="one run of one cell of the benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of ``cell`` on ``device``: set-up, window, judgement -> the
    result object. ``t_start`` is when the run began (``setup_s`` counts
    from it)."""
    import torch

    from vosbench import harness
    from vosbench.trace import Tracer

    run = harness.Run(cell, seed % 2 ** 62, seconds, trace, device)
    drv = harness.driver(cell)
    cuda = device.type == "cuda"
    state = drv.setup(run)
    harness.sync(device)
    setup_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    tracer = Tracer(trace, device)
    win = drv.window(run, state, tracer)
    tracer.stop()
    found = harness.forbidden_modules()
    if found:
        raise SystemExit(f"vosbench: {', '.join(found)} loaded in the measuring process")
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    summary = tracer.summary(drv.OPS) if trace else None
    if trace:
        if summary is None:
            raise RuntimeError("the traced part of the window never ran")
        summary.update(win["summary"], peak_bytes=window_peak)
    numbers = drv.check(run, state, win)
    compared = harness.judge(numbers, cell.limits)
    if trace:
        metrics = harness.per_layer(cell, summary)
    else:
        wanted = {m["name"]: m["unit"] for m in cell.end_to_end}
        values = dict(win["e2e"], setup_s=setup_s)
        metrics = {k: {"value": float(values[k] if k in values else values[k.split(".")[0]]),
                       "unit": u} for k, u in wanted.items()}
    result = {
        "correct": harness.is_correct(compared),
        "attempted": win["attempted"],
        "failed": win["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": max(peak, window_peak)},
    }
    if trace:
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = summary["breakdown"]
    result["compared"] = compared
    return result


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from vosbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"vosbench: {args.workload} needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda:0"),
                      T_START)
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
