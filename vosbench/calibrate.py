"""The readings that a cell's correctness limits are set from, on the chip
at the cell's own size, in one process.

    python3 vosbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--controls fp8|tf32,...] [--control-seeds 1,2,3] [--seconds 8]

``--controls`` defaults to the configuration's ``control`` (the precision
below the one it states).

For every seed: the program's run (set-up, a short window at the cell's own
load, the check) and its numbers. For every control seed and control: the
same set-up and window, then the control put in the program's place on the
same sampled work (``check(control=...)``) and its numbers. One JSON line
per reading on standard output (with a video cell's per-frame shares,
``frames``, and ``correct``: the harness's verdict on the numbers under the
cell's limits), and the largest program reading and the smallest control
reading of each number at the end. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell_name: str, seeds, controls, control_seeds, seconds: float, device):
    from vosbench import harness
    from vosbench.trace import Tracer

    cell = harness.load_cell(cell_name)
    drv = harness.driver(cell)
    jobs = [(s, None) for s in seeds] + [(s, c) for c in controls for s in control_seeds]
    for seed, control in jobs:
        t0 = time.perf_counter()
        run = harness.Run(cell, seed, seconds, False, device)
        state = drv.setup(run)
        win = drv.window(run, state, Tracer(False, device))
        numbers = drv.check(run, state, win, control=control)
        yield {"cell": cell_name, "seed": seed, "side": control or "program",
               "numbers": numbers,
               "correct": harness.is_correct(harness.judge(numbers, cell.limits)),
               "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default=None)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    hi, lo = {}, {}
    if args.controls is None:
        from vosbench import harness

        args.controls = harness.load_cell(args.workload).mcfg["control"]
    for r in readings(args.workload, ints(args.seeds), [c for c in args.controls.split(",") if c],
                      ints(args.control_seeds), args.seconds, torch.device("cuda:0")):
        print(json.dumps(r), flush=True)
        for k, v in r["numbers"].items():
            if not isinstance(v, float):
                continue
            if r["side"] == "program":
                hi[k] = max(hi.get(k, v), v)
            else:
                lo.setdefault(r["side"], {})[k] = min(lo.get(r["side"], {}).get(k, v), v)
    print(json.dumps({"cell": args.workload, "program_max": hi, "control_min": lo}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
