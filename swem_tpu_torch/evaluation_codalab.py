"""CodaLab scoring program (the port's counterpart of the root
``evaluation_codalab.py``, with its arguments, files and exits):

    python -m swem_tpu_torch.evaluation_codalab <input_dir> <output_dir> [--set test-dev]

Reads ``input_dir/res`` (the submission's PNGs) and ``input_dir/ref`` (the
DAVIS ground truth) and writes ``output_dir/scores.txt`` with the
benchmark's ``key: value`` lines. Exits with a message when the submission,
the ground truth or any sequence of the split is missing. Host only: it
touches no device.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m swem_tpu_torch.evaluation_codalab")
    p.add_argument("input_dir")
    p.add_argument("output_dir")
    p.add_argument("--set", default="test-dev")
    p.add_argument("--year", default="2017")
    p.add_argument("--task", default="semi-supervised")
    args = p.parse_args(argv)

    t0 = time.time()
    submission = os.path.join(args.input_dir, "res")
    gt_root = os.path.join(args.input_dir, "ref")
    if not os.path.exists(submission):
        sys.exit(f"Could not find submission file {submission}")
    if not os.path.exists(gt_root):
        sys.exit(f"Could not find GT file {gt_root}")

    from swem_tpu_torch.eval.benchmark import DavisEvaluation

    ev = DavisEvaluation(gt_root, year=args.year, gt_set=args.set, task=args.task)
    missing = [s for s in ev.dataset.sequences if not os.path.isdir(os.path.join(submission, s))]
    if missing:
        sys.exit(f"Submission is missing sequences: {missing[:5]} ...")

    metrics = ev.evaluate(submission)
    J, F = metrics["J"], metrics["F"]
    final_mean = (np.mean(J["M"]) + np.mean(F["M"])) / 2.0
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "scores.txt"), "w") as f:
        f.write(f"GlobalMean: {final_mean:f}\n")
        f.write(f"JMean: {np.mean(J['M']):f}\n")
        f.write(f"JRecall: {np.mean(J['R']):f}\n")
        f.write(f"JDecay: {np.mean(J['D']):f}\n")
        f.write(f"FMean: {np.mean(F['M']):f}\n")
        f.write(f"FRecall: {np.mean(F['R']):f}\n")
        f.write(f"FDecay: {np.mean(F['D']):f}\n")
    sys.stdout.write(f"\nTotal time: {time.time() - t0:.1f}s\n")


if __name__ == "__main__":
    main()
