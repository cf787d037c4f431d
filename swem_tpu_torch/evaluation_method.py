"""Offline J&F scoring of a results directory (the port's counterpart of the
root ``evaluation_method.py``, with its flags, files and output):

    python -m swem_tpu_torch.evaluation_method --davis_path /data/DAVIS --year 2017 \\
        --set val --task semi-supervised --results_path outputs/DAVIS17/output

Writes ``global_results-DAVIS<yy>.csv`` and ``per-sequence_results-DAVIS<yy>.csv``
(and with ``--per_object_csv`` the per-object per-frame series) into
``--results_path``. Host only: numpy, Pillow, OpenCV and SciPy; it touches
no device.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m swem_tpu_torch.evaluation_method")
    p.add_argument("--davis_path", required=True)
    p.add_argument("--year", default="2017", choices=["2016", "2017", "2019"])
    p.add_argument("--set", default="val", choices=["train", "val", "test-dev"])
    p.add_argument("--task", default="semi-supervised",
                   choices=["semi-supervised", "unsupervised"])
    p.add_argument("--results_path", required=True)
    p.add_argument("--per_object_csv", action="store_true",
                   help="also write the per-object per-frame J/F series to "
                   "per-object_results-<set>.csv")
    args = p.parse_args(argv)

    from swem_tpu_torch.eval.benchmark import DavisEvaluation, write_reports

    t0 = time.time()
    ev = DavisEvaluation(args.davis_path, year=args.year, gt_set=args.set, task=args.task)
    metrics = ev.evaluate(args.results_path)
    write_reports(metrics, args.results_path, f"DAVIS{args.year[-2:]}",
                  per_object_csv=args.per_object_csv)
    sys.stdout.write(f"\nTotal time: {time.time() - t0:.1f}s\n")


if __name__ == "__main__":
    main()
