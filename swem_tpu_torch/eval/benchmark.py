"""Offline DAVIS J&F evaluation and its reports (the port's copy of the
semi-supervised part of ``swem_tpu/eval/benchmark.py``). Numpy and Pillow,
imported where a PNG is read."""

from __future__ import annotations

import csv
import os
from glob import glob
from typing import Dict, List, Sequence, Tuple

import numpy as np

from swem_tpu_torch.data.palette import load_label_mask
from swem_tpu_torch.eval.metrics import boundary_f_frames, jaccard, statistics

VOID_LABEL = 255


class DavisGT:
    """DAVIS ground truth of one ImageSets split."""

    def __init__(self, root: str, year: str = "2017", subset: str = "val"):
        self.year = str(year)
        self.mask_path = os.path.join(root, "Annotations", "480p")
        with open(os.path.join(root, "ImageSets", self.year, f"{subset}.txt")) as f:
            self.sequences = [ln.strip() for ln in f if ln.strip()]

    def get_all_masks(self, seq: str) -> Tuple[np.ndarray, np.ndarray, List[str]]:
        """(per-object masks (N, T, H, W) bool, void (T, H, W), frame ids).

        255 is void; DAVIS-2016 collapses all ids to 1. The objects are the
        ids of frame 0.
        """
        paths = sorted(glob(os.path.join(self.mask_path, seq, "*.png")))
        masks = np.stack([load_label_mask(p) for p in paths])
        ids = [os.path.splitext(os.path.basename(p))[0] for p in paths]
        void = masks == VOID_LABEL
        masks = np.where(void, 0, masks)
        if self.year == "2016":
            masks = (masks > 0).astype(np.uint8)
        obj_ids = np.arange(1, int(masks[0].max()) + 1)
        return masks[None] == obj_ids[:, None, None, None], void, ids


def read_result_masks(res_path: str, seq: str, mask_ids: Sequence[str], n_objects: int,
                      shape=None) -> np.ndarray:
    """Predicted PNGs -> per-object bool masks (n_objects, T, H, W).

    A missing prediction reads as all background; ``shape`` is the frame
    shape when no prediction of the sequence exists at all.
    """
    paths = [os.path.join(res_path, seq, f"{m}.png") for m in mask_ids]
    first = next((p for p in paths if os.path.exists(p)), None)
    if first is not None:
        shape = load_label_mask(first).shape
    elif shape is None:
        raise FileNotFoundError(f"no predictions for sequence {seq} in {res_path}")
    out = np.zeros((n_objects, len(mask_ids)) + tuple(shape), bool)
    for t, p in enumerate(paths):
        if not os.path.exists(p):
            continue
        m = load_label_mask(p)
        for n in range(n_objects):
            out[n, t] = m == (n + 1)
    return out


class DavisEvaluation:
    """Semi-supervised DAVIS evaluation: the first and last frames are
    excluded; each object's J and F series reduce to (mean, recall, decay)."""

    def __init__(self, davis_root: str, year: str = "2017", gt_set: str = "val"):
        self.dataset = DavisGT(davis_root, year=year, subset=gt_set)

    def evaluate(self, res_path: str, metric=("J", "F")) -> Dict:
        res: Dict[str, Dict] = {
            m: {"M": [], "R": [], "D": [], "M_per_object": {}, "per_obj_frame": {}}
            for m in metric
        }
        series = {"J": jaccard, "F": boundary_f_frames}
        for seq in self.dataset.sequences:
            gt, _, ids = self.dataset.get_all_masks(seq)
            gt, ids = gt[:, 1:-1], ids[1:-1]
            pred = read_result_masks(res_path, seq, ids, gt.shape[0], shape=gt.shape[2:])
            for n in range(gt.shape[0]):
                seq_name = f"{seq}_{n + 1}"
                for m in metric:
                    values = series[m](gt[n], pred[n])
                    M, R, D = statistics(values)
                    res[m]["M"].append(M)
                    res[m]["R"].append(R)
                    res[m]["D"].append(D)
                    res[m]["M_per_object"][seq_name] = M
                    res[m]["per_obj_frame"][seq_name] = values
        return res


def write_reports(metrics_res: Dict, save_dir: str, eval_set: str, logger=None,
                  per_object_csv: bool = False) -> Dict[str, float]:
    """Global and per-sequence CSVs, the per-object per-frame log rows (and,
    with ``per_object_csv``, ``per-object_results-<set>.csv``), and the
    global table on stdout. Returns the global numbers."""
    J, F = metrics_res["J"], metrics_res["F"]
    final_mean = (np.mean(J["M"]) + np.mean(F["M"])) / 2.0
    g_names = ["J&F-Mean", "J-Mean", "J-Recall", "J-Decay", "F-Mean", "F-Recall", "F-Decay"]
    g_vals = [final_mean, np.mean(J["M"]), np.mean(J["R"]), np.mean(J["D"]),
              np.mean(F["M"]), np.mean(F["R"]), np.mean(F["D"])]

    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, f"global_results-{eval_set}.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(g_names)
        w.writerow([f"{v:.3f}" for v in g_vals])

    with open(os.path.join(save_dir, f"per-sequence_results-{eval_set}.csv"), "w",
              newline="") as f:
        w = csv.writer(f)
        w.writerow(["Sequence", "J-Mean", "F-Mean"])
        for name in J["M_per_object"]:
            w.writerow([name, f"{J['M_per_object'][name]:.3f}", f"{F['M_per_object'][name]:.3f}"])

    if logger is not None:
        for name in J["per_obj_frame"]:
            logger.info(f"Per obj per frame J, {name}:"
                        f"{np.asarray(J['per_obj_frame'][name]).tolist()}")
            logger.info(f"Per obj per frame F, {name}:"
                        f"{np.asarray(F['per_obj_frame'][name]).tolist()}")
    if per_object_csv:
        with open(os.path.join(save_dir, f"per-object_results-{eval_set}.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(["Object", "Metric", "Frames..."])
            for name in J["per_obj_frame"]:
                w.writerow([name, "J"] + [f"{v:.5f}" for v in np.asarray(J["per_obj_frame"][name])])
                w.writerow([name, "F"] + [f"{v:.5f}" for v in np.asarray(F["per_obj_frame"][name])])

    table = " ".join(f"{n}: {v:.3f}" for n, v in zip(g_names, g_vals))
    msg = f"--- Global results for {eval_set} ---\n{table}"
    print(msg)
    if logger is not None:
        logger.info(msg)
    return dict(zip(g_names, [float(v) for v in g_vals]))
