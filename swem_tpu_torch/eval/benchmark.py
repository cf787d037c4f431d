"""Offline DAVIS J&F evaluation and its reports (the port's copy of
``swem_tpu/eval/benchmark.py``): the semi-supervised task (first and last
frames excluded) and the unsupervised one (each ground-truth object matched
to one of up to 20 proposals by the Hungarian method). Numpy, Pillow where
a PNG is read and SciPy where proposals are matched."""

from __future__ import annotations

import csv
import os
from glob import glob
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from swem_tpu_torch.data.palette import load_label_mask
from swem_tpu_torch.eval.metrics import boundary_f_frames, jaccard, statistics

VOID_LABEL = 255


class DavisGT:
    """DAVIS ground truth of one ImageSets split (or the listed ``sequences``);
    the unsupervised task reads ``Annotations_unsupervised``."""

    def __init__(self, root: str, year: str = "2017", subset: str = "val",
                 resolution: str = "480p", sequences="all", task: str = "semi-supervised"):
        self.year = str(year)
        ann = "Annotations" if task == "semi-supervised" else "Annotations_unsupervised"
        self.mask_path = os.path.join(root, ann, resolution)
        if sequences == "all":
            with open(os.path.join(root, "ImageSets", self.year, f"{subset}.txt")) as f:
                self.sequences = [ln.strip() for ln in f if ln.strip()]
        else:
            self.sequences = list(sequences)

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


def read_proposal_masks(res_path: str, seq: str, mask_ids: Sequence[str]) -> np.ndarray:
    """Predicted PNGs as proposals (unsupervised task): one bool channel per
    id from 1 to the largest id in any frame, (N, T, H, W); a missing frame
    reads as all background."""
    frames = []
    for mid in mask_ids:
        p = os.path.join(res_path, seq, f"{mid}.png")
        frames.append(load_label_mask(p) if os.path.exists(p) else None)
    present = [m for m in frames if m is not None]
    if not present:
        raise FileNotFoundError(f"no proposal PNGs for sequence {seq} in {res_path}")
    max_id = max(int(m.max()) for m in present)
    out = np.zeros((max_id, len(mask_ids)) + present[0].shape, bool)
    for t, m in enumerate(frames):
        if m is None:
            continue
        for n in range(max_id):
            out[n, t] = m == (n + 1)
    return out


def evaluate_unsupervised(gt: np.ndarray, proposals: np.ndarray,
                          void: Optional[np.ndarray] = None, metric=("J", "F"),
                          max_n_proposals: int = 20) -> Tuple[np.ndarray, np.ndarray]:
    """Each ground-truth object's (J, F) series, (Ngt, T) each, after the
    optimal assignment of proposals to objects.

    gt (Ngt, T, H, W) and proposals (Np, T, H, W) are bool. Fewer proposals
    than objects are padded with empty ones; more than ``max_n_proposals``
    raise ``ValueError``. The assignment maximises the mean of J's and F's
    per-pair means (``scipy.optimize.linear_sum_assignment``, which breaks
    ties by index).
    """
    from scipy.optimize import linear_sum_assignment

    if proposals.shape[0] > max_n_proposals:
        raise ValueError(f"{proposals.shape[0]} proposals exceed the maximum {max_n_proposals}")
    if proposals.shape[0] < gt.shape[0]:
        pad = np.zeros((gt.shape[0] - proposals.shape[0],) + proposals.shape[1:], bool)
        proposals = np.concatenate([proposals, pad], axis=0)
    n_p, n_g, T = proposals.shape[0], gt.shape[0], gt.shape[1]
    j = np.zeros((n_p, n_g, T))
    f = np.zeros((n_p, n_g, T))
    for g in range(n_g):
        for p in range(n_p):
            if "J" in metric:
                j[p, g] = jaccard(gt[g], proposals[p], void)
            if "F" in metric:
                f[p, g] = boundary_f_frames(gt[g], proposals[p], void)
    if "J" in metric and "F" in metric:
        score = (j.mean(-1) + f.mean(-1)) / 2.0
    else:
        score = j.mean(-1) if "J" in metric else f.mean(-1)
    rows, cols = linear_sum_assignment(-score)
    return j[rows, cols], f[rows, cols]


class DavisEvaluation:
    """DAVIS evaluation, semi-supervised (the first and last frames
    excluded) or unsupervised (Hungarian-matched proposals, every frame,
    void pixels left out); each object's J and F series reduce to (mean,
    recall, decay)."""

    def __init__(self, davis_root: str, year: str = "2017", gt_set: str = "val",
                 task: str = "semi-supervised"):
        self.task = task
        self.dataset = DavisGT(davis_root, year=year, subset=gt_set, task=task)

    def evaluate(self, res_path: str, metric=("J", "F")) -> Dict:
        res: Dict[str, Dict] = {
            m: {"M": [], "R": [], "D": [], "M_per_object": {}, "per_obj_frame": {}}
            for m in metric
        }
        series = {"J": jaccard, "F": boundary_f_frames}
        for seq in self.dataset.sequences:
            gt, void, ids = self.dataset.get_all_masks(seq)
            if self.task == "semi-supervised":
                gt, ids = gt[:, 1:-1], ids[1:-1]
                pred = read_result_masks(res_path, seq, ids, gt.shape[0], shape=gt.shape[2:])
                matched = None
            else:
                proposals = read_proposal_masks(res_path, seq, ids)
                matched = dict(zip(("J", "F"), evaluate_unsupervised(gt, proposals, void,
                                                                     metric)))
            for n in range(gt.shape[0]):
                seq_name = f"{seq}_{n + 1}"
                for m in metric:
                    values = series[m](gt[n], pred[n]) if matched is None else matched[m][n]
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
