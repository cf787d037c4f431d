"""DAVIS and YouTube-VOS evaluation: inference, palette PNGs, J&F.

Counterpart of ``swem_tpu/eval/evaluator.py`` on the port's
``ChunkedVideoRunner``:

* DAVIS: uint8 frames resized on the device to ``davis_in_size`` (bicubic),
  whole videos through the chunked runner, predictions saved as palette PNGs
  at the annotation size; multi-scale and flip average the runners' soft
  scores on the device before the argmax.
* YouTube-VOS: uint8 frames at their native size, resized on the device to
  each video's /16-divisible inference size; objects that appear mid-video
  are injected at their first frame; slots are mapped back to the
  annotation ids when the PNGs are saved.
* ``video_batch > 1``: videos of one shape signature and slot bucket run
  together, sorted by length and padded with their last frame. One spine
  serves both datasets.

Every video's initial EM bases come from ``initial_bases``: a fresh
``torch.Generator`` seeded with ``cfg.data.seed``, as the JAX evaluator
hands every video ``PRNGKey(seed)``. One model serves every slot bucket:
the weights do not depend on the slot count.

Frames/s is ``FrameSecondMeter``'s: each span covers one video's (or
batch's) inference, its uploads included, and ends with the predictions
on the host; runners are built and warmed up outside it, and PNG I/O lies
outside it.

Distributed evaluation (``parallel.init_distributed``): each process
evaluates a round-robin slice of the videos (sequentially) or of the batch
plan (``video_batch > 1``) into the shared results tree, all wait at a
barrier, and process 0 alone scores the PNGs.

Devices inside a process (``parallel.eval_devices``: every visible card, or
the rank's alone under a process group): ``obj_parallel > 1`` shards each
video's slots over that many of them (``_obj_mesh``: clamped to a power of
two dividing the slot bucket and the device count, with a log line), and
``video_batch > 1`` shards each batch's videos over the devices left
(``parallel.derive_eval_mesh_extents``), as the JAX evaluator does.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from swem_tpu_torch import parallel
from swem_tpu_torch.config import SWEMConfig
from swem_tpu_torch.data.davis_test import DavisTestSet
from swem_tpu_torch.data.palette import davis_palette, save_seg_mask, ytvos_palette
from swem_tpu_torch.data.ytvos_test import YTVOSTestSet
from swem_tpu_torch.engine import ChunkedVideoRunner
from swem_tpu_torch.models import em
from swem_tpu_torch.models.swem import SWEM
from swem_tpu_torch.ops.resize import resize
from swem_tpu_torch.registry import register_evaluator
from swem_tpu_torch.utils import FrameSecondMeter, mkdir, setup_logger
from swem_tpu_torch.utils.host_io import AsyncWriter, prefetch

def _preprocess(size: Tuple[int, int]):
    """uint8 frames -> float32 in [0, 1], bicubic to ``size`` where they differ
    from it (a bicubic resize to the same size is the identity, bit for bit)."""
    size = tuple(size)

    def pre(f):
        f = f.float() / 255.0
        return f if tuple(f.shape[-3:-1]) == size else resize(f, size, "bicubic")

    return pre


def _stack_padded(videos) -> np.ndarray:
    """Host frames (T_max, B, H, W, 3): each video padded to the longest by
    repeating its last frame (the extra predictions are dropped)."""
    if len(videos) == 1:
        return videos[0].frames[:, None]
    t_max = max(v.frames.shape[0] for v in videos)
    return np.stack([np.concatenate([v.frames, np.repeat(v.frames[-1:],
                                                         t_max - v.frames.shape[0], 0)])
                     for v in videos], axis=1)


@register_evaluator("SWEM")
class Evaluator:
    """Evaluates ``cfg.eval.eval_set`` with the weights ``state_dict`` (the
    port's, e.g. from ``registry.load_state_dict``) on ``device`` (None:
    CUDA)."""

    def __init__(self, cfg: SWEMConfig, state_dict, logger=None, device=None):
        self.cfg = cfg
        self.eval_set = cfg.eval.eval_set
        self.model = SWEM(cfg.model, device)  # one model for every slot bucket
        self.model.load_state_dict(state_dict)
        self.n_slots = cfg.eval.max_objs
        self.save_dir = os.path.join(cfg.log_dir, cfg.model.model_name, cfg.solver.stage_name,
                                     cfg.exp_name, "results", self.eval_set)
        self.out_root = os.path.join(self.save_dir, "output")
        mkdir(self.out_root)
        # this process's share of the videos: a round-robin slice
        self._pid, self._nproc = parallel.process_index(), parallel.process_count()
        log_name = "test_stage" if self._nproc == 1 else f"test_stage_p{self._pid}"
        self.logger = logger or setup_logger("swem_eval", self.save_dir, log_name)
        self._runners: Dict[tuple, ChunkedVideoRunner] = {}
        self.fps: Optional[float] = None

        root = cfg.eval.data_root
        self.ytvos = self.eval_set in ("YTVOS18", "YTVOS19")
        if self.eval_set == "DAVIS16":
            self.dataset = DavisTestSet(root, "2016/val.txt", single_obj=True,
                                        n_slots=self.n_slots)
        elif self.eval_set == "DAVIS17":
            self.dataset = DavisTestSet(root, "2017/val.txt", n_slots=self.n_slots)
        elif self.eval_set == "DAVIS17Test":
            self.dataset = DavisTestSet(root, "2017/test-dev.txt", n_slots=self.n_slots)
        elif self.ytvos:
            # YouTube-VOS videos carry up to ~12 objects; the slot buckets
            # keep the larger budget cheap for videos with few
            self.n_slots = max(self.n_slots, 12)
            self.dataset = YTVOSTestSet(root, short_size=cfg.eval.ssize, n_slots=self.n_slots)
        else:
            raise ValueError(f"{self.eval_set} is unsupported")
        self.palette = ytvos_palette() if self.ytvos else davis_palette()
        self.multi_scale = tuple(cfg.eval.scales) != (480,) or cfg.eval.flip
        if self.multi_scale and self.ytvos:
            self.logger.warning("--scales/--flip apply to DAVIS only; YouTube-VOS runs at "
                                "its single inference size")
        if self.multi_scale and cfg.eval.video_batch > 1 and not self.ytvos:
            raise ValueError("video_batch > 1 does not support multi-scale/flip evaluation; "
                             "drop --video_batch or --scales/--flip")

    # ------------------------------------------------------------------ #
    def initial_bases(self, n_slots: int) -> em.Bases:
        """The initial EM bases of every video: one draw of ``n_slots`` slots
        from a generator seeded with ``cfg.data.seed``."""
        c = self.model.cfg
        return em.init_bases(torch.Generator().manual_seed(self.cfg.data.seed), 1, n_slots,
                             c.keydim, c.valdim, c.num_bases)

    def _slot_bucket(self, n_objs: int) -> int:
        """Smallest power-of-two slot budget (from 2) covering the video's
        objects, at most ``n_slots``: a video pays for the object towers of
        its bucket, not of the whole budget."""
        b = 2
        while b < n_objs:
            b *= 2
        return min(b, self.n_slots)

    def _obj_mesh(self, n_slots: int, n_data: int = 1):
        """('data', 'obj') mesh for object-parallel evaluation, or None when off.

        Shards each video's slots over ``obj_parallel`` devices of this
        process (``parallel.eval_devices``), clamped to a power of two that
        divides the slot bucket, with at most the devices there are for each
        of the ``n_data`` rows (``_runner`` logs the outcome)."""
        k = self.cfg.eval.obj_parallel
        if k <= 1:
            return None
        devs = parallel.eval_devices(self.model.device)
        n_obj = parallel.clamp_pow2(min(k, n_slots, max(1, len(devs) // n_data)), n_slots)
        if n_obj <= 1:
            return None
        return parallel.make_mesh2(n_data=n_data, n_obj=n_obj, devices=devs)

    def _batch_mesh(self, vb: int):
        """Batched evaluation's plan: (n_data, None, a 'data' mesh, or
        "obj2d": the bucket-clamped ``_obj_mesh`` of each group), logged."""
        devs = parallel.eval_devices(self.model.device)
        n_data, n_obj = parallel.derive_eval_mesh_extents(len(devs), self.cfg.eval.obj_parallel,
                                                          vb)
        if n_data * n_obj == 1:
            return n_data, None
        self.logger.info(f"sharding video batches over {n_data} devices"
                         + ("" if n_obj == 1 else f" x {n_obj} object shards"))
        return n_data, "obj2d" if n_obj > 1 else parallel.make_mesh(n_data, devices=devs)

    def _runner(self, raw_hw, in_size, out_size, bucket: int, batch: int = 1,
                scores: bool = False, mesh=None) -> ChunkedVideoRunner:
        """The chunked runner of one shape signature and mesh (default:
        ``_obj_mesh(bucket)``), built and warmed up on first use (outside the
        frames/s span) and cached."""
        if mesh is None:
            mesh = self._obj_mesh(bucket)
        mesh_key = None if mesh is None else (mesh.axis_names, mesh.devices.shape,
                                              tuple(map(str, mesh.devices.ravel())))
        key = (tuple(raw_hw), tuple(in_size), tuple(out_size), bucket, batch, scores, mesh_key)
        if key not in self._runners:
            if self.cfg.eval.obj_parallel > 1 or mesh is not None:
                self.logger.info(f"obj_parallel {self.cfg.eval.obj_parallel}, {bucket} slots, "
                                 f"video batch {batch}: runner on {mesh or 'one device'}")
            runner = ChunkedVideoRunner(self.model, out_size, chunk=self.cfg.eval.chunk,
                                        scores=scores, preprocess=_preprocess(in_size),
                                        injectable=True, mesh=mesh)
            runner.warmup(raw_hw, batch, bucket, frame_dtype=np.uint8)
            self._runners[key] = runner
        return self._runners[key]

    # ------------------------------------------------------------------ #
    def _sizes(self, video) -> Tuple[tuple, tuple]:
        """(in_size, out_size) of a video."""
        if self.ytvos:
            return tuple(video.in_size), tuple(video.original_size)
        return tuple(self.cfg.eval.davis_in_size), tuple(video.init_mask.shape[:2])

    def _peek_key(self, idx: int):
        """(shape signature incl. the slot bucket, frame count) of a video,
        from its file headers only."""
        if self.ytvos:
            _, raw_hw, in_size, out_size, n_objs, n_frames = self.dataset.peek(idx)
            return (raw_hw, tuple(in_size), tuple(out_size), self._slot_bucket(n_objs)), n_frames
        _, out_size, n_objs, n_frames = self.dataset.peek(idx)
        return (tuple(out_size), self._slot_bucket(n_objs)), n_frames

    def _inputs(self, videos, bucket: int):
        """Batched runner inputs: init_mask (B,Ho,Wo,bucket+1), active
        (B,bucket) and the injections {t: (idx_map (B,Ho,Wo) uint8,
        new (B,bucket) bool)}; video b writes only row b."""
        B = len(videos)
        init_mask = np.stack([v.init_mask[..., :bucket + 1] for v in videos])
        active = np.zeros((B, bucket), bool)
        injections: Dict[int, tuple] = {}
        for b, v in enumerate(videos):
            if not self.ytvos:
                active[b, :v.n_objs] = True
                continue
            # the frame-0 slots from meta.json: an annotated object may have
            # an empty frame-0 mask
            active[b, [s for s in v.init_slots if s < bucket]] = True
            for t, inj in v.injections.items():
                idx_map, new = injections.setdefault(
                    t, (np.zeros((B,) + tuple(v.original_size), np.uint8),
                        np.zeros((B, bucket), bool)))
                for slot in inj["new_slots"]:
                    if slot < bucket:  # an over-budget slot was already warned about
                        idx_map[b][inj["mask"][..., slot + 1] > 0] = slot + 1
                        new[b, slot] = True
        return init_mask, active, injections

    def _infer(self, videos: List, bucket: int, fps: FrameSecondMeter,
               mesh=None) -> np.ndarray:
        """One batch of videos through its runner (on ``mesh``, default
        ``_obj_mesh(bucket)``) -> (T_max-1, B, Ho, Wo) uint8."""
        frames = _stack_padded(videos)
        init_mask, active, injections = self._inputs(videos, bucket)
        in_size, out_size = self._sizes(videos[0])
        runner = self._runner(frames.shape[2:4], in_size, out_size, bucket, len(videos),
                              mesh=mesh)
        fps.tic()
        preds = runner(None, frames, init_mask, active, injections,
                       bases=self.initial_bases(bucket))
        fps.toc(sum(v.frames.shape[0] for v in videos))
        return preds

    def _run_multi_scale(self, video, bucket: int, fps: FrameSecondMeter) -> np.ndarray:
        """(T-1, 1, Ho, Wo) uint8 from multi-scale and flip score averaging
        on the device; only the argmax crosses to the host. Scale s runs at
        (s, int(s * w / h)) of ``davis_in_size``: truncated, as the
        reference computes it."""
        frames = video.frames[:, None]
        T = frames.shape[0]
        init_mask, active, _ = self._inputs([video], bucket)
        _, out_size = self._sizes(video)
        if T == 1:  # only the annotated frame: nothing to predict
            fps.tic()
            fps.toc(T)
            return np.zeros((0, 1) + out_size, np.uint8)
        base_h, base_w = self.cfg.eval.davis_in_size
        runners = [self._runner(frames.shape[2:4], (s, int(s * base_w / base_h)), out_size,
                                bucket, scores=True) for s in self.cfg.eval.scales]
        fps.tic()
        total = None
        for runner in runners:
            scores = runner(None, frames, init_mask, active, bases=self.initial_bases(bucket))
            total = scores if total is None else total + scores
            if self.cfg.eval.flip:
                # flips of the host inputs are numpy views; the scores are
                # flipped back on the device
                flipped = runner(None, np.flip(frames, axis=-2), np.flip(init_mask, axis=-2),
                                 active, bases=self.initial_bases(bucket))
                total = total + torch.flip(flipped, dims=[-2])
        preds = total.argmax(dim=-1).to(torch.uint8).cpu().numpy()
        fps.toc(T)
        return preds

    # ------------------------------------------------------------------ #
    def _save(self, writer: AsyncWriter, video, preds: np.ndarray) -> None:
        """One video's palette PNGs: frame 0's annotation, then the
        predictions (T-1, Ho, Wo). YouTube-VOS saves only its annotated
        frames, with the slots mapped back to the annotation ids."""
        out_dir = os.path.join(self.out_root, video.name)
        mkdir(out_dir)
        names = video.frame_names
        if self.ytvos:
            first = video.first_label
            slot_map = np.zeros(self.n_slots + 1, np.uint8)
            slot_map[1:len(video.slot_to_orig) + 1] = video.slot_to_orig
            maps = {t: slot_map[preds[t - 1]] for t in range(1, video.frames.shape[0])
                    if names[t] in video.names_to_save}
        else:
            first = np.argmax(video.init_mask, axis=-1).astype(np.uint8)
            maps = {t: preds[t - 1] for t in range(1, video.frames.shape[0])}
        writer.submit(save_seg_mask, first, os.path.join(out_dir, f"{names[0]}.png"),
                      self.palette)
        for t, m in maps.items():
            writer.submit(save_seg_mask, m, os.path.join(out_dir, f"{names[t]}.png"), self.palette)

    def _save_overlays(self, video, preds: np.ndarray) -> None:
        from swem_tpu_torch.utils.visualization import save_overlay

        overlay_dir = os.path.join(self.save_dir, "overlay", video.name)
        mkdir(overlay_dir)
        maps = [np.argmax(video.init_mask, axis=-1).astype(np.uint8)] + list(preds)
        for t, m in enumerate(maps):
            save_overlay(video.frames[t], m,
                         os.path.join(overlay_dir, f"{video.frame_names[t]}.png"), self.palette)

    def evaluate(self) -> float:
        """Run this process's videos and write their PNGs; returns frames/s
        (also kept as ``self.fps``)."""
        vb = self.cfg.eval.video_batch
        if vb > 1:
            return self._evaluate_batched(vb)
        fps = FrameSecondMeter()
        mine = list(range(len(self.dataset)))[self._pid::self._nproc]
        with AsyncWriter() as writer:
            for idx, video in zip(mine, prefetch(self.dataset.__getitem__, mine)):
                bucket = self._slot_bucket(video.n_objs)
                self.logger.info(f"Testing video {idx}: {video.name} ({video.frames.shape[0]} "
                                 f"frames, {video.n_objs} objects -> {bucket} slots)")
                if self.multi_scale and not self.ytvos:
                    preds = self._run_multi_scale(video, bucket, fps)[:, 0]
                else:
                    preds = self._infer([video], bucket, fps)[:, 0]
                self._save(writer, video, preds)
                if self.cfg.eval.visualize and not self.ytvos:
                    self._save_overlays(video, preds)
        self.fps = fps.end()
        self.logger.info(f"fps: {fps.fps}")
        return fps.fps

    def _evaluate_batched(self, vb: int) -> float:
        """Throughput mode: ``vb`` videos per device batch.

        Videos are grouped by shape signature and slot bucket from their file
        headers alone, each group sorted by length so that batch-mates pad
        little; batch P+1 decodes while batch P runs. Padded frames touch
        only their own video's memory, and a video's injections only its
        own batch row, so each video's result is its sequential one up to
        the batched convolutions' summation order. Each process takes a
        round-robin slice of the whole batches.
        """
        groups: Dict[tuple, list] = {}
        for idx in range(len(self.dataset)):
            key, n_frames = self._peek_key(idx)
            groups.setdefault(key, []).append((idx, n_frames))
        plan = []
        for key, items in groups.items():
            items.sort(key=lambda it: it[1])
            indices = [i for i, _ in items]
            plan += [(key[-1], indices[i:i + vb]) for i in range(0, len(indices), vb)]
        plan = plan[self._pid::self._nproc]
        n_data, mesh = self._batch_mesh(vb)
        fps = FrameSecondMeter()
        batches = prefetch(lambda p: (p[0], [self.dataset[j] for j in p[1]]), plan, depth=1)
        with AsyncWriter() as writer:
            for bucket, videos in batches:
                group_mesh = None
                if mesh is not None and len(videos) % n_data == 0:
                    group_mesh = (self._obj_mesh(bucket, n_data=n_data) if mesh == "obj2d"
                                  else mesh)
                preds = self._infer(videos, bucket, fps, mesh=group_mesh)
                for b, v in enumerate(videos):
                    self._save(writer, v, preds[:, b])
                self.logger.info(f"batch of {len(videos)} videos ({[v.name for v in videos]}, "
                                 f"{bucket} slots) done")
        self.fps = fps.end()
        self.logger.info(f"fps (throughput, video_batch={vb}): {fps.fps}")
        return fps.fps

    # ------------------------------------------------------------------ #
    def get_metrics(self, per_object_csv: bool = False) -> Optional[Dict[str, float]]:
        """J&F of the saved PNGs against DAVIS val's ground truth (None for
        sets without public ground truth)."""
        from swem_tpu_torch.eval.benchmark import DavisEvaluation, write_reports

        if self.eval_set not in ("DAVIS16", "DAVIS17"):
            return None
        year = "2016" if self.eval_set == "DAVIS16" else "2017"
        metrics = DavisEvaluation(self.cfg.eval.data_root, year=year, gt_set="val").evaluate(
            self.out_root)
        return write_reports(metrics, self.save_dir, self.eval_set, self.logger,
                             per_object_csv=per_object_csv)

    def val(self) -> Optional[Dict[str, float]]:
        """Evaluate, then score DAVIS val (global results as a dict). Under
        distributed evaluation every process waits for the others' PNGs and
        process 0 alone scores them (the others return None)."""
        self.evaluate()
        parallel.barrier(f"{self.eval_set} PNGs")
        if self._pid != 0:
            return None
        return self.get_metrics(per_object_csv=self.cfg.eval.per_object_csv)
