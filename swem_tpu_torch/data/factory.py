"""Training dataset factory (the port's copy of ``swem_tpu/data/factory.py``, a
re-design of the reference implementation's datasets/__init__.py:9-71).

Stage wiring: 0 = static pretrain; 1 = DAVIS17; 2 = YTVOS19;
3 = DAVIS17 x DATA_FREQ + YTVOS19. Curriculum skip is a pure function of
the iteration (no loader rebuilds). Subset whitelists ship with the package
(swem_tpu_torch/data/imagesets, the reference's datasets/ImageSets lists).
"""

from __future__ import annotations

import functools
import os
from typing import Callable, List

from swem_tpu_torch.config import SWEMConfig
from swem_tpu_torch.data.loader import TrainLoader
from swem_tpu_torch.data.static_dataset import StaticTrainDataset
from swem_tpu_torch.data.video_dataset import VideoTrainDataset
from swem_tpu_torch.train.solver import max_iter_for_stage

IMAGESETS_DIR = os.path.join(os.path.dirname(__file__), "imagesets")


class ConcatDataset:
    """Index-partitioned concatenation (torch ConcatDataset equivalent)."""

    def __init__(self, datasets: List):
        self.datasets = datasets
        self.sizes = [len(d) for d in datasets]
        self.total = sum(self.sizes)

    def __len__(self) -> int:
        return self.total

    def sample(self, rng, idx: int, cur_iter: int):
        idx = idx % self.total
        for d, n in zip(self.datasets, self.sizes):
            if idx < n:
                return d.sample(rng, idx, cur_iter)
            idx -= n
        raise IndexError


def _davis(cfg: SWEMConfig, max_iter: int) -> VideoTrainDataset:
    return VideoTrainDataset(
        "DAVIS17", os.path.join(cfg.data.data_root, "DAVIS"),
        num_frames=cfg.data.num_frames, max_objs=cfg.data.max_num_objs,
        crop_size=cfg.data.vid_crop_size, max_skip=cfg.data.davis_max_skip,
        samples_per_video=cfg.data.davis_samples_per_video, max_iter=max_iter,
        subset_file=os.path.join(IMAGESETS_DIR, "davis_subset.txt"),
    )


def _ytvos(cfg: SWEMConfig, max_iter: int) -> VideoTrainDataset:
    return VideoTrainDataset(
        "YTVOS19", os.path.join(cfg.data.data_root, "YTVOS19"),
        num_frames=cfg.data.num_frames, max_objs=cfg.data.max_num_objs,
        crop_size=cfg.data.vid_crop_size, max_skip=cfg.data.ytvos_max_skip,
        samples_per_video=cfg.data.ytvos_samples_per_video, max_iter=max_iter,
        subset_file=os.path.join(IMAGESETS_DIR, "yv_subset.txt"),
        load_size=None if cfg.data.vid_load_size == 480 else cfg.data.vid_load_size,
    )


def _build_stage_dataset(cfg: SWEMConfig):
    stage = cfg.solver.stage
    max_iter = max_iter_for_stage(cfg.solver)
    if stage == 0:
        return StaticTrainDataset(
            os.path.join(cfg.data.data_root, "STCN_PreTrain"),
            datasets=cfg.data.pretrain_sets, ratios=cfg.data.pretrain_set_ratio,
            num_frames=cfg.data.num_frames, max_objs=cfg.data.max_num_objs,
            crop_size=cfg.data.vid_crop_size,
        )
    if stage == 1:
        return _davis(cfg, max_iter)
    if stage == 2:
        return _ytvos(cfg, max_iter)
    davis = _davis(cfg, max_iter)
    ytvos = _ytvos(cfg, max_iter)
    return ConcatDataset([davis] * cfg.data.data_freq[0] + [ytvos] * cfg.data.data_freq[1])


def build_dataset_factory(cfg: SWEMConfig) -> Callable:
    """Picklable zero-arg factory (built inside each spawned worker)."""
    return functools.partial(_build_stage_dataset, cfg)


def build_train_loader(cfg: SWEMConfig, *, start_iter: int = 0, shard_id: int = 0,
                       num_shards: int = 1) -> TrainLoader:
    """The loader of shard ``shard_id`` of ``num_shards``: ``cfg.data.batch_size``
    is the global batch, each shard reads ``batch_size // num_shards`` rows of
    it. A global batch that the shards do not divide raises (the JAX
    package's factory floors the division, which shrinks the global batch)."""
    if cfg.data.batch_size % num_shards:
        raise ValueError(f"batch size {cfg.data.batch_size} does not divide over "
                         f"{num_shards} processes")
    return TrainLoader(
        build_dataset_factory(cfg), cfg.data.batch_size // num_shards, seed=cfg.data.seed,
        num_workers=cfg.data.num_workers, start_iter=start_iter, shard_id=shard_id,
        num_shards=num_shards,
    )
