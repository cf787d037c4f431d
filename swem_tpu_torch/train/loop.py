"""Training orchestration, counterpart of ``swem_tpu/train/loop.py``.

The train step (``trainer.make_train_step``) does the device work; this loop
handles the host's part: the prefetching loader (each next batch uploaded
while the device runs the step just queued), windowed loss meters with one
host sync per log period, LR and ETA logging, tensorboardX scalars and
overlays when tensorboardX imports, and checkpoints written on one
background thread: ``state.pth`` (the whole run) and ``variables.pth``
(the weights the evaluator reads), see ``io/checkpoint.py``.

Curriculum: the frame skip is a pure function of the iteration inside each
loader worker, so a resumed run's batches are an uninterrupted run's.

In a process group (``parallel.init_distributed``) each process reads its
shard of every global batch and the step averages the gradients
(``trainer.data_parallel``); the logged losses are the global ones (one
all-reduce per log period); process 0 alone writes checkpoints and
tensorboard scalars, and overlays are drawn only in a single process, as
the JAX package runs it. Every process loads ``state.pth`` itself on resume.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Optional

import numpy as np
import torch

from swem_tpu_torch import parallel
from swem_tpu_torch.config import SWEMConfig, resolve_device
from swem_tpu_torch.data.factory import build_train_loader
from swem_tpu_torch.io.checkpoint import (
    STATE_FILE,
    VARIABLES_FILE,
    load_train_checkpoint,
    save_train_checkpoint,
    to_host,
)
from swem_tpu_torch.models.swem import SWEM
from swem_tpu_torch.registry import register_trainer
from swem_tpu_torch.train.solver import max_iter_for_stage
from swem_tpu_torch.train.trainer import (
    batch_to_device,
    create_train_state,
    make_predict_batch,
    make_train_step,
    step_generator,
)
from swem_tpu_torch.utils import AvgMeter, mkdir, setup_logger
from swem_tpu_torch.utils.host_io import AsyncWriter

RNG_OFFSET = 77  # the step draws' seed is data.seed + 77, as in the JAX package


@register_trainer("SWEM")
class Trainer:
    """One training run of ``cfg`` on ``device`` (None: CUDA, raising without one)."""

    def __init__(self, cfg: SWEMConfig, logger=None, device=None):
        self.cfg = cfg
        device = resolve_device(device)
        self.exp_dir = os.path.join(cfg.log_dir, cfg.model.model_name, cfg.solver.stage_name,
                                    cfg.exp_name)
        mkdir(self.exp_dir)
        self.ckpt_dir = os.path.join(self.exp_dir, "checkpoints")
        self.rank, self.world = parallel.process_index(), parallel.process_count()
        log_name = "train_stage" if self.world == 1 else f"train_stage_p{self.rank}"
        self.logger = logger or setup_logger("swem_train", self.exp_dir, log_name)
        self.max_iter = max_iter_for_stage(cfg.solver)
        # the Gaussian locality read is inference-only in the reference
        model = SWEM(dataclasses.replace(cfg.model, n_kernel=0), device=device)
        self.model = model.init_weights(cfg.data.seed)
        self.device = self.model.device
        self.state = create_train_state(self.model, cfg.solver)
        self.train_step = make_train_step(cfg, remat=cfg.solver.remat)
        self._predict = None  # the overlays' forward, made at first use
        # one writer thread: checkpoint writes overlap training and stay in
        # order; max_pending=1 bounds host RAM to one extra snapshot
        self._saver = AsyncWriter(workers=1, max_pending=1)
        if cfg.resume is not None:
            self._resume(cfg.resume, from_scratch=cfg.from_scratch)
        nparams = sum(p.numel() for p in self.model.parameters())
        self.logger.info(
            f"SWEM trainer: stage {cfg.solver.stage_name}, {nparams / 1e6:.2f}M params, "
            f"device {self.device}, dtype {cfg.model.dtype}, global batch "
            f"{cfg.data.batch_size} over {self.world} process(es), max_iter {self.max_iter}")
        self.writer = None
        if self.rank == 0:  # process 0 alone writes the scalars
            try:
                from tensorboardX import SummaryWriter

                self.writer = SummaryWriter(os.path.join(self.exp_dir, "tb"))
            except ImportError:  # scalars and overlays are optional logging
                pass

    # ------------------------------------------------------------------ #
    def reset_optimizer(self) -> None:
        """A fresh optimizer and LR schedule over the current weights; the
        step is kept."""
        step = self.state.step
        self.state = create_train_state(self.model, self.cfg.solver, forward=self.state.forward)
        self.state.step = step

    def _resume(self, path: str, from_scratch: bool) -> None:
        """The whole run from ``<path>/state.pth`` unless ``from_scratch``;
        otherwise the weights only, from ``<path>/variables.pth`` or a
        reference ``.pth``, a single-object value encoder widened, with a
        fresh optimizer at step 0. An orbax directory raises (the JAX
        package reads it; ``scripts/orbax_to_pth.py`` converts it into
        these files). Every process reads the files itself, onto its own
        device."""
        from swem_tpu_torch import registry

        state_path = os.path.join(path, STATE_FILE)
        if not from_scratch and os.path.isfile(state_path):
            snap = load_train_checkpoint(state_path, map_location=self.device)
            self.model.load_state_dict(snap["model"])
            self.state.optimizer.load_state_dict(snap["optimizer"])
            self.state.scheduler.load_state_dict(snap["scheduler"])
            self.state.step = int(snap["step"])
            self.logger.info(f"Resumed the full state from {state_path} at step "
                             f"{self.state.step}")
            return
        var_path = os.path.join(path, VARIABLES_FILE)
        src = var_path if os.path.isfile(var_path) else path
        self.model.load_state_dict(registry.load_state_dict(self.cfg, src))
        self.state = create_train_state(self.model, self.cfg.solver, forward=self.state.forward)
        self.logger.info(f"Loaded model weights from {src}")

    def save(self, step: int) -> None:
        """Checkpoint: the model, optimizer, LR scheduler and step copied to
        the host now (the next step updates them in place), the disk write
        on the writer thread; process 0 alone writes (the processes hold
        the same state), the model's own ``state_dict``, not the data
        parallel wrapper's."""
        if self.rank != 0:
            return
        snap = to_host({"model": self.model.state_dict(),
                        "optimizer": self.state.optimizer.state_dict(),
                        "scheduler": self.state.scheduler.state_dict(),
                        "step": self.state.step})

        def write():
            save_train_checkpoint(self.ckpt_dir, snap)
            self.logger.info(f"Saved checkpoint at iteration {step}")

        self._saver.submit(write)

    # ------------------------------------------------------------------ #
    def _install_preemption_handlers(self):
        """SIGTERM/SIGINT checkpoint the run at the next step boundary.

        The handler only sets a flag: the loop finishes the step in flight,
        writes a full checkpoint and returns, so ``--resume`` continues
        where the signal landed. A second SIGINT restores the default
        handlers and interrupts.
        """
        self._preempt_signum = None
        handlers = {}

        def _on_signal(signum, frame):
            if self._preempt_signum == signal.SIGINT and signum == signal.SIGINT:
                for s, h in handlers.items():
                    signal.signal(s, h)
                raise KeyboardInterrupt
            self._preempt_signum = signum

        try:
            for s in (signal.SIGTERM, signal.SIGINT):
                handlers[s] = signal.signal(s, _on_signal)
        except ValueError:  # not the main thread: signals are its business
            pass
        return handlers

    def train(self):
        cfg = self.cfg
        start_iter = self.state.step
        loader = build_train_loader(cfg, start_iter=start_iter, shard_id=self.rank,
                                    num_shards=self.world)
        meters = {k: AvgMeter(100) for k in ("total_loss", "main_loss", "aux_loss")}
        seed = cfg.data.seed + RNG_OFFSET
        t_start = time.perf_counter()
        it = start_iter
        batches = iter(loader)

        def next_batch():
            """The next host batch, uploaded; called right after a step is
            queued, so the upload overlaps the device's work."""
            b = next(batches)
            s = float(np.mean(b.pop("skips"))) if "skips" in b else None
            return batch_to_device(b, self.device), s

        pending = []  # the losses of every step since the last log line
        sig_handlers = self._install_preemption_handlers()
        try:
            nxt = next_batch() if it < self.max_iter else None
            while it < self.max_iter:
                batch, skips = nxt
                losses = self.train_step(self.state, batch, step_generator(seed, it))
                pending.append(losses)
                it += 1
                # the flag is read before the blocking prefetch, so that the
                # grace period covers only the step in flight and the write
                preempted = self._preempt_signum is not None
                if not preempted and it < self.max_iter:
                    nxt = next_batch()
                    preempted = self._preempt_signum is not None
                if preempted:
                    self.logger.info(
                        f"Signal {signal.Signals(self._preempt_signum).name} received: "
                        f"checkpointing at iteration {it} and stopping (resume with --resume "
                        f"to continue)")
                    self.save(it)
                    break
                if it % cfg.log_period == 0 or it == self.max_iter:
                    self._log(it, start_iter, t_start, pending, meters, skips)
                    pending.clear()
                # one process only: the overlay's forward is this process's alone
                if (cfg.vis_period and self.writer is not None and self.world == 1
                        and it % cfg.vis_period == 0):
                    self._log_overlays(batch, step_generator(seed, it), it)
                if it % cfg.save_period == 0 or it == self.max_iter:
                    self.save(it)
        finally:
            for s, h in sig_handlers.items():
                signal.signal(s, h)
            loader.close()
            # the last write lands (or raises) before callers read it back
            self._saver.flush()
        self.logger.info("Training done.")
        return self.state

    def _log(self, it: int, start_iter: int, t_start: float, pending, meters, skips) -> None:
        """One host sync for the whole window: every step's losses are
        averaged, over the processes too (one all-reduce)."""
        keys = list(meters)
        values = torch.stack([torch.stack([m[k] for k in keys]) for m in pending])
        values = parallel.global_mean(values).cpu()
        for row in values.tolist():
            for k, v in zip(keys, row):
                meters[k].update(v)
        lr = self.state.scheduler.get_last_lr()[0]
        elapsed = time.perf_counter() - t_start
        rate = (it - start_iter) / max(elapsed, 1e-9)
        eta_h = (self.max_iter - it) / max(rate, 1e-9) / 3600
        self.logger.info(
            f"it {it}/{self.max_iter} loss {meters['total_loss'].avg:.4f} "
            f"(main {meters['main_loss'].avg:.4f}, aux {meters['aux_loss'].avg:.4f}) "
            f"p {pending[-1]['p']:.2f} lr {lr:.2e} {rate:.2f} it/s eta {eta_h:.1f}h")
        if self.writer is not None:
            for k, m in meters.items():
                self.writer.add_scalar(f"train/{k}", m.avg, it)
            self.writer.add_scalar("train/lr", lr, it)
            if skips is not None:
                self.writer.add_scalar("train/mean_skip", skips, it)

    def _log_overlays(self, batch, generator: Optional[torch.Generator], it: int) -> None:
        """Prediction | ground-truth overlay grid of the batch's first clip."""
        from swem_tpu_torch.data.palette import davis_palette
        from swem_tpu_torch.utils.visualization import add_overlay

        if self._predict is None:
            self._predict = make_predict_batch(self.cfg)
        preds = self._predict(self.state, batch, generator).cpu().numpy()  # (B, T-1, H, W)
        frames = batch["frames"][0].cpu().numpy()
        labels = batch["label"][0].cpu().numpy()
        pal = davis_palette()
        panels = []
        for t in range(preds.shape[1]):
            img = frames[t + 1]
            if img.dtype != np.uint8:
                img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            panels.append(add_overlay(img[..., ::-1], preds[0, t], pal)[..., ::-1])
            panels.append(add_overlay(img[..., ::-1], labels[t + 1], pal)[..., ::-1])
        self.writer.add_image("train/pred_vs_gt", np.concatenate(panels, axis=1), it,
                              dataformats="HWC")
