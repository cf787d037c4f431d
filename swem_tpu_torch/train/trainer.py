"""The training step, counterpart of ``swem_tpu/train/trainer.py``.

One step: frame-0 init, T-1 supervised frames (read, decode, and on every
frame but the last value-encode the prediction and memorize it), the loss,
``backward`` and the optimizer update. The EM memory is an explicit
``VOSMemory`` carried through the Python loop; its W/E/M loop runs in K1
(``ops/em_kernel.em_loop``) under ``no_grad``, as the JAX package runs it
under ``stop_gradient``: only the ``nu`` update carries gradients. Reads
take the differentiable read in PyTorch ops (``SWEM.match(train=True)``),
never K2, as the JAX package never routes a training read to its kernel.

Batch layout (channel-last, tensors on the model's device):
  frames:    (B, T, H, W, 3) uint8, or float already in [0, 1]
  label:     (B, T, H, W) integer slot labels of every frame
  valid_obj: (B, N+1) float {0,1} validity including the background channel
  masks:     optional (B, T, H, W, N+1) one-hot ground truth; derived from
             ``label`` on the device when absent (the loader ships uint8)

The step runs under ``config.full_float32`` (TF32 off for float32 work, in
the backward pass too), with gradients on.

Data parallelism: with a process group up, the unrolled forward runs
through ``DistributedDataParallel``, which averages the gradients over the
processes in the backward pass. Every loss term is a batch mean of
per-clip terms, so the average of equal per-process batches is the global
batch's gradient and every process takes the same optimizer step. Each
process draws the initial bases and keep masks for the global batch and
keeps its rows (``parallel.shard_rows``), the rows its loader shard holds,
so that N processes compute what one process computes on the global batch.

Object parallelism: ``make_train_step(cfg, sharding=)`` runs the unroll per
shard of a ``parallel.EngineSharding`` grid, every shard on the model's
device (the port's data parallelism over devices is the processes above):
each shard encodes its rows' frames, reads, decodes, value-encodes and
memorizes its slots, and every shard of a grid row takes the row's
per-object probabilities through a differentiable copy, so that the
backward pass carries each slot's gradient back to its shard.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel
from torch.utils.checkpoint import checkpoint

from swem_tpu_torch import parallel
from swem_tpu_torch.config import SWEMConfig, SolverConfig, full_float32
from swem_tpu_torch.engine import _flat_mv, _flat_qk, _slots
from swem_tpu_torch.models import em
from swem_tpu_torch.models.swem import SWEM, aggregate, hard_mask_from_pred, prepare_em_masks
from swem_tpu_torch.parallel.mesh import EngineSharding, make_mesh2
from swem_tpu_torch.train.losses import make_criterion
from swem_tpu_torch.train.solver import make_optimizer


class UnrolledForward(torch.nn.Module):
    """``_unrolled_forward`` of ``model`` as one module's ``forward``:
    ``DistributedDataParallel`` prepares its gradient sync only in its own
    forward, so the unroll, which calls the model's stages one by one, runs
    inside one."""

    def __init__(self, model: SWEM):
        super().__init__()
        self.model = model

    def forward(self, frames, init_mask, valid_obj, bases: em.Bases,
                keeps: Optional[Sequence[torch.Tensor]] = None,
                remat: Optional[str] = None,
                sharding: Optional[EngineSharding] = None) -> torch.Tensor:
        return _unrolled_forward(self.model, frames, init_mask, valid_obj, bases, keeps, remat,
                                 sharding)


def data_parallel(model: SWEM) -> torch.nn.Module:
    """The train step's forward module: ``UnrolledForward(model)``, in
    ``DistributedDataParallel`` when a process group is up (at any world
    size). Every parameter gets a gradient, so no unused-parameter search;
    the buffers (``FrozenBatchNorm`` constants) are not broadcast, as the
    reference runs it."""
    forward = UnrolledForward(model)
    if not dist.is_initialized():
        return forward
    dev = model.device
    if dev.type == "cuda":
        device_ids = [torch.cuda.current_device() if dev.index is None else dev.index]
    else:
        device_ids = None
    with warnings.catch_warnings():
        # newer PyTorch deprecates broadcast_buffers for forward_sync_buffers,
        # which older ones lack; both take broadcast_buffers=False
        warnings.filterwarnings("ignore", message=".*broadcast_buffers", category=FutureWarning)
        return DistributedDataParallel(forward, device_ids=device_ids, broadcast_buffers=False)


@dataclass
class TrainState:
    """The model, its optimizer and LR scheduler, the step (a host int) and
    the forward module the step runs (``data_parallel``)."""

    model: SWEM
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.MultiStepLR
    forward: torch.nn.Module
    step: int = 0


def create_train_state(model: SWEM, solver: SolverConfig,
                       forward: Optional[torch.nn.Module] = None) -> TrainState:
    """A fresh optimizer and schedule over ``model`` at step 0; ``forward``
    is kept when given (a new ``DistributedDataParallel`` would sync the
    processes again), else made by ``data_parallel``."""
    opt, sched = make_optimizer(solver, model.parameters())
    return TrainState(model=model.train(), optimizer=opt, scheduler=sched,
                      forward=forward if forward is not None else data_parallel(model))


def step_generator(seed: int, step: int) -> torch.Generator:
    """The draws of step ``step`` (initial bases, then the ``p_drop`` keep
    masks frame by frame), a function of (seed, step) alone, so that a
    resumed run draws what an uninterrupted one would."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host arrays -> tensors on ``device`` (pinned and asynchronous on CUDA)."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


def _model_inputs(batch: Dict[str, torch.Tensor], n_slots: int):
    """(frames float32 in [0, 1], frame-0 one-hot (B,H,W,N+1), label long).

    uint8 frames are divided by 255 on the device, bit for bit the host
    conversion; the frame-0 one-hot comes from ``label`` unless the batch
    has ``masks``."""
    frames = batch["frames"]
    if frames.dtype == torch.uint8:
        frames = frames.float() / 255.0
    label = batch["label"].long()
    if "masks" in batch:
        init_mask = batch["masks"][:, 0].float()
    else:
        init_mask = (label[:, 0, ..., None] == torch.arange(n_slots, device=label.device)).float()
    return frames, init_mask, label


def _unrolled_forward(model: SWEM, frames, init_mask, valid_obj, bases: em.Bases,
                      keeps: Optional[Sequence[torch.Tensor]] = None,
                      remat: Optional[str] = None,
                      sharding: Optional[EngineSharding] = None) -> torch.Tensor:
    """Frame-0 init + supervised unroll over frames 1..T-1 -> stacked logits
    (B, T-1, H, W, N+1).

    ``bases``: the initial EM bases (batch B). ``keeps``: the T-1 ``p_drop``
    keep masks, one per supervised frame, drawn by the caller (needed when
    ``cfg.p_drop > 0``). ``remat``: ``"encoder"`` recomputes each key encode
    in the backward pass, ``"block"`` each supervised frame's whole block
    (whose memorize then launches K1 again); the keep masks are inputs of
    the block, so the recomputation drops the same bases.

    The unroll runs over the grid of ``sharding`` (default: one shard, the
    whole batch and every slot), whose shards all lie on the model's
    device: shard (i, j) runs batch rows i and object slots j, and the
    logits come from column 0 of each row, joined over the rows.
    """
    if sharding is None:
        sharding = EngineSharding(make_mesh2(1, 1, devices=[model.device]))
    elif any(r is not model for r in sharding.replicas(model).values()):
        raise ValueError(f"the sharded train step runs every shard on the model's device "
                         f"{model.device}; the mesh holds {sharding.devices}")
    cfg = model.cfg
    B, T, H, W, _ = frames.shape
    valid = valid_obj[:, 1:]
    active = valid > 0.5
    rows, cols = sharding.rows(B), sharding.cols(valid.shape[1])
    split = sharding.split_bases(bases, B)
    encode = model.encode_frame
    if remat == "encoder":
        encode = partial(checkpoint, model.encode_frame, use_reentrant=False)

    def memorize(mem, qk16, mv16, em_masks, i, j):
        return em.memorize(mem, _flat_qk(qk16), _flat_mv(mv16), em_masks,
                           active[rows[i], cols[j]], n_iters=cfg.num_em_iters, tau=cfg.em_tau)

    mem = [[None] * sharding.n_obj for _ in range(sharding.n_data)]
    for i, j, _ in sharding.shards():
        frame, mask = frames[rows[i], 0], _slots(init_mask[rows[i]], cols[j])
        qk16, _, s16, _, _, vf0 = encode(frame)
        mv16 = model.encode_value(frame, mask, s16, vf0)
        mem[i][j] = memorize(em.fresh_memory(split[i][j]), qk16, mv16,
                             prepare_em_masks(mask, mask, tuple(qk16.shape[-2:])), i, j)

    def frame_block(mem, frame, keep, last: bool):
        """One supervised frame over the grid: each shard encodes -> matches
        -> decodes its slots; every shard of a row aggregates the row's
        objects (-> memorizes its slots)."""
        keys, probs = {}, [[None] * sharding.n_obj for _ in range(sharding.n_data)]
        for i, j, _ in sharding.shards():
            keys[i, j] = qk16, qv16, _, skip8, skip4, _ = encode(frame[rows[i]])
            context = model.match(qk16, qv16, mem[i][j], train=True,
                                  keep=None if keep is None else keep[rows[i], cols[j]])
            probs[i][j] = model.decode_objects(context, skip8, skip4, valid[rows[i], cols[j]],
                                               (H, W))
        mem = [list(row) for row in mem]
        logits_rows = []
        for i, j, d in sharding.shards():
            logits = aggregate(sharding.gather_objects(probs[i], d))
            if j == 0:
                logits_rows.append(logits)
            if not last:
                pred_mask = torch.softmax(logits, dim=-1)
                soft = _slots(pred_mask, cols[j])
                qk16, _, s16, _, _, vf = keys[i, j]
                mv16 = model.encode_value(frame[rows[i]], soft, s16, vf)
                em_masks = prepare_em_masks(_slots(hard_mask_from_pred(pred_mask), cols[j]), soft,
                                            tuple(qk16.shape[-2:]))
                mem[i][j] = memorize(mem[i][j], qk16, mv16, em_masks, i, j)
        return mem, torch.cat(logits_rows)

    logits_list = []
    for t in range(1, T):
        keep = None if keeps is None else keeps[t - 1]
        if remat == "block":
            mem, logits = checkpoint(frame_block, mem, frames[:, t], keep, t == T - 1,
                                     use_reentrant=False)
        else:
            mem, logits = frame_block(mem, frames[:, t], keep, t == T - 1)
        logits_list.append(logits)
    return torch.stack(logits_list, dim=1)


def draw_step(model: SWEM, generator: Optional[torch.Generator], batch_size: int,
              n_frames: int):
    """One step's draws from ``generator``: the initial bases, then, with
    ``p_drop > 0``, the keep masks of the T-1 supervised frames. Drawn for
    the global batch (``batch_size`` rows in each of the processes) and
    cut to this process's rows (``parallel.shard_rows``).
    Returns (bases, keeps or None), on the model's device."""
    cfg = model.cfg
    rank, world = parallel.process_index(), parallel.process_count()

    def mine(x):
        return parallel.shard_rows(x, rank, world).to(model.device)

    bases = em.init_bases(generator, batch_size * world, cfg.max_objs, cfg.keydim, cfg.valdim,
                          cfg.num_bases)
    bases = em.Bases(mine(bases.kappa), mine(bases.nu), mine(bases.zita))
    keeps = None
    if cfg.p_drop > 0:
        keeps = [mine(em.draw_keep(generator, batch_size * world, cfg.max_objs,
                                   2 * cfg.num_bases, cfg.p_drop))
                 for _ in range(n_frames - 1)]
    return bases, keeps


def make_train_step(cfg: SWEMConfig, remat: Optional[str] = None,
                    sharding: Optional[EngineSharding] = None) -> Callable:
    """The train step: ``step(state, batch, generator=None, *, bases=None,
    keeps=None) -> losses``; with ``sharding``, the unroll runs over its
    grid (``_unrolled_forward``).

    Updates ``state`` in place (parameters, optimizer, scheduler, step + 1)
    and returns the loss terms as detached device tensors (``p`` a host
    float), so that the caller syncs when it chooses; under data
    parallelism they are this process's (``parallel.global_mean`` makes
    them global). The initial bases and keep masks come from ``generator``
    unless given for the rows of ``batch`` (the parity tests hand in the
    JAX package's draws).
    """
    criterion = make_criterion(cfg.loss)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None, *,
                   bases: Optional[em.Bases] = None,
                   keeps: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        model = state.model
        with torch.enable_grad(), full_float32():
            frames, init_mask, label = _model_inputs(batch, model.cfg.max_objs + 1)
            valid_obj = batch["valid_obj"].float()
            if bases is None:
                bases, drawn = draw_step(model, generator, frames.shape[0], frames.shape[1])
                keeps = drawn if keeps is None else keeps
            logits = state.forward(frames, init_mask, valid_obj, bases, keeps, remat=remat,
                                   sharding=sharding)
            losses = criterion(logits, label[:, 1:], state.step, valid_obj)
            state.optimizer.zero_grad(set_to_none=True)
            losses["total_loss"].backward()
            state.optimizer.step()
            state.scheduler.step()
        state.step += 1
        return {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in losses.items()}

    return train_step


def make_predict_batch(cfg: SWEMConfig) -> Callable:
    """Forward-only batch prediction for the training overlays:
    ``predict(state, batch, generator) -> (B, T-1, H, W) uint8``."""

    @torch.no_grad()
    def predict(state: TrainState, batch, generator: Optional[torch.Generator] = None):
        model = state.model
        with full_float32():
            frames, init_mask, _ = _model_inputs(batch, model.cfg.max_objs + 1)
            bases, keeps = draw_step(model, generator, frames.shape[0], frames.shape[1])
            logits = _unrolled_forward(model, frames, init_mask, batch["valid_obj"].float(),
                                       bases, keeps)
        return logits.argmax(dim=-1).to(torch.uint8)

    return predict
