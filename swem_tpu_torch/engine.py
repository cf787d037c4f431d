"""Frame-sequential inference engine, counterpart of ``swem_tpu/engine.py``.

The EM memory is an explicit ``VOSMemory`` carried through a Python loop
over frames. Frames are ``(T, B, H, W, 3)`` float in [0, 1], masks
``(B, Ho, Wo, N+1)`` one-hot at the output size, ``active`` ``(B, N)`` bool;
predictions are ``(T-1, B, Ho, Wo)`` uint8 slot indices. Every tensor lives
on ``model.device``.

Every entry point runs without gradients and under ``full_float32``: float32
convolutions and matrix products compute in full float32 whatever the
caller's TF32 flags, at both compute dtypes. The features enter the memory
as float32.

Object parallelism: every call runs over a grid of shards (batch rows i,
object slots j): ``sharding=`` (``parallel.EngineSharding``), whose memory
is the grid ``mem[i][j]`` of its shards, or else the 1x1 grid of the
model's device, whose memory is one ``VOSMemory`` and which copies nothing.
Each shard key-encodes its rows' frames, reads its slots' memory (K2) and
decodes its slots; each grid row's per-object probabilities go, as exact
copies, to every shard of the row, where the soft aggregation and the
injection run; each shard then value-encodes and memorizes its slots (K1).
Predictions come from column 0 of each row, joined over the rows on the
device of ``active``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from swem_tpu_torch.config import full_float32, no_grad
from swem_tpu_torch.models import em
from swem_tpu_torch.models.layers import stamp_of
from swem_tpu_torch.models.swem import (
    SWEM,
    aggregate,
    prepare_em_masks,
    prepare_em_masks_from_idx,
)
from swem_tpu_torch.ops.resize import resize
from swem_tpu_torch.parallel.mesh import EngineSharding
from swem_tpu_torch.utils import cuda_graphs
from swem_tpu_torch.utils.profiling import count, request, span, tracing


def _entry_point(fn):
    """Run ``fn`` without gradients, under ``full_float32``."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with no_grad(), full_float32():
            return fn(*args, **kwargs)
    return run


def _flat_qk(qk16):
    """(B,Ck,h,w) -> (B,P,Ck) float32."""
    return qk16.flatten(2).transpose(1, 2).float()


def _flat_mv(mv16):
    """(B,N,Cv,h,w) -> (B,N,P,Cv) float32."""
    return mv16.flatten(3).transpose(2, 3).float()


def _slots(masks, cols: slice):
    """(..., N+1) masks -> the background channel and slots ``cols``: the
    channels an object shard needs (``masks`` itself when that is every
    slot)."""
    if cols.start == 0 and cols.stop + 1 == masks.shape[-1]:
        return masks
    return torch.cat([masks[..., :1], masks[..., cols.start + 1:cols.stop + 1]], dim=-1)


def _grid(model: SWEM, sharding: Optional[EngineSharding]) -> EngineSharding:
    """The grid a call runs over: ``sharding``, else the model's device's 1x1."""
    return EngineSharding.single(model.device) if sharding is None else sharding


def _as_grid(x, sharding: Optional[EngineSharding]):
    """An unsharded call's memory (or keys) as the 1x1 grid of it."""
    return [[x]] if sharding is None else x


def _as_given(grid, sharding: Optional[EngineSharding]):
    """The inverse of ``_as_grid``."""
    return grid[0][0] if sharding is None else grid


@_entry_point
def init_memory(model: SWEM, generator: Optional[torch.Generator], frame0, init_mask, active, *,
                bases: Optional[em.Bases] = None, sharding: Optional[EngineSharding] = None):
    """Frame-0 memory: encode frame 0 and its mask, EM-memorize from fresh bases.

    frame0 (B,H,W,3); init_mask (B,Ho,Wo,N+1); active (B,N). The initial
    prototypes are one random draw of N slots from ``generator`` shared
    across the batch, or ``bases`` (batch 1 or B) when given. N comes from
    the mask, not from ``model.cfg.max_objs``: the weights do not depend on
    the slot count, so one model serves every slot budget. Returns a
    ``VOSMemory``, or with ``sharding`` the grid of its shards, each shard
    initialized from its rows and slots of the inputs.
    """
    with span("engine.init_memory"):
        cfg, grid = model.cfg, _grid(model, sharding)
        if bases is None:
            bases = em.init_bases(generator, 1, init_mask.shape[-1] - 1, cfg.keydim, cfg.valdim,
                                  cfg.num_bases)
        reps = grid.replicas(model)
        rows, cols = grid.rows(active.shape[0]), grid.cols(active.shape[1])
        split = grid.split_bases(bases, active.shape[0])
        return _as_given([[_init_memory(reps[d], frame0[rows[i]].to(d),
                                        _slots(init_mask[rows[i]], cols[j]).to(d),
                                        active[rows[i], cols[j]].to(d), split[i][j])
                           for j, d in enumerate(row)] for i, row in enumerate(grid.grid)],
                         sharding)


def _init_memory(model: SWEM, frame0, init_mask, active, bases: em.Bases):
    """``init_memory`` of one shard, from its bases on its device."""
    cfg = model.cfg
    qk16, _, s16, _, _ = model.encode_key(frame0)
    init_mask_in = resize(init_mask.float(), tuple(frame0.shape[1:3]), "nearest")
    mv16 = model.encode_value(frame0, init_mask_in, s16)
    B, _, h, w = qk16.shape
    mem = em.fresh_memory(bases.expand(B))
    em_masks = prepare_em_masks(init_mask, init_mask.float(), (h, w))
    return em.memorize(mem, _flat_qk(qk16), _flat_mv(mv16), em_masks, active,
                       n_iters=cfg.num_em_iters, tau=cfg.em_tau)


@_entry_point
def encode_keys_batched(model: SWEM, frames):
    """Key-encode a frame stack in one batched pass: (T,B,H,W,3) -> tuple of (T,B,...)."""
    with span("engine.encode_keys"):
        return _encode_keys(model, frames)


def _encode_keys(model: SWEM, frames):
    T, B = frames.shape[:2]
    keys = model.encode_frame(frames.reshape((T * B,) + frames.shape[2:]))
    return tuple(k.reshape((T, B) + k.shape[1:]) for k in keys)


def _per_frame(frames, keys):
    """A chunk's frames (C,B,...) and keys (tuple of (C,B,...)) -> the C
    frames and the C frames' key tuples."""
    return frames.unbind(0), list(zip(*(k.unbind(0) for k in keys)))


def _inject(pred_mask, active, inject_mask, inject_new):
    """Zero the predictions under newly-injected objects, then overwrite the
    new slots' channels with the provided ground truth; the new slots join
    ``active``."""
    new_any = inject_mask[..., 1:].sum(dim=-1, keepdim=True) > 0
    pred_mask = torch.where(new_any, 0.0, pred_mask)
    ch_sel = torch.cat([torch.zeros_like(inject_new[:, :1]), inject_new], dim=-1)
    pred_mask = torch.where(ch_sel[:, None, None, :], inject_mask.float(), pred_mask)
    return pred_mask, active | inject_new


@_entry_point
def step(model: SWEM, mem, frame, active, out_size: Tuple[int, int], *,
         do_memorize: bool = True, inject_mask=None, inject_new=None, keys=None,
         sharding: Optional[EngineSharding] = None):
    """One inference frame.

    frame (B,H,W,3); active (B,N) slots live before this frame;
    inject_mask (B,Ho,Wo,N+1) + inject_new (B,N): ground-truth masks of
    objects appearing at this frame. ``keys``: this frame's ``encode_frame``
    tuple, if already computed (with ``sharding``: a grid of each shard's).
    Returns (mem, pred_idx (B,Ho,Wo) uint8, pred_mask (B,Ho,Wo,N+1)); with
    ``sharding``, ``mem`` is the grid of ``init_memory(sharding=)``.
    """
    grid = _grid(model, sharding)
    reps = grid.replicas(model)
    frames = _split_rows(grid, frame, active.shape[0], 0)
    if keys is None:
        with span("engine.encode_keys"):
            keys = [[reps[d].encode_frame(f) for f, d in zip(fs, row)]
                    for fs, row in zip(frames, grid.grid)]
    else:
        keys = _as_grid(keys, sharding)
    mem, pred_idx, pred_mask = _step_shards(grid, reps, _as_grid(mem, sharding), frames, keys,
                                            active, out_size, do_memorize, inject_mask,
                                            inject_new)
    return _as_given(mem, sharding), pred_idx, pred_mask


def memorize_from_pred(model: SWEM, mem, frame, active, qk16, s16, vf, pred_idx, pred_mask,
                       slot0: int = 0):
    """Value-encode the predicted mask and EM-update the memory. An object
    shard passes its channels of ``pred_mask`` (background and its slots,
    the first being slot ``slot0 + 1`` of ``pred_idx``)."""
    cfg = model.cfg
    with span("engine.memorize"):
        soft_in = resize(pred_mask, tuple(frame.shape[1:3]), "bilinear")
        mv16 = model.encode_value(frame, soft_in, s16, vf)
        em_masks = prepare_em_masks_from_idx(pred_idx, soft_in, tuple(qk16.shape[-2:]), slot0)
        return em.memorize(mem, _flat_qk(qk16), _flat_mv(mv16), em_masks, active,
                           n_iters=cfg.num_em_iters, tau=cfg.em_tau)


def _split_rows(sharding: EngineSharding, x, B: int, axis: int) -> list:
    """The grid of ``x``'s rows (along ``axis``) on each shard's device."""
    rows = sharding.rows(B)
    return [[x[(slice(None),) * axis + (rows[i],)].to(d) for d in sharding.grid[i]]
            for i in range(sharding.n_data)]


def _decode_row(sharding: EngineSharding, reps: dict, row, contexts: list, keys: list, act,
                cols: list, out_size: Tuple[int, int]) -> list:
    """A grid row's decode: each shard decodes its slots from its read
    ``contexts`` and ``keys``; every shard of the row then takes the row's
    objects (the one gather per frame) and aggregates them -> each shard's
    soft masks (B,Ho,Wo,N+1). ``act``: the row's (B,N) slots."""
    probs = [reps[d].decode_objects(contexts[j], *keys[j][3:5], act[:, cols[j]].to(d).float(),
                                    out_size)
             for j, d in enumerate(row)]
    return [torch.softmax(aggregate(sharding.gather_objects(probs, d)), dim=-1) for d in row]


def _step_shards(sharding: EngineSharding, reps: dict, mem, frames, keys, active,
                 out_size: Tuple[int, int], do_memorize: bool, inject_mask=None,
                 inject_new=None):
    """``step`` over the grid: ``mem``, ``frames`` and ``keys`` are grids of
    each shard's memory and (B/n_data, ...) inputs on its device; ``active``
    and the injection are whole, on one device. A grid row reads its slots,
    then decodes and aggregates them in one ``engine.decode``; each of its
    shards then injects and memorizes."""
    B, N = active.shape
    rows, cols = sharding.rows(B), sharding.cols(N)
    mem = [list(row) for row in mem]
    idx_rows, mask_rows = [], []
    for i, row in enumerate(sharding.grid):
        act, contexts = active[rows[i]], []
        for j, d in enumerate(row):
            qk16, qv16 = keys[i][j][:2]
            with span("engine.read"):
                contexts.append(reps[d].match(qk16, qv16, mem[i][j]))
        with span("engine.decode"):
            masks = _decode_row(sharding, reps, row, contexts, keys[i], act, cols, out_size)
            if inject_mask is None:
                idxs = [m.argmax(dim=-1).to(torch.uint8) for m in masks]
        for j, d in enumerate(row):
            pred_mask, shard_act = masks[j], act.to(d)
            if inject_mask is None:
                pred_idx = idxs[j]
            else:
                with span("engine.inject"):
                    pred_mask, shard_act = _inject(pred_mask, shard_act,
                                                   inject_mask[rows[i]].to(d),
                                                   inject_new[rows[i]].to(d))
                    pred_idx = pred_mask.argmax(dim=-1).to(torch.uint8)
            if j == 0:
                idx_rows.append(pred_idx)
                mask_rows.append(pred_mask)
            if do_memorize:
                qk16, _, s16, _, _, vf = keys[i][j]
                mem[i][j] = memorize_from_pred(reps[d], mem[i][j], frames[i][j],
                                               shard_act[:, cols[j]], qk16, s16, vf, pred_idx,
                                               _slots(pred_mask, cols[j]), slot0=cols[j].start)
    home = active.device
    if sharding.n_data == 1:  # one row: its predictions as they are
        return mem, idx_rows[0].to(home), mask_rows[0].to(home)
    with span("engine.decode"):
        return (mem, torch.cat([t.to(home) for t in idx_rows]),
                torch.cat([t.to(home) for t in mask_rows]))


class _StepGraphs:
    """The frame step of the 1x1 grid at one shape, captured as CUDA graphs
    cut at K2 and K1 (``utils/cuda_graphs.CutGraph``), one per stage span:
    ``engine.read`` replays the memory's gather and the query's flatten,
    calls K2 (``read_affinity``: the keys' l2-norms and the kernel), and
    replays top-l, the concat and the fusion;
    ``engine.decode`` replays the decoder, the aggregation and the argmax;
    ``engine.memorize`` replays the resize, the value encoder, the EM masks
    and the slots' gating, launches K1, and replays the ``nu`` update and
    the memory write.

    The graphs read the tensors ``frame``, ``keys`` (the frame's
    ``encode_frame`` tuple) and ``active``, and the state ``mem``, which the
    memorize graph rewrites; ``step`` copies each frame's inputs into them
    and never rebinds them. The capture follows the runner's eager warm-up
    (cuDNN's algorithms chosen, the tower parameters kept,
    ``models/layers.prepared``) and one eager step on the capture stream,
    which makes K1's grid barrier and cuBLAS's workspace of that stream
    outside the graphs' pool. Stale once a parameter or buffer of the model
    is updated in place or moved (``layers.stamp_of``).
    """

    def __init__(self, model: SWEM, out_size: Tuple[int, int], scores: bool, frame, active,
                 mem: em.VOSMemory, stream):
        grid = EngineSharding.single(model.device)
        reps, row, cols = grid.replicas(model), grid.grid[0], grid.cols(active.shape[-1])
        self.sources = list(model.parameters()) + list(model.buffers())
        self.stamp = stamp_of(self.sources)
        self.scores = scores
        self.frame, self.active = frame.clone(), active.clone()
        self.keys = tuple(k.clone() for k in model.encode_frame(frame))
        self.mem = em.memory_of(t.clone() for t in em.memory_tensors(mem))

        def read():
            return model.match(self.keys[0], self.keys[1], self.mem)

        def decode(context):
            mask, = _decode_row(grid, reps, row, [context], [self.keys], self.active, cols,
                                out_size)
            return mask.argmax(dim=-1).to(torch.uint8), mask

        def memorize(pred_idx, pred_mask):
            qk16, _, s16, _, _, vf = self.keys
            em.copy_memory(self.mem, memorize_from_pred(model, self.mem, self.frame, self.active,
                                                        qk16, s16, vf, pred_idx, pred_mask))

        with cuda_graphs.capturing(stream) as pool:
            memorize(*decode(read()))
            self.read = cuda_graphs.CutGraph(read, pool)
            self.decode = cuda_graphs.CutGraph(lambda: decode(self.read.outputs), pool)
            self.memorize = cuda_graphs.CutGraph(lambda: memorize(*self.decode.outputs), pool)

    def stale(self) -> bool:
        return stamp_of(self.sources) != self.stamp

    def step(self, sharding, reps, mem, frames, keys, active, out_size, do_memorize: bool,
             inject_mask=None, inject_new=None):
        """``_step_shards`` on the 1x1 grid, by replays. The frame, its keys
        and ``active`` are copied into the graphs' tensors, and a memory
        that is not ``mem`` into ``mem``. An injecting frame runs
        ``_inject`` eagerly between the decode's replay and the memorize's,
        into the decode's outputs and ``active``. Returns the grid of
        ``mem`` and the one prediction the runner keeps (``pred_mask`` with
        ``scores``, else ``pred_idx``) copied out of the graph's outputs,
        which the next replay rewrites, the other None."""
        if mem[0][0] is not self.mem:
            em.copy_memory(self.mem, mem[0][0])
        for dst, src in zip((self.frame, self.active) + self.keys,
                            (frames[0][0], active) + tuple(keys[0][0])):
            dst.copy_(src)
        with span("engine.read"):
            self.read.replay()
        with span("engine.decode"):
            self.decode.replay()
        pred_idx, pred_mask = self.decode.outputs
        if inject_mask is not None:
            with span("engine.inject"):
                injected, grown = _inject(pred_mask, self.active, inject_mask, inject_new)
                pred_mask.copy_(injected)
                pred_idx.copy_(injected.argmax(dim=-1).to(torch.uint8))
                self.active.copy_(grown)
        if do_memorize:
            with span("engine.memorize"):
                self.memorize.replay()
        if self.scores:
            return [[self.mem]], None, pred_mask.clone()
        return [[self.mem]], pred_idx.clone(), None


def _to_device(x, device) -> torch.Tensor:
    """A tensor or any host array (numpy views with negative strides, such as
    ``np.flip``'s, included) -> a tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.ascontiguousarray(x), device=device)


def _injection(inject_idx, inject_new, n_slots: int, device):
    """One frame's injected ground truth: the slot-index map (B,Ho,Wo) and
    the newly-appearing slots (B,N) -> (one-hot of the new slots only
    (B,Ho,Wo,N+1) float32, new (B,N) bool), both on ``device``."""
    idx = _to_device(inject_idx, device).long()
    new = _to_device(inject_new, device)
    slots = torch.arange(1, n_slots + 1, device=device)
    new_hot = (idx[..., None] == slots) & new[:, None, None, :]
    return torch.cat([torch.zeros_like(new_hot[..., :1]), new_hot], dim=-1).float(), new


@_entry_point
def run_chunk(model: SWEM, mem, frames, active, out_size: Tuple[int, int], *,
              final: bool = False, scores: bool = False, inject_idx=None, inject_new=None,
              sharding: Optional[EngineSharding] = None
              ) -> Tuple[em.VOSMemory, torch.Tensor, torch.Tensor]:
    """Run a chunk of frames (C,B,H,W,3), carrying the memory and ``active``.

    Returns (mem, preds, active): preds are (C,B,Ho,Wo) uint8 indices or,
    with ``scores``, the stacked pred_mask (C,B,Ho,Wo,N+1) float32; active
    (B,N) is the slot state after the chunk. The chunk's keys are encoded in
    one batched pass. ``final``: the chunk ends the video, so its last frame
    is not memorized (the memory after the video is never read).

    ``inject_idx`` (C,B,Ho,Wo) uint8 slot-index maps + ``inject_new``
    (C,B,N) bool, a host array: objects appearing at a frame take their
    ground truth there and join ``active`` from that frame on. The host
    decides which frames inject, so a frame whose row is all False runs no
    injection op and only an injecting frame's map goes to the device.

    ``sharding``: ``mem`` is a grid of shards; each shard key-encodes its
    rows of the chunk in one batched pass.
    """
    mem, preds, active = _chunk_steps(model, mem, frames, active, out_size, final, scores,
                                      inject_idx, inject_new, sharding)
    return mem, torch.stack(preds), active


def _chunk_steps(model: SWEM, mem, frames, active, out_size, final, scores, inject_idx,
                 inject_new, sharding, step=_step_shards):
    """``run_chunk`` with its predictions left as a list of the frames',
    each frame stepped by ``step`` (``_step_shards``, or a runner's
    ``_StepGraphs.step``)."""
    if (inject_idx is None) != (inject_new is None):
        raise ValueError("run_chunk: inject_idx and inject_new go together")
    new_rows = None if inject_new is None else np.asarray(inject_new, dtype=bool)
    grid = _grid(model, sharding)
    reps = grid.replicas(model)
    with span("engine.encode_keys"):
        shard_frames = [[_per_frame(f, _encode_keys(reps[d], f)) for f, d in zip(fs, row)]
                        for fs, row in zip(_split_rows(grid, frames, active.shape[0], 1),
                                           grid.grid)]
    mem, preds = _as_grid(mem, sharding), []
    for t in range(frames.shape[0]):
        inject, grown = {}, active
        if new_rows is not None and new_rows[t].any():
            with span("engine.inject"):
                inject_mask, new = _injection(inject_idx[t], new_rows[t], active.shape[-1],
                                              frames.device)
                inject, grown = dict(inject_mask=inject_mask, inject_new=new), active | new
        last = final and t == frames.shape[0] - 1
        mem, pred_idx, pred_mask = step(
            grid, reps, mem, [[f[t] for f, _ in row] for row in shard_frames],
            [[k[t] for _, k in row] for row in shard_frames], active, out_size, not last,
            **inject)
        active = grown
        preds.append(pred_mask if scores else pred_idx)
    return _as_given(mem, sharding), preds, active


def _run_video(model: SWEM, generator, frames, init_mask, active, out_size, bases, sharding,
               scores: bool) -> torch.Tensor:
    """``run_video``, or with ``scores`` ``run_video_scores``."""
    mem = init_memory(model, generator, frames[0], init_mask, active, bases=bases,
                      sharding=sharding)
    if frames.shape[0] == 1:
        slots = (init_mask.shape[-1],) if scores else ()
        return torch.zeros((0, frames.shape[1]) + tuple(out_size) + slots,
                           dtype=torch.float32 if scores else torch.uint8, device=frames.device)
    _, preds, _ = run_chunk(model, mem, frames[1:], active, out_size, final=True, scores=scores,
                            sharding=sharding)
    return preds


@_entry_point
def run_video(model: SWEM, generator: Optional[torch.Generator], frames, init_mask, active,
              out_size: Tuple[int, int], *, bases: Optional[em.Bases] = None,
              sharding: Optional[EngineSharding] = None) -> torch.Tensor:
    """Whole-video inference: frames (T,B,H,W,3) -> (T-1,B,Ho,Wo) uint8 for
    frames 1..T-1. Frame 0 and its mask seed the memory; the last frame is
    not memorized. All T-1 frames are key-encoded in one batch, so memory
    grows with T: long videos go through ``ChunkedVideoRunner``."""
    return _run_video(model, generator, frames, init_mask, active, out_size, bases, sharding,
                      scores=False)


@_entry_point
def run_video_scores(model: SWEM, generator: Optional[torch.Generator], frames, init_mask,
                     active, out_size: Tuple[int, int], *,
                     bases: Optional[em.Bases] = None,
                     sharding: Optional[EngineSharding] = None) -> torch.Tensor:
    """``run_video`` returning the soft masks (T-1,B,Ho,Wo,N+1) float32, which
    multi-scale and flip evaluation average before the argmax."""
    return _run_video(model, generator, frames, init_mask, active, out_size, bases, sharding,
                      scores=True)


def ladder_sizes(chunk: int):
    """Descending powers of two below ``chunk``.

    Greedy selection over distinct powers {2^k, ..., 2, 1} covers ANY
    remainder < 2^(k+1) >= chunk (binary representation), so the tail
    decomposition is exact for every chunk size — starting at chunk//2
    would leave gaps for non-power-of-two chunks (chunk=6 -> [3, 1]
    cannot represent remainders 2 or 5).
    """
    s = 1
    while s * 2 < chunk:
        s *= 2
    sizes = []
    while s >= 1:
        sizes.append(s)
        s //= 2
    return sizes


def _graph_key(frame, active) -> tuple:
    """A runner's graphs by the shape they step: one frame (B,H,W,3) as
    preprocessed, and the slot count."""
    return tuple(frame.shape), frame.dtype, active.shape[-1]


def _count_slots(active, injections, T: int) -> None:
    """The slot counters of a runner call, from its host inputs: per frame
    1..T-1, ``engine.slots`` (B x N stepped), ``engine.active_slots`` (those
    live after the frame's injection) and ``engine.injected`` (slots
    injected)."""
    live = np.array(active.cpu() if isinstance(active, torch.Tensor) else active, dtype=bool)
    for t in range(1, T):
        if t in injections:
            new = np.asarray(injections[t][1], dtype=bool)
            if new.any():
                count("engine.injected", int(new.sum()))
                live = live | new
        count("engine.slots", live.size)
        count("engine.active_slots", int(live.sum()))


class ChunkedVideoRunner:
    """Whole-video inference over host frames, in chunks of bounded size.

    Frames 1..T-1 run through ``run_chunk`` in chunks of ``chunk`` frames,
    the remainder through the binary ladder of smaller chunks
    (``ladder_sizes``): no padded frames, and every video uses batch sizes
    from the fixed set {chunk} + ladder, which ``warmup`` runs once. Peak
    device memory is set by the chunk, not by the video's length, since
    each chunk key-encodes its own frames only. The video's last frame is
    not memorized.

    ``scores=True`` returns (T-1,B,Ho,Wo,N+1) float32 soft masks on the
    device; otherwise (T-1,B,Ho,Wo) uint8 indices on the host, fetched once
    at the end. ``preprocess`` maps uploaded frames to the model's input on
    the device (e.g. uint8 -> /255 -> bicubic to the in-size) and takes
    both (B,H,W,3) and (C,B,H,W,3). ``injectable=True`` admits mid-video
    object injection (YouTube-VOS) through ``__call__``'s ``injections``.

    ``mesh`` (``parallel.make_mesh`` or ``make_mesh2``; without one, the
    1x1 grid of the model's device): a 'data' axis shards the video batch,
    each row of the grid carrying its own videos' memory; an 'obj' axis
    shards the object slots (``EngineSharding``), which must divide the
    slot count of every call (``warmup`` and each call raise ``ValueError``
    otherwise; one model serves every slot count, so ``model.cfg.max_objs``
    is not the budget checked). Frames upload to the model's device and go
    to the shards from there; the memory between chunks stays split by slot.

    CUDA graphs: on a CUDA device without a mesh, ``warmup`` also captures
    the frame step at its shape (batch, slot count, input size) as graphs
    cut at K2 and K1 (``_StepGraphs``). Every frame of a call at a warmed
    shape replays them, K1 and K2 launched between the replays, with the
    same bits as the eager step; a call at another shape, over a mesh or on
    the CPU runs eagerly. A call recaptures first where the weights the
    graphs read have changed. The graphs' tensors are the runner's own, so
    calls of one runner must not overlap (from several threads).
    """

    def __init__(self, model: SWEM, out_size: Tuple[int, int], chunk: int = 16,
                 scores: bool = False, preprocess=None, injectable: bool = False, mesh=None):
        self.model = model
        self.out_size = tuple(out_size)
        self.chunk = chunk
        self.scores = scores
        self.injectable = injectable
        self.sharding = None if mesh is None else EngineSharding.of(mesh)
        self._pre = preprocess if preprocess is not None else (lambda f: f)
        self._graphs = {}  # _graph_key -> _StepGraphs
        self._stream: Optional[torch.cuda.Stream] = None

    def _upload(self, frames: np.ndarray) -> torch.Tensor:
        """Host frames -> the model's device, preprocessed."""
        return self._pre(torch.from_numpy(np.ascontiguousarray(frames)).to(self.model.device))

    def _sizes(self, n_frames: int):
        """Chunk sizes covering ``n_frames``: full chunks, then the ladder."""
        sizes = [self.chunk] * (n_frames // self.chunk)
        rest = n_frames % self.chunk
        for s in ladder_sizes(self.chunk):
            if s <= rest:
                sizes.append(s)
                rest -= s
        return sizes

    @_entry_point
    def warmup(self, frame_hw: Tuple[int, int], batch: int, n_slots: int,
               frame_dtype=np.float32) -> None:
        """Run init and every chunk size once on zeros, and fetch the
        predictions, so that no timed call pays a batch size's first-call
        setup (cuDNN's choice of algorithms, kernel loads, allocator
        blocks), on every shard; then capture the frame step at this shape
        (``_capture``). ``frame_hw`` and ``frame_dtype`` describe the raw
        host frames, before ``preprocess``."""
        dev = self.model.device
        f0 = np.zeros((batch,) + tuple(frame_hw) + (3,), frame_dtype)
        mask = torch.zeros((batch,) + self.out_size + (n_slots + 1,), device=dev)
        active = torch.zeros((batch, n_slots), dtype=torch.bool, device=dev)
        mem = init_memory(self.model, torch.Generator().manual_seed(0), self._upload(f0), mask,
                          active, sharding=self.sharding)
        for size in [self.chunk] + ladder_sizes(self.chunk):
            frames = self._upload(np.zeros((size,) + f0.shape, frame_dtype))
            mem, preds, _ = run_chunk(self.model, mem, frames, active, self.out_size,
                                      scores=self.scores, sharding=self.sharding)
            if not self.scores:
                preds.cpu()
        self._capture(self._upload(f0), active, mem)
        for d in _grid(self.model, self.sharding).devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _capture(self, frame, active, mem) -> None:
        """Capture the frame step at ``frame``'s shape (B,H,W,3, as
        preprocessed) and ``active``'s slot count, on a CUDA device without
        a mesh; elsewhere hold no graph. ``mem``: a memory of that shape."""
        if self.sharding is not None or self.model.device.type != "cuda":
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.model.device)
        self._graphs[_graph_key(frame, active)] = _StepGraphs(
            self.model, self.out_size, self.scores, frame, active, mem, self._stream)

    def _step_for(self, frame, active):
        """How a call whose frames are like ``frame`` steps: the graphs
        captured at its shape, recaptured first where they are stale, else
        the eager ``_step_shards``."""
        key = _graph_key(frame, active)
        graphs = self._graphs.get(key)
        if graphs is None:
            return _step_shards
        if graphs.stale():
            graphs = self._graphs[key] = _StepGraphs(self.model, self.out_size, self.scores,
                                                     graphs.frame, graphs.active, graphs.mem,
                                                     self._stream)
        return graphs.step

    def _chunk_injections(self, injections, t: int, size: int, batch: int, n_slots: int):
        """(inject_idx, inject_new) host blocks of frames t..t+size-1, or
        (None, None) when none of them injects."""
        frames = [j for j in range(size) if t + j in injections]
        if not frames:
            return None, None
        with span("engine.inject"):
            idx = np.zeros((size, batch) + self.out_size, np.uint8)
            new = np.zeros((size, batch, n_slots), bool)
            for j in frames:
                idx[j], new[j] = injections[t + j]
            return idx, new

    @_entry_point
    def __call__(self, generator: Optional[torch.Generator], frames, init_mask, active,
                 injections=None, *, bases: Optional[em.Bases] = None):
        """frames (T,B,H,W,3): a HOST array (numpy, commonly uint8); each
        chunk's slice is uploaded once. init_mask (B,Ho,Wo,N+1) and active
        (B,N), the frame-0 state, as host arrays or tensors. ``injections``
        (needs ``injectable=True``): {frame index: (idx_map (B,Ho,Wo) uint8
        slot-index map, new (B,N) bool)} for objects that appear at that
        frame. ``generator`` or ``bases`` seed the memory, as in
        ``init_memory``.

        Returns the predictions of frames 1..T-1 (see the class docstring).
        """
        if isinstance(frames, torch.Tensor):
            raise TypeError("ChunkedVideoRunner wants HOST frames (numpy): a tensor would go "
                            "device -> host -> device; pass frames.cpu().numpy() if that is "
                            "really intended")
        if injections and not self.injectable:
            raise ValueError("injections require ChunkedVideoRunner(injectable=True)")
        with request("engine.video"):
            return self._run(generator, frames, init_mask, active, injections or {}, bases)

    def _run(self, generator, frames, init_mask, active, injections, bases):
        dev = self.model.device
        with span("engine.upload"):
            frames = np.asarray(frames)
            T, B = frames.shape[:2]
            init_mask = _to_device(init_mask, dev)
            if tracing():
                _count_slots(active, injections, T)
            active = _to_device(active, dev)
            frame0 = self._upload(frames[0])
        step = self._step_for(frame0, active)
        if tracing():
            count("engine.steps", T - 1)
            if step is not _step_shards:
                count("engine.graph_steps", T - 1)
        mem = init_memory(self.model, generator, frame0, init_mask, active, bases=bases,
                          sharding=self.sharding)
        preds, t = [], 1
        for size in self._sizes(T - 1):
            inject_idx, inject_new = self._chunk_injections(injections, t, size, B,
                                                            active.shape[-1])
            with span("engine.upload"):
                chunk = self._upload(frames[t:t + size])
            mem, p, active = _chunk_steps(self.model, mem, chunk, active, self.out_size,
                                          t + size == T, self.scores, inject_idx, inject_new,
                                          self.sharding, step)
            preds += p
            t += size
        # one stack of every frame's prediction and, for indices, one fetch
        with span("engine.fetch"):
            if self.scores:
                if not preds:
                    return torch.zeros((0, B) + self.out_size + (init_mask.shape[-1],),
                                       device=dev)
                return torch.stack(preds)
            if not preds:
                return np.zeros((0, B) + self.out_size, np.uint8)
            return torch.stack(preds).cpu().numpy()
