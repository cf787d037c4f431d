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

Object parallelism: ``init_memory``, ``step``, ``run_chunk``, ``run_video``
and ``run_video_scores`` take ``sharding=`` (``parallel.EngineSharding``).
The memory is then the grid ``mem[i][j]`` of its shards (batch rows i,
object slots j). Each shard key-encodes its rows' frames, reads its slots'
memory (K2) and decodes its slots; each grid row's per-object probabilities
go, as exact copies, to every shard of the row, where the soft aggregation
and the injection run; each shard then value-encodes and memorizes its
slots (K1). Predictions come from column 0 of each row, joined over the
rows on the device of ``active``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from swem_tpu_torch.config import full_float32, no_grad
from swem_tpu_torch.models import em
from swem_tpu_torch.models.swem import (
    SWEM,
    aggregate,
    prepare_em_masks,
    prepare_em_masks_from_idx,
)
from swem_tpu_torch.ops.resize import resize
from swem_tpu_torch.parallel.mesh import EngineSharding


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
    cfg = model.cfg
    if sharding is not None:
        if bases is None:
            bases = em.init_bases(generator, 1, init_mask.shape[-1] - 1, cfg.keydim, cfg.valdim,
                                  cfg.num_bases)
        reps = sharding.replicas(model)
        rows, cols = sharding.rows(active.shape[0]), sharding.cols(active.shape[1])
        split = sharding.split_bases(bases, active.shape[0])
        return [[init_memory(reps[d], None, frame0[rows[i]].to(d),
                             _slots(init_mask[rows[i]], cols[j]).to(d),
                             active[rows[i], cols[j]].to(d), bases=split[i][j])
                 for j, d in enumerate(sharding.grid[i])] for i in range(sharding.n_data)]
    qk16, _, s16, _, _ = model.encode_key(frame0)
    init_mask_in = resize(init_mask.float(), tuple(frame0.shape[1:3]), "nearest")
    mv16 = model.encode_value(frame0, init_mask_in, s16)
    B, _, h, w = qk16.shape
    if bases is None:
        bases = em.init_bases(generator, 1, init_mask.shape[-1] - 1, cfg.keydim, cfg.valdim,
                              cfg.num_bases)
    mem = em.fresh_memory(bases.to(model.device).expand(B))
    em_masks = prepare_em_masks(init_mask, init_mask.float(), (h, w))
    return em.memorize(mem, _flat_qk(qk16), _flat_mv(mv16), em_masks, active,
                       n_iters=cfg.num_em_iters, tau=cfg.em_tau)


@_entry_point
def encode_keys_batched(model: SWEM, frames):
    """Key-encode a frame stack in one batched pass: (T,B,H,W,3) -> tuple of (T,B,...)."""
    T, B = frames.shape[:2]
    keys = model.encode_frame(frames.reshape((T * B,) + frames.shape[2:]))
    return tuple(k.reshape((T, B) + k.shape[1:]) for k in keys)


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
    if sharding is not None:
        reps = sharding.replicas(model)
        frames = _split_rows(sharding, frame, active.shape[0], 0)
        return _step_shards(sharding, reps, mem, frames, keys, active, out_size, do_memorize,
                            inject_mask, inject_new)
    if keys is None:
        keys = model.encode_frame(frame)
    qk16, qv16, s16, skip8, skip4, vf = keys
    context = model.match(qk16, qv16, mem)
    _, pred_mask = model.decode(context, skip8, skip4, active.float(), out_size)

    if inject_mask is not None:
        pred_mask, active = _inject(pred_mask, active, inject_mask, inject_new)

    pred_idx = pred_mask.argmax(dim=-1).to(torch.uint8)
    if do_memorize:
        mem = memorize_from_pred(model, mem, frame, active, qk16, s16, vf, pred_idx, pred_mask)
    return mem, pred_idx, pred_mask


def memorize_from_pred(model: SWEM, mem, frame, active, qk16, s16, vf, pred_idx, pred_mask,
                       slot0: int = 0):
    """Value-encode the predicted mask and EM-update the memory. An object
    shard passes its channels of ``pred_mask`` (background and its slots,
    the first being slot ``slot0 + 1`` of ``pred_idx``)."""
    cfg = model.cfg
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


def _step_shards(sharding: EngineSharding, reps: dict, mem, frames, keys, active,
                 out_size: Tuple[int, int], do_memorize: bool, inject_mask=None,
                 inject_new=None):
    """``step`` over the grid: ``frames`` and ``keys`` (or None) are grids of
    each shard's (B/n_data, ...) inputs on its device; ``active`` and the
    injection are whole, on one device."""
    B, N = active.shape
    rows, cols = sharding.rows(B), sharding.cols(N)
    if keys is None:
        keys = [[reps[d].encode_frame(frames[i][j]) for j, d in enumerate(sharding.grid[i])]
                for i in range(sharding.n_data)]
    probs = [[None] * sharding.n_obj for _ in range(sharding.n_data)]
    for i, j, d in sharding.shards():
        qk16, qv16, _, skip8, skip4, _ = keys[i][j]
        context = reps[d].match(qk16, qv16, mem[i][j])
        probs[i][j] = reps[d].decode_objects(context, skip8, skip4,
                                             active[rows[i], cols[j]].to(d).float(), out_size)
    mem = [list(row) for row in mem]
    idx_rows, mask_rows = [], []
    for i, j, d in sharding.shards():
        # the one gather per frame: every shard of row i takes its objects
        logits = aggregate(sharding.gather_objects(probs[i], d))
        pred_mask = torch.softmax(logits, dim=-1)
        act = active[rows[i]].to(d)
        if inject_mask is not None:
            pred_mask, act = _inject(pred_mask, act, inject_mask[rows[i]].to(d),
                                     inject_new[rows[i]].to(d))
        pred_idx = pred_mask.argmax(dim=-1).to(torch.uint8)
        if j == 0:
            idx_rows.append(pred_idx)
            mask_rows.append(pred_mask)
        if do_memorize:
            qk16, _, s16, _, _, vf = keys[i][j]
            mem[i][j] = memorize_from_pred(reps[d], mem[i][j], frames[i][j], act[:, cols[j]],
                                           qk16, s16, vf, pred_idx, _slots(pred_mask, cols[j]),
                                           slot0=cols[j].start)
    home = active.device
    return (mem, torch.cat([t.to(home) for t in idx_rows]),
            torch.cat([t.to(home) for t in mask_rows]))


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
    if (inject_idx is None) != (inject_new is None):
        raise ValueError("run_chunk: inject_idx and inject_new go together")
    new_rows = None if inject_new is None else np.asarray(inject_new, dtype=bool)
    if sharding is None:
        keys = encode_keys_batched(model, frames)
    else:
        reps = sharding.replicas(model)
        shard_frames = _split_rows(sharding, frames, active.shape[0], 1)
        shard_keys = [[encode_keys_batched(reps[d], f) for f, d in zip(fs, sharding.grid[i])]
                      for i, fs in enumerate(shard_frames)]
    preds = []
    for t in range(frames.shape[0]):
        inject = {}
        if new_rows is not None and new_rows[t].any():
            inject_mask, new = _injection(inject_idx[t], new_rows[t], active.shape[-1],
                                          frames.device)
            inject = dict(inject_mask=inject_mask, inject_new=new)
        last = final and t == frames.shape[0] - 1
        if sharding is None:
            mem, pred_idx, pred_mask = step(model, mem, frames[t], active, out_size,
                                            do_memorize=not last,
                                            keys=tuple(k[t] for k in keys), **inject)
        else:
            mem, pred_idx, pred_mask = _step_shards(
                sharding, reps, mem, [[f[t] for f in fs] for fs in shard_frames],
                [[tuple(k[t] for k in ks) for ks in row] for row in shard_keys], active,
                out_size, not last, **inject)
        if inject:
            active = active | inject["inject_new"]
        preds.append(pred_mask if scores else pred_idx)
    return mem, torch.stack(preds), active


@_entry_point
def run_video(model: SWEM, generator: Optional[torch.Generator], frames, init_mask, active,
              out_size: Tuple[int, int], *, bases: Optional[em.Bases] = None,
              sharding: Optional[EngineSharding] = None) -> torch.Tensor:
    """Whole-video inference: frames (T,B,H,W,3) -> (T-1,B,Ho,Wo) uint8 for
    frames 1..T-1. Frame 0 and its mask seed the memory; the last frame is
    not memorized. All T-1 frames are key-encoded in one batch, so memory
    grows with T: long videos go through ``ChunkedVideoRunner``."""
    mem = init_memory(model, generator, frames[0], init_mask, active, bases=bases,
                      sharding=sharding)
    T, B = frames.shape[:2]
    if T == 1:
        return torch.zeros((0, B) + tuple(out_size), dtype=torch.uint8, device=frames.device)
    _, preds, _ = run_chunk(model, mem, frames[1:], active, out_size, final=True,
                            sharding=sharding)
    return preds


@_entry_point
def run_video_scores(model: SWEM, generator: Optional[torch.Generator], frames, init_mask,
                     active, out_size: Tuple[int, int], *,
                     bases: Optional[em.Bases] = None,
                     sharding: Optional[EngineSharding] = None) -> torch.Tensor:
    """``run_video`` returning the soft masks (T-1,B,Ho,Wo,N+1) float32, which
    multi-scale and flip evaluation average before the argmax."""
    mem = init_memory(model, generator, frames[0], init_mask, active, bases=bases,
                      sharding=sharding)
    T, B = frames.shape[:2]
    if T == 1:
        return torch.zeros((0, B) + tuple(out_size) + (init_mask.shape[-1],),
                           dtype=torch.float32, device=frames.device)
    _, scores, _ = run_chunk(model, mem, frames[1:], active, out_size, final=True, scores=True,
                             sharding=sharding)
    return scores


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

    ``mesh`` (``parallel.make_mesh`` or ``make_mesh2``): a 'data' axis
    shards the video batch, each row of the grid carrying its own videos'
    memory; an 'obj' axis shards the object slots (``EngineSharding``),
    which must divide the slot count of every call (``warmup`` and each
    call raise ``ValueError`` otherwise; one model serves every slot count,
    so ``model.cfg.max_objs`` is not the budget checked). Frames upload to the model's device and go to the shards from
    there; the memory between chunks stays split by slot.
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
        blocks), on every shard. ``frame_hw`` and ``frame_dtype`` describe
        the raw host frames, before ``preprocess``."""
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
        devices = [dev] if self.sharding is None else self.sharding.devices
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _chunk_injections(self, injections, t: int, size: int, batch: int, n_slots: int):
        """(inject_idx, inject_new) host blocks of frames t..t+size-1, or
        (None, None) when none of them injects."""
        frames = [j for j in range(size) if t + j in injections]
        if not frames:
            return None, None
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
        injections = injections or {}
        frames = np.asarray(frames)
        dev = self.model.device
        T, B = frames.shape[:2]
        init_mask = _to_device(init_mask, dev)
        active = _to_device(active, dev)
        mem = init_memory(self.model, generator, self._upload(frames[0]), init_mask, active,
                          bases=bases, sharding=self.sharding)
        preds, t = [], 1
        for size in self._sizes(T - 1):
            inject_idx, inject_new = self._chunk_injections(injections, t, size, B,
                                                            active.shape[-1])
            mem, p, active = run_chunk(self.model, mem, self._upload(frames[t:t + size]), active,
                                       self.out_size, final=t + size == T, scores=self.scores,
                                       inject_idx=inject_idx, inject_new=inject_new,
                                       sharding=self.sharding)
            preds.append(p)
            t += size
        if self.scores:
            if not preds:
                return torch.zeros((0, B) + self.out_size + (init_mask.shape[-1],), device=dev)
            return torch.cat(preds)
        if not preds:
            return np.zeros((0, B) + self.out_size, np.uint8)
        return torch.cat(preds).cpu().numpy()
