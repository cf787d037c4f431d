"""Online streaming inference, counterpart of ``swem_tpu/serve.py``.

A deployed VOS system receives frames one at a time (a camera feed, a
video call) and answers each with bounded latency. ``StreamingSession``
wraps the engine into a stateful session with that contract:

* ``start(frame0, init_mask)`` seeds the EM memory from the annotated
  first frame;
* ``push(frame)`` segments one new frame and folds it into the fixed-size
  memory: O(1) state, any stream length;
* ``add_objects(frame, mask, new_ids)`` injects objects mid-stream (the
  YouTube-VOS protocol);
* ``grow(n_slots)`` raises the slot budget mid-stream, and
  ``prepare_grow(n_slots)`` warms the grown shapes on a background thread
  beforehand.

Frames upload as uint8 and are normalized on the device; predictions
return to the host as uint8 index maps. The session runs in
``ModelConfig.dtype`` on CUDA unless given ``device="cpu"``.

Random draws: the initial prototypes come from ``torch.Generator().
manual_seed(seed)``, so ``start`` draws the same bases for the same seed on
every device (``models/em.py::init_bases`` draws on the CPU). ``grow``'s
draw for the new slots is seeded from ``(seed, frames_seen)`` through
``numpy.random.SeedSequence``, the role ``jax.random.fold_in(key,
frames_seen)`` plays in the JAX package. ``start`` and ``grow`` take
``bases`` to use a given draw instead (the JAX package's, in the parity
tests).

Object parallelism: ``mesh`` (``parallel.make_mesh2``) splits the slots
over its 'obj' axis (``parallel.EngineSharding``), the one parallelism a
single stream can use: each shard reads, decodes, value-encodes and
memorizes its own slots, with one gather of the objects per frame. The
memory stays split by slot between frames; ``grow`` joins it, pads it and
splits it again over the grown budget, which the axis must divide.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from swem_tpu_torch import engine
from swem_tpu_torch.config import ModelConfig
from swem_tpu_torch.data.davis_test import to_onehot
from swem_tpu_torch.models import em
from swem_tpu_torch.models.swem import SWEM
from swem_tpu_torch.ops.resize import resize
from swem_tpu_torch.parallel.mesh import EngineSharding
from swem_tpu_torch.utils.profiling import device_busy_seconds


def _check_uint8(frame, where: str) -> None:
    dtype = np.asarray(frame).dtype
    if dtype != np.uint8:
        raise TypeError(f"{where}() wants uint8 frames (got {dtype}): the on-device "
                        "preprocess divides by 255, so pre-normalized floats would yield "
                        "near-black inputs")


class _PreparedGrowth:
    """A ``prepare_grow`` warm-up running on its own thread."""

    def __init__(self, n_slots: int, work):
        self.n_slots = n_slots
        self.error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, args=(work,), daemon=True)
        self.thread.start()

    def _run(self, work) -> None:
        try:
            work()
        except Exception as e:  # noqa: BLE001 — raised by join(), from grow()
            self.error = e

    def join(self) -> None:
        """Wait for the warm-up; raise its failure."""
        self.thread.join()
        if self.error is not None:
            raise RuntimeError(f"prepare_grow({self.n_slots}) failed on its thread") \
                from self.error


class StreamingSession:
    """One live video stream: per-frame segmentation with persistent memory.

    Frames are (H, W, 3) uint8 RGB, resized on the device from their own
    size to ``in_size`` (bicubic) where the two differ; ``raw_hw`` is the
    capture size that ``warmup`` prepares for. Predictions are (Ho, Wo)
    uint8 label maps at ``out_size``. ``state_dict`` is the port model's
    (for example from ``io/jax_import.py::jax_to_state_dict``). With a
    ``mesh`` whose 'obj' axis divides ``n_slots``, the model lives on its
    first device unless ``device`` says otherwise.
    """

    def __init__(self, model_cfg: ModelConfig, state_dict, *, raw_hw: Tuple[int, int],
                 in_size: Tuple[int, int], out_size: Tuple[int, int],
                 n_slots: Optional[int] = None, seed: int = 0, device=None, mesh=None):
        n_slots = n_slots or model_cfg.max_objs
        self._esh = None if mesh is None else EngineSharding(mesh)
        if self._esh is not None:
            if n_slots % self._esh.n_obj:
                raise ValueError(f"max_objs={n_slots} not divisible by the mesh 'obj' axis "
                                 f"({self._esh.n_obj})")
            device = self._esh.device(0, 0) if device is None else device
        self.cfg = dataclasses.replace(model_cfg, max_objs=n_slots)
        # the parameters do not depend on the slot budget: one model serves
        # every budget ``grow`` reaches, and the session hands the engine
        # its own bases, so ``cfg.max_objs`` of the model is never read
        self.model = SWEM(self.cfg, device)
        self.model.load_state_dict(state_dict)
        self.device = self.model.device
        self.raw_hw = tuple(raw_hw)
        self.in_size = tuple(in_size)
        self.out_size = tuple(out_size)
        self.n_slots = n_slots
        self.seed = seed
        self._mem: Optional[em.VOSMemory] = None
        self._active: Optional[torch.Tensor] = None
        self._frame_count = 0
        self._prepared: Optional[_PreparedGrowth] = None

    # ------------------------------------------------------------------ #
    def _pre(self, frame) -> torch.Tensor:
        """uint8 (H,W,3) on the host -> normalized float32 (1,h,w,3) at in_size."""
        f = torch.from_numpy(np.ascontiguousarray(frame)[None]).to(self.device).float() / 255.0
        if tuple(f.shape[1:3]) != self.in_size:
            f = resize(f, self.in_size, "bicubic")
        return f

    def _draw(self, seed: int, n_slots: int) -> em.Bases:
        cfg = self.cfg
        return em.init_bases(torch.Generator().manual_seed(seed), 1, n_slots, cfg.keydim,
                             cfg.valdim, cfg.num_bases)

    def _warm(self, n_slots: int) -> None:
        """Init, step and inject once on zeros at ``n_slots``, fetching each
        prediction: the first call at a shape pays cuDNN's choice of
        algorithms, kernel loads and allocator blocks here, not in a frame."""
        f = self._pre(np.zeros(self.raw_hw + (3,), np.uint8))
        mask = torch.zeros((1,) + self.out_size + (n_slots + 1,), device=self.device)
        active = torch.zeros((1, n_slots), dtype=torch.bool, device=self.device)
        mem = engine.init_memory(self.model, None, f, mask, active,
                                 bases=self._draw(0, n_slots), sharding=self._esh)
        mem, pred, _ = engine.step(self.model, mem, f, active, self.out_size,
                                   sharding=self._esh)
        pred.cpu()
        _, pred, _ = engine.step(self.model, mem, f, active, self.out_size,
                                 inject_mask=mask, inject_new=active, sharding=self._esh)
        pred.cpu()

    def _require_started(self) -> None:
        if self._mem is None:
            raise RuntimeError("call start() first")

    # ------------------------------------------------------------------ #
    def warmup(self) -> None:
        """Run every path once on zeros so that no frame pays a first call."""
        self._warm(self.n_slots)

    def start(self, frame0: np.ndarray, init_mask: np.ndarray, *,
              bases: Optional[em.Bases] = None) -> None:
        """Seed the memory. frame0 (H,W,3) uint8; init_mask (Ho,Wo) uint8
        labels (0 = background, 1..n = objects; ids beyond the slot budget
        drop to background)."""
        _check_uint8(frame0, "start")
        labels = np.asarray(init_mask)
        onehot = to_onehot(labels, self.n_slots + 1)
        active = np.zeros((1, self.n_slots), bool)
        present = np.unique(labels)
        for obj in present[(present > 0) & (present <= self.n_slots)]:
            active[0, obj - 1] = True
        if bases is None:
            bases = self._draw(self.seed, self.n_slots)
        self._active = torch.from_numpy(active).to(self.device)
        self._mem = engine.init_memory(
            self.model, None, self._pre(frame0), torch.from_numpy(onehot[None]).to(self.device),
            self._active, bases=bases, sharding=self._esh)
        self._frame_count = 1

    def push(self, frame: np.ndarray) -> np.ndarray:
        """Segment one frame and update the memory. Returns (Ho,Wo) uint8."""
        self._require_started()
        _check_uint8(frame, "push")
        self._mem, pred, _ = engine.step(self.model, self._mem, self._pre(frame), self._active,
                                         self.out_size, sharding=self._esh)
        self._frame_count += 1
        return pred.cpu().numpy()[0]

    def add_objects(self, frame: np.ndarray, mask: np.ndarray, new_ids) -> np.ndarray:
        """Mid-stream object injection (YouTube-VOS protocol). ``mask`` is a
        (Ho,Wo) uint8 label map holding the new objects; ``new_ids`` are
        their label values. Returns (Ho,Wo) uint8."""
        self._require_started()
        _check_uint8(frame, "add_objects")
        onehot = to_onehot(np.asarray(mask), self.n_slots + 1)
        new = np.zeros((1, self.n_slots), bool)
        for obj in new_ids:
            if not 1 <= obj <= self.n_slots:
                raise ValueError(f"object id {obj} is outside the slot budget 1..{self.n_slots}")
            new[0, obj - 1] = True
        new_t = torch.from_numpy(new).to(self.device)
        self._mem, pred, _ = engine.step(
            self.model, self._mem, self._pre(frame), self._active, self.out_size,
            inject_mask=torch.from_numpy(onehot[None]).to(self.device), inject_new=new_t,
            sharding=self._esh)
        self._active = self._active | new_t
        self._frame_count += 1
        return pred.cpu().numpy()[0]

    def _check_growable(self, n_slots: int) -> None:
        if n_slots <= self.n_slots:
            raise ValueError(f"grow({n_slots}) needs more than the current {self.n_slots} slots "
                             "(shrinking would discard fitted objects)")
        if self._esh is not None and n_slots % self._esh.n_obj:
            raise ValueError(f"n_slots={n_slots} not divisible by the mesh 'obj' axis "
                             f"({self._esh.n_obj})")

    def prepare_grow(self, n_slots: int) -> None:
        """Warm ``n_slots``'s init, step and inject on zeros on a background
        thread, on the default stream, while the stream goes on; a later
        ``grow(n_slots)`` joins it. The warm-up's launches interleave with
        live pushes on the device. An earlier prepared warm-up is joined
        first."""
        self._check_growable(n_slots)
        if self._prepared is not None:
            self._prepared.join()
        self._prepared = _PreparedGrowth(n_slots, lambda: self._warm(n_slots))

    def grow(self, n_slots: int, *, bases: Optional[em.Bases] = None) -> None:
        """Raise the slot budget mid-stream.

        The carried slots keep their bases bit for bit; the new slots take a
        fresh draw (seeded from ``(seed, frames_seen)``, or the new slots of
        ``bases``, a (1, n_slots, ...) draw) and stay inactive until
        ``add_objects`` names them. Inactive slots are exact EM no-ops, so
        growth alone leaves the stream's predictions unchanged. If
        ``prepare_grow(n_slots)`` ran, its thread is joined here and its
        failure raised; a prepared warm-up of another size is kept for a
        later ``grow`` to that size.
        """
        self._require_started()
        self._check_growable(n_slots)
        if self._prepared is not None and self._prepared.n_slots == n_slots:
            prepared, self._prepared = self._prepared, None
            prepared.join()
        if bases is None:
            seq = np.random.SeedSequence((self.seed, self._frame_count))
            bases = self._draw(int(seq.generate_state(1, np.uint64)[0]), n_slots)
        old, B = self.n_slots, self._active.shape[0]
        fresh = bases.to(self.device)

        def pad(carried, drawn):
            new_part = drawn[:, old:]
            return torch.cat([carried, new_part.expand((B,) + new_part.shape[1:])], dim=1)

        def pad_bases(b: em.Bases) -> em.Bases:
            return em.Bases(pad(b.kappa, fresh.kappa), pad(b.nu, fresh.nu),
                            pad(b.zita, fresh.zita))

        grown = torch.zeros((B, n_slots - old), dtype=torch.bool, device=self.device)
        mem = self._mem if self._esh is None else self._esh.join_memory(self._mem, self.device)
        mem = em.VOSMemory(first=pad_bases(mem.first), update=pad_bases(mem.update),
                           obj_seen=torch.cat([mem.obj_seen, grown], dim=1),
                           mem_count=mem.mem_count)
        self._mem = mem if self._esh is None else self._esh.split_memory(mem)
        self._active = torch.cat([self._active, grown], dim=1)
        self.cfg = dataclasses.replace(self.cfg, max_objs=n_slots)
        self.n_slots = n_slots

    @property
    def frames_seen(self) -> int:
        return self._frame_count


def measure_latency(session: StreamingSession, frame0, init_mask, frames,
                    percentiles=(50, 90, 99)) -> dict:
    """Per-frame online latency (ms) over a frame sequence: wall time of each
    ``push``, which ends with its map on the host (the serving contract:
    the caller needs the mask before the next frame). ``warmup`` and
    ``start`` are not timed."""
    session.warmup()
    session.start(frame0, init_mask)
    lat = []
    for f in frames:
        t0 = time.perf_counter()
        session.push(f)
        lat.append((time.perf_counter() - t0) * 1e3)
    out = {f"p{p}": float(np.percentile(lat, p)) for p in percentiles}
    out["mean"] = float(np.mean(lat))
    return out


def measure_device_latency(session: StreamingSession, frame0, init_mask, frames) -> float:
    """The device's busy ms per ``push``: the union of the CUDA kernels'
    intervals in a ``torch.profiler`` run over the pushes, divided by the
    number of frames.

    This is the time the card itself spends answering one push, without the
    host's dispatch gaps and the transfers, i.e. the floor a faster host
    approaches; ``measure_latency``'s wall percentiles sit above it. CUDA
    events around a push would time the device's whole timeline, idle gaps
    included. Raises RuntimeError when no kernel was recorded (on the CPU).
    """
    from torch.profiler import ProfilerActivity, profile

    session.warmup()
    session.start(frame0, init_mask)
    activities = [ProfilerActivity.CPU]
    if session.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for f in frames:
            session.push(f)
    return device_busy_seconds(prof) * 1e3 / len(frames)
