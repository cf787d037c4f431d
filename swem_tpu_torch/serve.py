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

CUDA graphs: ``warmup`` on a CUDA device without a mesh captures one push
at the session's shapes (``_PushGraph``): the frame's upload from a pinned
staging buffer, the /255 and bicubic, ``engine.step`` and the map's copy
into a pinned host buffer. While the session holds that graph, a push of a
``raw_hw`` frame replays it, with no Python between its kernels; every other
push, ``start`` and ``add_objects`` run eagerly and write their memory into
the graph's state tensors. A session on the CPU or over a mesh holds no
graph. ``grow`` captures the grown slot count, and a push recaptures first
where the weights the graph reads have changed.

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
from swem_tpu_torch.models.em import (
    copy_memory as _copy_memory,
    memory_of as _memory,
    memory_tensors as _memory_tensors,
)
from swem_tpu_torch.models.layers import stamp_of
from swem_tpu_torch.models.swem import SWEM
from swem_tpu_torch.ops.resize import resize
from swem_tpu_torch.parallel.mesh import EngineSharding
from swem_tpu_torch.utils.profiling import count, device_busy_seconds, request, span


def _check_uint8(frame, where: str) -> None:
    dtype = np.asarray(frame).dtype
    if dtype != np.uint8:
        raise TypeError(f"{where}() wants uint8 frames (got {dtype}): the on-device "
                        "preprocess divides by 255, so pre-normalized floats would yield "
                        "near-black inputs")


class _PushGraph:
    """One push captured as a CUDA graph at the session's shapes.

    The graph reads a pinned uint8 staging buffer and its own state tensors
    (``mem``: both banks, ``obj_seen``, ``mem_count``; ``active``), which
    the session updates in place and never rebinds. It uploads the frame,
    runs the /255 and bicubic and ``engine.step``, writes the new memory
    into ``mem`` and copies the map into the pinned ``fetched``. A replay
    launches nothing from the host: K1's and K2's ``launches`` count the
    capture's launch, and the card runs the graph's copy on each replay.

    The capture follows the session's eager warm-up, which chose cuDNN's
    algorithms and made the kept parameters (``models/layers.prepared``),
    and one eager push on the capture stream, which makes K1's grid barrier
    and cuBLAS's workspace of that stream: nothing is allocated for them
    in the graph's pool. The graph is stale once a parameter or buffer of
    the model is updated in place or moved (``load_state_dict``, an
    optimizer step, ``.to``): their versions and data pointers are
    stamped at the capture.
    """

    def __init__(self, session: "StreamingSession", stream: torch.cuda.Stream):
        dev, model, n_slots = session.device, session.model, session.n_slots
        self.sources = list(model.parameters()) + list(model.buffers())
        self.stamp = stamp_of(self.sources)
        # fresh_memory's banks share their tensors: each state tensor owns its own
        fresh = em.fresh_memory(session._draw(0, n_slots).to(dev))
        self.mem = _memory(t.clone() for t in _memory_tensors(fresh))
        self.active = torch.zeros((1, n_slots), dtype=torch.bool, device=dev)
        self.staging = torch.zeros(session.raw_hw + (3,), dtype=torch.uint8, pin_memory=True)
        self.fetched = torch.empty(session.out_size, dtype=torch.uint8, pin_memory=True)
        self.staging_np, self.fetched_np = self.staging.numpy(), self.fetched.numpy()

        def push():
            f = session._normalize(self.staging[None].to(dev, non_blocking=True))
            return engine.step(model, self.mem, f, self.active, session.out_size)

        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            push()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream):
            mem, pred, _ = push()
            _copy_memory(self.mem, mem)
            self.fetched.copy_(pred[0], non_blocking=True)
        self.outputs = mem, pred  # the pool's blocks the replays write

    def stale(self) -> bool:
        return stamp_of(self.sources) != self.stamp


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
        self._graph: Optional[_PushGraph] = None
        self._stream: Optional[torch.cuda.Stream] = None

    # ------------------------------------------------------------------ #
    def _pre(self, frame) -> torch.Tensor:
        """uint8 (H,W,3) on the host -> normalized float32 (1,h,w,3) at in_size."""
        return self._normalize(torch.from_numpy(np.ascontiguousarray(frame)[None]).to(self.device))

    def _normalize(self, frame: torch.Tensor) -> torch.Tensor:
        """uint8 (1,H,W,3) on the device -> float32 in [0, 1], bicubic to in_size."""
        f = frame.float() / 255.0
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

    def _capture(self) -> None:
        """Capture the push at the current slot count, on a CUDA device
        without a mesh, and carry the stream's state into the graph's
        tensors; elsewhere hold no graph. A prepared grow's thread is
        waited for first: a capture fails on another thread's
        allocations."""
        self._graph = None
        if self.device.type != "cuda" or self._esh is not None:
            return
        if self._prepared is not None:
            self._prepared.thread.join()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        self._graph = _PushGraph(self, self._stream)
        if self._mem is not None:
            self._set_state(self._mem, self._active)

    def _set_state(self, mem, active: torch.Tensor) -> None:
        """Make (mem, active) the stream's state: copied into the graph's
        tensors while the session holds a graph, else bound."""
        if self._graph is not None:
            _copy_memory(self._graph.mem, mem)
            self._graph.active.copy_(active)
            mem, active = self._graph.mem, self._graph.active
        self._mem, self._active = mem, active

    # ------------------------------------------------------------------ #
    def warmup(self) -> None:
        """Run every path once on zeros so that no frame pays a first call;
        then, on a CUDA device without a mesh, capture the push as a CUDA
        graph that later pushes replay."""
        self._warm(self.n_slots)
        self._capture()

    def start(self, frame0: np.ndarray, init_mask: np.ndarray, *,
              bases: Optional[em.Bases] = None) -> None:
        """Seed the memory. frame0 (H,W,3) uint8; init_mask (Ho,Wo) uint8
        labels (0 = background, 1..n = objects; ids beyond the slot budget
        drop to background)."""
        _check_uint8(frame0, "start")
        with request("serve.start"):
            with span("serve.upload"):
                labels = np.asarray(init_mask)
                onehot = to_onehot(labels, self.n_slots + 1)
                active = np.zeros((1, self.n_slots), bool)
                present = np.unique(labels)
                for obj in present[(present > 0) & (present <= self.n_slots)]:
                    active[0, obj - 1] = True
                if bases is None:
                    bases = self._draw(self.seed, self.n_slots)
                active_t = torch.from_numpy(active).to(self.device)
                f0 = self._pre(frame0)
                mask = torch.from_numpy(onehot[None]).to(self.device)
            mem = engine.init_memory(self.model, None, f0, mask, active_t, bases=bases,
                                     sharding=self._esh)
            self._set_state(mem, active_t)
        self._frame_count = 1

    def push(self, frame: np.ndarray) -> np.ndarray:
        """Segment one frame and update the memory. Returns (Ho,Wo) uint8,
        a fresh array."""
        self._require_started()
        _check_uint8(frame, "push")
        with request("serve.push"):
            count("serve.pushes")
            if self._graph is not None and np.shape(frame) == self.raw_hw + (3,):
                return self._replay(frame)
            with span("serve.upload"):
                f = self._pre(frame)
            mem, pred, _ = engine.step(self.model, self._mem, f, self._active, self.out_size,
                                       sharding=self._esh)
            self._set_state(mem, self._active)
            self._frame_count += 1
            with span("serve.fetch"):
                return pred.cpu().numpy()[0]

    def _replay(self, frame: np.ndarray) -> np.ndarray:
        """``push`` as one replay of the captured graph, recaptured first
        where the weights it reads have changed; the map is copied out of
        the pinned buffer, which the next replay overwrites."""
        if self._graph.stale():
            self._capture()
        g = self._graph
        with span("serve.upload"):
            np.copyto(g.staging_np, frame)
        with span("serve.replay"):
            g.graph.replay()
        count("serve.graph_replays")
        self._frame_count += 1
        with span("serve.fetch"):
            torch.cuda.current_stream(self.device).synchronize()
            return g.fetched_np.copy()

    def add_objects(self, frame: np.ndarray, mask: np.ndarray, new_ids) -> np.ndarray:
        """Mid-stream object injection (YouTube-VOS protocol). ``mask`` is a
        (Ho,Wo) uint8 label map holding the new objects; ``new_ids`` are
        their label values. Returns (Ho,Wo) uint8."""
        self._require_started()
        _check_uint8(frame, "add_objects")
        new = np.zeros((1, self.n_slots), bool)
        for obj in new_ids:
            if not 1 <= obj <= self.n_slots:
                raise ValueError(f"object id {obj} is outside the slot budget 1..{self.n_slots}")
            new[0, obj - 1] = True
        with request("serve.add_objects"):
            with span("serve.upload"):
                onehot = to_onehot(np.asarray(mask), self.n_slots + 1)
                new_t = torch.from_numpy(new).to(self.device)
                f = self._pre(frame)
                inject_mask = torch.from_numpy(onehot[None]).to(self.device)
                grown = self._active | new_t
            mem, pred, _ = engine.step(self.model, self._mem, f, self._active, self.out_size,
                                       inject_mask=inject_mask, inject_new=new_t,
                                       sharding=self._esh)
            self._set_state(mem, grown)
            self._frame_count += 1
            with span("serve.fetch"):
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
        later ``grow`` to that size. A session that holds a graph captures
        the grown push here, on the caller's thread.
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
        if self._graph is not None:
            self._capture()

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
