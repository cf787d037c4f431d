"""Serialized inference artifacts (``torch.export``), counterpart of
``swem_tpu/io/export.py``.

Every program the ``ChunkedVideoRunner`` runs (the frame-0 memory and one
chunk per ladder size) is traced once with ``torch.export`` and saved with
``torch.export.save`` beside the weights and a JSON manifest. Loading needs
``torch``, ``numpy``, the port's ``ops`` (whose import registers the two
kernels' custom ops, each one node of every graph) and
``config.full_float32``: no model classes, no engine, no config plumbing.

The weights and the frame-0 bases are program inputs, stored once, and no
example inputs are saved, so a program file holds the graph alone. The EM
memory crosses each program boundary as a flat tuple of tensors (``_flat``'s
order, ``mem_count`` included), which the loaders thread between calls
without rebuilding a ``VOSMemory``.

A chunk program memorizes every frame but its last, and returns what the
last frame's memorize takes; ``programs/memorize.pt2`` runs it unless the
chunk ends the video (the memory after the video is never read). That is
the JAX package's ``final_mask`` as a host decision: a replay launches each
kernel as often as the live runner does, with no ``torch.cond`` in the
graphs (tracing one took the model's weights into the program as
constants). An injectable chunk program applies its ``(inject_idx,
inject_new)`` on every frame: an all-False row is an exact no-op of
``engine.step`` (the JAX package's export relies on the same).

An artifact replays on the device type it was exported on (the graphs name
their device); the manifest records it and the loaders raise on another.

Layout of an artifact directory::

    manifest.json            shapes, dtypes, chunk ladder, provenance
    weights.pt               the model's state_dict
    bases.pt                 the frame-0 prototypes (kappa, nu, zita)
    programs/init.pt2        frame-0 memory initialization
    programs/chunk_<k>.pt2   k frames, one per size of [chunk] + the ladder
    programs/memorize.pt2    a chunk's last frame into the memory
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from swem_tpu_torch.config import full_float32, resolve_device
from swem_tpu_torch.ops import em_kernel, read_kernel  # noqa: F401  (register the custom ops)

FORMAT_VERSION = 1
_MANIFEST = "manifest.json"
_WEIGHTS = "weights.pt"
_BASES = "bases.pt"
_PROGRAMS = "programs"


@functools.lru_cache(maxsize=None)
def _program(path: str, mtime_ns: int):
    """A saved program, loaded once per process (deserializing one takes
    seconds; the graphs hold no state, so runners and sessions share them)."""
    return torch.export.load(path).module()


def _flat(mem) -> tuple:
    """A ``VOSMemory`` -> its 8 tensors, in the programs' order."""
    return (mem.first.kappa, mem.first.nu, mem.first.zita, mem.update.kappa, mem.update.nu,
            mem.update.zita, mem.obj_seen, mem.mem_count)


class _Program(torch.nn.Module):
    """The module ``torch.export`` traces: ``forward`` calls ``fn(weights,
    *args)``. It holds no parameters: the model stays outside its attribute
    tree and sees the weights through ``functional_call``."""

    def __init__(self, model, fn):
        super().__init__()
        bound = _Bound(model, fn)  # in the closure, not an attribute: no submodule
        self._call = lambda weights, args: torch.func.functional_call(
            bound, {f"model.{k}": v for k, v in weights.items()}, args)

    def forward(self, weights, *args):
        return self._call(weights, args)


class _Bound(torch.nn.Module):
    """``model`` with ``fn(model, *args)`` as its forward, for ``functional_call``."""

    def __init__(self, model, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def _export(model, fn, path: str, args) -> float:
    """Trace ``fn`` on ``args`` (weights first) with gradients off, and save
    the program alone; returns the wall seconds."""
    t0 = time.perf_counter()
    with torch.no_grad():
        ep = torch.export.export(_Program(model, fn), args, strict=False)
    ep.example_inputs = None  # the graph only: no copy of the example tensors
    for node in ep.graph.nodes:  # nor each node's Python stack (most of the file)
        node.meta.pop("stack_trace", None)
    torch.export.save(ep, path)
    return time.perf_counter() - t0


def export_runner(model, path: str, *, frame_hw: Tuple[int, int],
                  out_size: Optional[Tuple[int, int]] = None, batch: int = 1,
                  n_slots: Optional[int] = None, chunk: int = 16, frame_dtype=np.uint8,
                  preprocess=None, scores: bool = False, injectable: bool = False, seed: int = 0,
                  bases=None) -> dict:
    """Export a ``ChunkedVideoRunner``-equivalent pipeline of ``model`` to ``path``.

    ``frame_hw``/``frame_dtype`` describe the RAW frames the artifact takes
    (before ``preprocess``, which maps a device tensor (..., H, W, 3) to the
    model's input); with ``preprocess=None`` and uint8 frames, the uint8 ->
    /255 normalization is traced in. The frame-0 bases are drawn from
    ``seed`` (``em.init_bases`` on ``torch.Generator().manual_seed(seed)``),
    or ``bases`` (an ``em.Bases`` of one draw of ``n_slots``) when given.
    ``injectable`` exports chunk programs that take per-frame
    ``(inject_idx, inject_new)`` and return the active slots after the chunk
    (``ExportedRunner(injections=...)``, ``ExportedSession.add_objects``).
    The programs run on ``model.device``. Returns the manifest, with each
    program's export wall time in seconds under ``export_seconds``.
    """
    # the model code is an export-time dependency only: the loaders below
    # never import it
    from swem_tpu_torch import engine
    from swem_tpu_torch.models import em

    cfg = model.cfg
    n_slots = cfg.max_objs if n_slots is None else n_slots
    out_size = tuple(frame_hw if out_size is None else out_size)
    frame_dtype = np.dtype(frame_dtype)
    if preprocess is None:
        def preprocess(f):
            return f.float() / 255.0 if f.dtype == torch.uint8 else f
    pre = preprocess
    dev = model.device
    if bases is None:
        bases = em.init_bases(torch.Generator().manual_seed(seed), 1, n_slots, cfg.keydim,
                              cfg.valdim, cfg.num_bases)
    bases = tuple(t.detach().to(dev).contiguous() for t in (bases.kappa, bases.nu, bases.zita))
    weights = {k: v.detach() for k, v in model.state_dict().items()}
    h, w = frame_hw
    tdtype = torch.from_numpy(np.zeros(0, frame_dtype)).dtype

    def memory(leaves):
        return em.VOSMemory(first=em.Bases(*leaves[0:3]), update=em.Bases(*leaves[3:6]),
                            obj_seen=leaves[6], mem_count=leaves[7])

    def init_fn(model, bases, frame0, init_mask, active):
        mem = engine.init_memory(model, None, pre(frame0), init_mask, active,
                                 bases=em.Bases(*bases))
        return _flat(mem)

    def chunk_fn(model, leaves, frames, active, inject_idx=None, inject_new=None):
        mem = memory(leaves)
        x = pre(frames)
        keys = engine.encode_keys_batched(model, x)
        preds = []
        for t in range(x.shape[0]):
            inject = {}
            if injectable:
                mask, new = engine._injection(inject_idx[t], inject_new[t], n_slots, x.device)
                inject = dict(inject_mask=mask, inject_new=new)
            keys_t = tuple(k[t] for k in keys)
            last = t == x.shape[0] - 1
            mem, pred_idx, pred_mask = engine.step(model, mem, x[t], active, out_size,
                                                   do_memorize=not last, keys=keys_t, **inject)
            if injectable:
                active = active | inject["inject_new"]
            preds.append(pred_mask if scores else pred_idx)
        qk16, _, s16, _, _, vf = keys_t
        out = (_flat(mem), torch.stack(preds))
        if injectable:
            out += (active,)
        # the last frame's memorize, for the memorize program
        return out + ((x[-1], active, qk16, s16, vf, pred_idx, pred_mask),)

    def memorize_fn(model, leaves, carry):
        return _flat(engine.memorize_from_pred(model, memory(leaves), *carry))

    os.makedirs(os.path.join(path, _PROGRAMS), exist_ok=True)
    f0 = torch.zeros((batch, h, w, 3), dtype=tdtype, device=dev)
    mask = torch.zeros((batch,) + out_size + (n_slots + 1,), device=dev)
    active = torch.zeros((batch, n_slots), dtype=torch.bool, device=dev)
    seconds = {"init": _export(model, init_fn, os.path.join(path, _PROGRAMS, "init.pt2"),
                               (weights, bases, f0, mask, active))}
    # the chunk programs' memory: the init program's output shapes, each leaf
    # its own tensor (the trace would take two inputs that are one tensor for one)
    leaves = tuple(t.clone() for t in _flat(em.fresh_memory(em.Bases(*bases).expand(batch))))
    # dedupe: chunk=1's ladder is [1] again: one program, one manifest entry
    sizes = list(dict.fromkeys([chunk] + engine.ladder_sizes(chunk)))
    for size in sizes:
        args = (weights, leaves, torch.zeros((size,) + tuple(f0.shape), dtype=tdtype, device=dev),
                active)
        if injectable:
            args += (torch.zeros((size, batch) + out_size, dtype=torch.uint8, device=dev),
                     torch.zeros((size, batch, n_slots), dtype=torch.bool, device=dev))
        seconds[f"chunk_{size}"] = _export(
            model, chunk_fn, os.path.join(path, _PROGRAMS, f"chunk_{size}.pt2"), args)
    with torch.no_grad(), full_float32():  # a carry of the right shapes, on zeros
        carry = chunk_fn(model, leaves, *args[2:])[-1]
    seconds["memorize"] = _export(model, memorize_fn,
                                  os.path.join(path, _PROGRAMS, "memorize.pt2"),
                                  (weights, leaves, carry))

    torch.save({k: v.cpu() for k, v in weights.items()}, os.path.join(path, _WEIGHTS))
    torch.save(tuple(t.cpu() for t in bases), os.path.join(path, _BASES))
    manifest = {
        "format_version": FORMAT_VERSION,
        "torch_version": torch.__version__,
        "device": dev.type,
        "frame_hw": list(frame_hw),
        "out_size": list(out_size),
        "batch": batch,
        "n_slots": n_slots,
        "chunk": chunk,
        "sizes": sizes,
        "frame_dtype": frame_dtype.name,
        "scores": scores,
        "injectable": injectable,
        "seed": seed,
        "model_config": dataclasses.asdict(cfg),
    }
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2, default=str)
    return dict(manifest, export_seconds=seconds)


class ExportedRunner:
    """Replay an exported artifact: torch and the port's ops, no model code.

    Mirrors ``ChunkedVideoRunner.__call__``'s contract: ``frames`` is a
    (T, B, H, W, 3) HOST numpy array of the manifest's dtype; returns
    (T-1, B, Ho, Wo) uint8 predictions on the host (or the stacked float32
    scores on the device for a ``scores=True`` artifact). Runs on ``cuda``
    unless ``device`` says otherwise, which must be the artifact's device
    type.
    """

    def __init__(self, path: str, device=None):
        with open(os.path.join(path, _MANIFEST)) as f:
            self.manifest = m = json.load(f)
        if m["format_version"] != FORMAT_VERSION:
            raise ValueError(f"artifact format {m['format_version']} != {FORMAT_VERSION}")
        self.device = resolve_device(device)
        if self.device.type != m["device"]:
            raise ValueError(f"the artifact was exported on {m['device']} and replays there, "
                             f"not on {self.device}")
        # the weights and bases live on the device once; every call reuses them
        self._weights = torch.load(os.path.join(path, _WEIGHTS), map_location=self.device,
                                   weights_only=True)
        self._bases = tuple(torch.load(os.path.join(path, _BASES), map_location=self.device,
                                       weights_only=True))

        self._path = path
        self.frame_dtype = np.dtype(m["frame_dtype"])
        self.frame_hw = tuple(m["frame_hw"])
        self.out_size = tuple(m["out_size"])
        self.batch = m["batch"]
        self.n_slots = m["n_slots"]
        self.chunk = m["chunk"]
        self.scores = m["scores"]
        self.injectable = m["injectable"]
        # the manifest stores [chunk] + its ladder (deduplicated): the replay
        # loop needs no model code to rebuild it
        self._ladder = [s for s in m["sizes"] if s != self.chunk]

    def _load(self, name: str):
        """Program ``name``, loaded at its first use."""
        file = os.path.join(self._path, _PROGRAMS, f"{name}.pt2")
        return _program(os.path.abspath(file), os.stat(file).st_mtime_ns)

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        """A host array -> a tensor on the device (a copy: numpy views may be
        read-only or negatively strided)."""
        return torch.from_numpy(np.array(a, dtype, order="C")).to(self.device)

    def _memory0(self, frame0, init_mask, active) -> tuple:
        with torch.no_grad(), full_float32():
            return self._load("init")(self._weights, self._bases, self._tensor(frame0),
                                      self._tensor(init_mask, np.float32),
                                      self._tensor(active, bool))

    def _chunk(self, mem, frames, active, final: bool, inject=None):
        """One chunk program, then the memorize program unless ``final``
        -> (mem, preds, active)."""
        size = frames.shape[0]
        args = (self._weights, mem, self._tensor(frames), active)
        with torch.no_grad(), full_float32():
            if self.injectable:
                if inject is None:
                    inject = (np.zeros((size, self.batch) + self.out_size, np.uint8),
                              np.zeros((size, self.batch, self.n_slots), bool))
                mem, preds, active, carry = self._load(f"chunk_{size}")(
                    *args, self._tensor(inject[0]), self._tensor(inject[1]))
            else:
                mem, preds, carry = self._load(f"chunk_{size}")(*args)
            if not final:
                mem = self._load("memorize")(self._weights, mem, carry)
        return mem, preds, active

    def warmup(self) -> None:
        """Run init and every chunk program once on zeros, fetching the
        predictions, so that no timed call pays a first call's setup."""
        B, (h, w), n = self.batch, self.frame_hw, self.n_slots
        mem = self._memory0(np.zeros((B, h, w, 3), self.frame_dtype),
                            np.zeros((B,) + self.out_size + (n + 1,), np.float32),
                            np.zeros((B, n), bool))
        active = self._tensor(np.zeros((B, n), bool))
        for size in self.manifest["sizes"]:
            mem, preds, _ = self._chunk(mem, np.zeros((size, B, h, w, 3), self.frame_dtype),
                                        active, False)
            preds.cpu()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _check_frames(self, frames: np.ndarray, lead: int) -> None:
        if frames.dtype != self.frame_dtype:
            raise TypeError(f"the artifact takes {self.frame_dtype} frames, got {frames.dtype}")
        want = (self.batch,) + self.frame_hw + (3,)
        if frames.shape[lead:] != want:
            raise ValueError(f"the artifact takes frames of shape (..., {', '.join(map(str, want))})"
                             f", got {frames.shape}")

    def __call__(self, frames: np.ndarray, init_mask, active, injections=None):
        """Replay a whole video. ``injections`` (an ``injectable`` artifact):
        {frame index: (idx_map (B, Ho, Wo) uint8 slot-index map, new (B, N)
        bool)}, the ``ChunkedVideoRunner`` contract for objects that appear
        mid-video."""
        frames = np.asarray(frames)
        self._check_frames(frames, 1)
        if injections and not self.injectable:
            raise ValueError("injections need an artifact exported with injectable=True")
        injections = injections or {}
        T, B = frames.shape[:2]
        init_mask = np.asarray(init_mask, np.float32)
        mem = self._memory0(frames[0], init_mask, active)
        active = self._tensor(active, bool)
        if T == 1:
            if self.scores:
                return torch.zeros((0, B) + self.out_size + (init_mask.shape[-1],),
                                   device=self.device)
            return np.zeros((0, B) + self.out_size, np.uint8)
        preds, t = [], 1

        def run(mem, active, t, size):
            inject = None
            if any(t + j in injections for j in range(size)):
                inject = (np.zeros((size, B) + self.out_size, np.uint8),
                          np.zeros((size, B, self.n_slots), bool))
                for j in range(size):
                    if t + j in injections:
                        inject[0][j], inject[1][j] = injections[t + j]
            mem, p, active = self._chunk(mem, frames[t:t + size], active, t + size == T, inject)
            preds.append(p)
            return mem, active, t + size

        while t + self.chunk <= T:
            mem, active, t = run(mem, active, t, self.chunk)
        for size in self._ladder:
            if t + size <= T:
                mem, active, t = run(mem, active, t, size)
        if self.scores:
            return torch.cat(preds)
        return torch.cat(preds).cpu().numpy()


class ExportedSession:
    """Online per-frame streaming from the SAME artifact.

    The chunk ladder always ends in a 1-frame program, so every artifact
    holds a single-frame match -> decode -> memorize program; threading the
    memory through it frame by frame gives ``serve.StreamingSession``'s
    ``start``/``push`` contract (batch-1, index artifacts). An ``injectable``
    artifact also takes ``add_objects``, the session's mid-stream injection.
    Frames are (H, W, 3) of the artifact's dtype at its ``frame_hw``.
    """

    def __init__(self, path: str, device=None):
        self._r = ExportedRunner(path, device)
        if self._r.batch != 1:
            raise ValueError("streaming replay wants a batch=1 artifact")
        if self._r.scores:
            raise ValueError("streaming replay wants an index (scores=False) artifact")
        self._mem = None
        self._active = None
        self._frame_count = 0
        self.n_slots = self._r.n_slots
        self.frame_hw = self._r.frame_hw
        self.out_size = self._r.out_size

    def warmup(self) -> None:
        self._r.warmup()

    def _frame(self, frame) -> np.ndarray:
        frame = np.asarray(frame)[None, None]
        self._r._check_frames(frame, 1)
        return frame

    def _labels(self, mask) -> np.ndarray:
        """Label map with ids beyond the slot budget dropped to background.
        Clipped BEFORE the one-hot: a bare ``== arange`` would leave those
        pixels all-zero instead of background (``data.davis_test.to_onehot``'s
        contract)."""
        labels = np.asarray(mask)
        return np.where(labels <= self.n_slots, labels, 0)

    def start(self, frame0: np.ndarray, init_mask: np.ndarray) -> None:
        """Seed the memory. frame0 (H, W, 3); init_mask (Ho, Wo) uint8 labels
        (0 = background, 1..n = objects; ids beyond the slot budget drop to
        background)."""
        frame = self._frame(frame0)
        labels = self._labels(init_mask)
        onehot = (labels[..., None] == np.arange(self.n_slots + 1)).astype(np.float32)
        active = np.zeros((1, self.n_slots), bool)
        present = np.unique(labels)
        active[0, present[present > 0] - 1] = True
        self._mem = self._r._memory0(frame[0], onehot[None], active)
        self._active = self._r._tensor(active)
        self._frame_count = 1

    def _require_started(self) -> None:
        if self._mem is None:
            raise RuntimeError("call start() first")

    def push(self, frame: np.ndarray) -> np.ndarray:
        """Segment one frame and update the memory. Returns (Ho, Wo) uint8."""
        self._require_started()
        self._mem, pred, _ = self._r._chunk(self._mem, self._frame(frame), self._active, False)
        self._frame_count += 1
        return pred.cpu().numpy()[0, 0]

    def add_objects(self, frame: np.ndarray, mask: np.ndarray, new_ids) -> np.ndarray:
        """Mid-stream object injection (an ``injectable`` artifact), as
        ``serve.StreamingSession.add_objects``: ``mask`` is a (Ho, Wo) uint8
        label map holding the new objects, ``new_ids`` their label values.
        Predictions under the new objects take the ground truth, and the new
        slots join the active set for all later frames."""
        self._require_started()
        if not self._r.injectable:
            raise ValueError("add_objects needs an artifact exported with injectable=True")
        frame = self._frame(frame)
        new = np.zeros((1, 1, self.n_slots), bool)
        for obj in new_ids:
            if not 1 <= obj <= self.n_slots:
                raise ValueError(f"object id {obj} is outside the slot budget 1..{self.n_slots}")
            new[0, 0, obj - 1] = True
        labels = self._labels(mask).astype(np.uint8)[None, None]
        self._mem, pred, self._active = self._r._chunk(self._mem, frame, self._active, False,
                                                       (labels, new))
        self._frame_count += 1
        return pred.cpu().numpy()[0, 0]

    @property
    def frames_seen(self) -> int:
        return self._frame_count
