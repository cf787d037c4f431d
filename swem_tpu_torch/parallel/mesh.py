"""Object parallelism: the port's counterpart of ``swem_tpu/parallel/mesh.py``.

The JAX package shards the padded object axis over a ('data', 'obj') device
mesh with GSPMD: sharding constraints at the (B, N, ...) hand-off points,
XLA partitioning the per-object towers between them and inserting one
all-gather per frame at the soft aggregation. PyTorch has no GSPMD, so the
port runs every shard explicitly, in one process over a grid of devices
(the counterpart of a JAX process's local mesh, ``eval_devices``):

* ``Mesh`` is that grid: an object array of ``torch.device`` of shape
  (n_data, n_obj) with its axis names. A device may appear in it more than
  once; each cell is still its own shard, with its own calls.
* ``EngineSharding`` splits the (B, N, ...) state over the grid (rows of the
  batch over 'data', object slots over 'obj'), joins it back, and keeps one
  model replica per distinct device. ``engine.py``, ``serve.py``, the
  evaluator and the train step take it as ``sharding=``.

Processes (``parallel.init_distributed``) stand for JAX's hosts: under a
process group each process's grid holds its own device only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from swem_tpu_torch.models import em


def _device(d) -> torch.device:
    """``d`` as a ``torch.device`` with an index on CUDA (the current
    device's where none is given), so that equal devices compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _visible_devices() -> list:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """A grid of devices with named axes, the port's ``jax.sharding.Mesh``.

    ``devices``: an object array of ``torch.device``, one axis per name in
    ``axis_names``; ``shape`` maps each name to its extent."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        grid = np.empty(devices.size, dtype=object)
        grid[:] = [_device(d) for d in devices.ravel()]
        self.devices = grid.reshape(devices.shape)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a {self.devices.ndim}-D device grid with axes {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.ravel()]})"


def make_mesh(n_data: Optional[int] = None, devices=None) -> Mesh:
    """1-D 'data' mesh over the first ``n_data`` of ``devices`` (default:
    every visible CUDA device)."""
    devices = list(devices if devices is not None else _visible_devices())
    n_data = len(devices) if n_data is None else n_data
    if n_data < 1 or len(devices) < n_data:
        raise ValueError(f"need {n_data} devices, have {len(devices)}")
    return Mesh(devices[:n_data], ("data",))


def clamp_pow2(limit: int, *divisors: int) -> int:
    """Largest power of two <= ``limit`` that divides every ``divisors``."""
    k = 1
    while k * 2 <= limit:
        k *= 2
    while k > 1 and any(d % k for d in divisors):
        k //= 2
    return k


def eval_devices(device=None) -> list:
    """Devices THIS process may build evaluation meshes over.

    Under a process group, the rank's device alone (``rank_device(device)``):
    each process of a distributed evaluation runs a disjoint slice of the
    videos on its own card, so ``--distributed`` with ``--obj_parallel``
    clamps 'obj' to 1, as a JAX host with one chip does. Without one, every
    visible CUDA device, or ``[device]`` when ``device`` is not a CUDA
    device (the CPU runs unsharded)."""
    from swem_tpu_torch import parallel

    if parallel.process_count() > 1:
        return [_device(parallel.rank_device(device))]
    if device is not None and torch.device(device).type != "cuda":
        return [torch.device(device)]
    return _visible_devices()


def derive_eval_mesh_extents(ndev: int, obj_parallel: int, vb: int) -> tuple:
    """(n_data, n_obj) extents for batched-eval sharding.

    'obj' takes the largest power of two <= the requested ``obj_parallel``
    that divides the device count; 'data' then takes the largest extent
    <= the remaining devices that divides the video batch ``vb`` (sharding
    over fewer devices, some idle, beats not sharding at all when the batch
    does not split evenly). (1, 1) means run unsharded.
    """
    n_obj = 1
    if obj_parallel > 1 and ndev > 1:
        n_obj = clamp_pow2(min(obj_parallel, ndev), ndev)
    limit = ndev // n_obj
    n_data = max(d for d in range(1, limit + 1) if vb % d == 0)
    return n_data, n_obj


def make_mesh2(n_data: Optional[int] = None, n_obj: int = 1, devices=None) -> Mesh:
    """2-D ('data', 'obj') mesh: batch rows over 'data', object slots over
    'obj', from the first n_data * n_obj of ``devices`` (default: every
    visible CUDA device; a list may repeat a device). ``n_obj`` must divide
    the slot count the engine runs."""
    devices = list(devices if devices is not None else _visible_devices())
    if n_data is None:
        if len(devices) % n_obj:
            raise ValueError(f"{len(devices)} devices not divisible by n_obj={n_obj}")
        n_data = len(devices) // n_obj
    devices = devices[: n_data * n_obj]
    if len(devices) < n_data * n_obj or not devices:
        raise ValueError(f"need {n_data * n_obj} devices, have {len(devices)}")
    return Mesh(np.asarray(devices, dtype=object).reshape(n_data, n_obj), ("data", "obj"))


def _bases(b: em.Bases, rows, cols, device) -> em.Bases:
    return em.Bases(*(t[rows, cols].to(device) for t in (b.kappa, b.nu, b.zita)))


class EngineSharding:
    """The explicit object-parallel plan of one mesh.

    Shard (i, j) runs on ``device(i, j)`` and holds batch rows
    ``i*B/n_data : (i+1)*B/n_data`` and object slots
    ``j*N/n_obj : (j+1)*N/n_obj``. Per frame every shard reads its slots'
    memory (K2) and runs its slots' decoder tower; the per-object
    probabilities of a row then go, as exact copies, to every shard of that
    row (JAX's one all-gather at the soft aggregation), and each shard
    value-encodes its slots and EM-updates their memory (K1). Objects never
    meet elsewhere, so the memory stays split by slot for the whole video:
    an engine ``VOSMemory`` becomes a grid ``mem[i][j]``.

    A mesh without an 'obj' axis raises, as in the JAX package; a 1-D
    'data' mesh is ``EngineSharding.of(mesh)``'s (n_data, 1) grid.
    """

    def __init__(self, mesh: Mesh):
        if "obj" not in mesh.axis_names:
            raise ValueError(f"mesh {mesh.axis_names} has no 'obj' axis")
        grid = mesh.devices
        if "data" not in mesh.axis_names:
            grid = grid.reshape(1, -1)
        elif mesh.axis_names.index("data") != 0:
            grid = grid.T
        self.mesh = mesh
        self.grid = grid
        self.n_data, self.n_obj = grid.shape
        self._replicas = (None, None, {})  # (source model, its versions, {device: model})

    @classmethod
    def of(cls, mesh: Mesh) -> "EngineSharding":
        """The plan of any mesh: a 1-D 'data' mesh shards the batch alone."""
        if "obj" in mesh.axis_names:
            return cls(mesh)
        return cls(Mesh(mesh.devices.reshape(-1, 1), ("data", "obj")))

    def device(self, i: int, j: int) -> torch.device:
        return self.grid[i, j]

    @property
    def devices(self) -> list:
        """The distinct devices of the grid, in grid order."""
        return list(dict.fromkeys(self.grid.ravel()))

    def shards(self):
        """(i, j, device) of every shard, row by row."""
        return [(i, j, self.grid[i, j]) for i in range(self.n_data) for j in range(self.n_obj)]

    def rows(self, B: int) -> List[slice]:
        if B % self.n_data:
            raise ValueError(f"batch {B} not divisible by the mesh 'data' axis ({self.n_data})")
        b = B // self.n_data
        return [slice(i * b, (i + 1) * b) for i in range(self.n_data)]

    def cols(self, N: int) -> List[slice]:
        if N % self.n_obj:
            raise ValueError(f"{N} object slots not divisible by the mesh 'obj' axis "
                             f"({self.n_obj})")
        n = N // self.n_obj
        return [slice(j * n, (j + 1) * n) for j in range(self.n_obj)]

    def replicas(self, model) -> dict:
        """{device: model} over the grid's devices: ``model`` itself on its
        own device, a copy of it elsewhere. The copies are cached by the
        source model and the versions of its parameters and buffers, so
        that weights loaded into it (``load_state_dict``, an optimizer
        step) reach them; the source is held by reference, never by id."""
        tensors = list(model.parameters()) + list(model.buffers())
        versions = tuple(t._version for t in tensors)
        source, seen, reps = self._replicas
        if source is not model or seen != versions:
            from swem_tpu_torch.models.swem import SWEM

            home, state, reps = _device(model.device), None, {}
            for dev in self.devices:
                if dev == home:
                    reps[dev] = model
                    continue
                state = model.state_dict() if state is None else state
                reps[dev] = SWEM(model.cfg, device=dev)
                reps[dev].load_state_dict(state)
            self._replicas = (model, versions, reps)
        return reps

    def split_bases(self, bases: em.Bases, B: int) -> list:
        """Bases of batch 1 (shared by every row) or B -> the grid of each
        shard's rows and slots, on its device."""
        rows = self.rows(B) if bases.kappa.shape[0] != 1 else [slice(None)] * self.n_data
        cols = self.cols(bases.kappa.shape[1])
        return [[_bases(bases, rows[i], cols[j], d) for j, d in enumerate(self.grid[i])]
                for i in range(self.n_data)]

    def split_memory(self, mem: em.VOSMemory) -> list:
        """A (B, N) memory -> the grid ``mem[i][j]`` of its shards, each on
        its shard's device."""
        B, N = mem.obj_seen.shape
        rows, cols = self.rows(B), self.cols(N)
        return [[em.VOSMemory(first=_bases(mem.first, rows[i], cols[j], d),
                              update=_bases(mem.update, rows[i], cols[j], d),
                              obj_seen=mem.obj_seen[rows[i], cols[j]].to(d),
                              mem_count=mem.mem_count.to(d))
                 for j, d in enumerate(self.grid[i])] for i in range(self.n_data)]

    def join_memory(self, grid: list, device) -> em.VOSMemory:
        """The inverse of ``split_memory``: one (B, N) memory on ``device``."""
        def cat(get):
            return torch.cat([torch.cat([get(m).to(device) for m in row], dim=1)
                              for row in grid])

        def bases(bank):
            return em.Bases(*(cat(lambda m, f=f: getattr(getattr(m, bank), f))
                              for f in ("kappa", "nu", "zita")))

        return em.VOSMemory(first=bases("first"), update=bases("update"),
                            obj_seen=cat(lambda m: m.obj_seen),
                            mem_count=grid[0][0].mem_count.to(device))

    def gather_objects(self, row: list, device) -> torch.Tensor:
        """One grid row's per-object tensors (..., N/n_obj) -> (..., N) on
        ``device``: the copy every shard of the row takes (of a one-shard
        row, its tensor itself)."""
        if len(row) == 1:
            return row[0].to(device)
        return torch.cat([t.to(device) for t in row], dim=-1)
