"""Parallelism: data parallelism over processes, the port's counterpart of
the multi-host half of ``swem_tpu/parallel/mesh.py`` (``shard_batch``,
``replicate``), and object parallelism over a device grid (``mesh.py``).

The reference's only multi-device strategy is data parallelism over NCCL
DDP (reference ``train.py:37``, ``swem_trainer.py:42-43``): one process per
device, each reading its own shard of every batch, gradients averaged by
``DistributedDataParallel``. Here:

* ``init_distributed`` joins the process group: ``tcp://<coordinator>``
  when the JAX CLI's three flags are given (its explicit rendezvous),
  otherwise ``env://``, what ``python -m torch.distributed.run`` sets (the
  reference's protocol); ``process_group`` is the CLIs' scope around it.
* ``process_index``/``process_count`` stand for ``jax.process_index``/
  ``jax.process_count``; ``rank_device`` is the device this process
  computes on (``eval_devices`` under a process group).
* ``shard_rows`` is this process's rows of a global batch, ``x[rank::world]``,
  the rows the loader's shard holds (``data/loader.py``); parameters need
  no ``replicate``: ``DistributedDataParallel`` broadcasts rank 0's at
  construction. ``global_mean`` averages a logged value over the
  processes; ``barrier`` waits for all of them.

Object parallelism (``mesh.py``: ``make_mesh2``, ``EngineSharding``,
``derive_eval_mesh_extents``, ``clamp_pow2``) runs the shards of a device
grid inside one process; it composes with these processes as JAX's local
meshes compose with its hosts.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch
import torch.distributed as dist

from swem_tpu_torch.parallel.mesh import (  # noqa: F401  (re-exported)
    EngineSharding,
    Mesh,
    clamp_pow2,
    derive_eval_mesh_extents,
    eval_devices,
    make_mesh,
    make_mesh2,
)


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: str = "gloo") -> None:
    """Join the process group over ``backend`` ("nccl" or "gloo").

    ``coordinator`` ("host:port"), ``num_processes`` and ``process_id``
    together rendezvous at ``tcp://coordinator``; with none of them the
    group comes from the environment (``env://``: MASTER_ADDR, MASTER_PORT,
    RANK, WORLD_SIZE). Some but not all of them raise ``ValueError``.
    """
    flags = (coordinator, num_processes, process_id)
    if all(v is None for v in flags):
        dist.init_process_group(backend, init_method="env://")
        return
    if any(v is None for v in flags):
        raise ValueError("--coordinator, --num_processes and --process_id go together: "
                         f"got {flags}")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


@contextlib.contextmanager
def process_group(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                  process_id: Optional[int] = None, backend: str = "gloo", device=None):
    """``init_distributed``, then yields this process's device
    (``rank_device``; made the current CUDA device); the group is destroyed
    on exit."""
    init_distributed(coordinator, num_processes, process_id, backend)
    try:
        dev = rank_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        yield dev
    finally:
        dist.destroy_process_group()


def process_index() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes; 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(device=None) -> torch.device:
    """The device this process computes on: ``device`` when given (ranks
    may share one), otherwise ``cuda:<LOCAL_RANK>`` (the rank when
    LOCAL_RANK is unset), raising when the host has no such card."""
    if device is not None:
        return torch.device(device)
    index = int(os.environ.get("LOCAL_RANK", process_index()))
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"process {process_index()} wants cuda:{index}, but "
                           f"{torch.cuda.device_count()} CUDA devices are visible; pass "
                           f"--device to choose one")
    return torch.device("cuda", index)


def shard_rows(x, rank: int, world: int):
    """Rows ``rank::world`` of ``x``: this process's share of a global batch."""
    return x[rank::world]


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the processes (``x`` itself without a group):
    one all-reduce."""
    if process_count() == 1:
        return x
    x = x.clone()
    dist.all_reduce(x)
    return x / process_count()


def barrier(tag: str) -> None:
    """Wait until every process reaches the barrier ``tag`` (a no-op in one
    process); a failed barrier raises with its tag."""
    if process_count() > 1:
        try:
            dist.barrier()
        except RuntimeError as e:
            raise RuntimeError(f"barrier {tag!r} failed: {e}") from e
