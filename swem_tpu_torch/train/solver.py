"""Optimizer and LR schedule, counterpart of ``swem_tpu/train/solver.py``.

The JAX package's optax transformations map to ``torch.optim`` ones that
compute the same update:
- ``AdamW``: ``torch.optim.AdamW`` (eps 1e-8), whose weight decay is
  decoupled, as ``optax.adamw``'s is;
- ``Adam``: ``torch.optim.Adam(weight_decay=...)``, the coupled L2 of
  ``optax.chain(add_decayed_weights, adam)``;
- ``SGD``: ``torch.optim.SGD(momentum=b1, weight_decay=...)``, likewise
  coupled, with optax's ``trace`` momentum (the first step moves by g).
Every parameter is decayed (one parameter group, as in the reference).

The schedule is ``MultiStepLR`` with a milestone at each entry of the
stage's iteration list, stepped once per iteration after the optimizer:
the update of iteration i (0-based) takes gamma once i >= milestone, as
optax's piecewise-constant schedule does at ``count >= boundary``. The
last milestone is max_iter, so it never fires.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch

from swem_tpu_torch.config import SolverConfig


def make_optimizer(cfg: SolverConfig, params: Iterable[torch.nn.Parameter],
                   num_devices_scale: int = 1
                   ) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.MultiStepLR]:
    """(optimizer, scheduler) over ``params``; the base LR is scaled by
    ``num_devices_scale`` as the reference scales it by its GPU count."""
    lr = cfg.base_lr * max(1, num_devices_scale)
    b1, b2 = cfg.momentum
    if cfg.optimizer == "AdamW":
        opt = torch.optim.AdamW(params, lr=lr, betas=(b1, b2), eps=1e-8,
                                weight_decay=cfg.weight_decay)
    elif cfg.optimizer == "Adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=1e-8,
                               weight_decay=cfg.weight_decay)
    elif cfg.optimizer == "SGD":
        opt = torch.optim.SGD(params, lr=lr, momentum=b1, weight_decay=cfg.weight_decay)
    else:
        raise ValueError(f"Illegal optimizer {cfg.optimizer}")
    sched = torch.optim.lr_scheduler.MultiStepLR(
        opt, milestones=sorted({int(s) for s in cfg.stage_iters()}), gamma=cfg.gamma)
    return opt, sched


def max_iter_for_stage(cfg: SolverConfig) -> int:
    """max_iter = the last entry of the stage's iteration list."""
    return int(cfg.stage_iters()[-1])
