"""Method registry and weight loading (the port's counterpart of
``swem_tpu/registry.py``, which reads checkpoints through JAX).

Maps a model name to its trainer and evaluator classes, so another method
plugs in beside SWEM ("SWEM" registers itself at first use);
``load_state_dict`` reads a reference ``.pth`` (or a checkpoint directory's
``variables.pth``) into the port's ``state_dict``, widening a single-object
value encoder for a multi-object model.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

TRAINERS: Dict[str, type] = {}
EVALUATORS: Dict[str, type] = {}


def register_trainer(name: str):
    def deco(cls):
        TRAINERS[name] = cls
        return cls

    return deco


def register_evaluator(name: str):
    def deco(cls):
        EVALUATORS[name] = cls
        return cls

    return deco


def get_trainer(cfg, *args, **kwargs):
    import swem_tpu_torch.train.loop  # noqa: F401  (registers "SWEM")

    name = cfg.model.model_name
    if name not in TRAINERS:
        raise KeyError(f"unknown trainer {name!r} (registered: {sorted(TRAINERS)})")
    return TRAINERS[name](cfg, *args, **kwargs)


def get_evaluator(cfg, *args, **kwargs):
    import swem_tpu_torch.eval.evaluator  # noqa: F401  (registers "SWEM")

    name = cfg.model.model_name
    if name not in EVALUATORS:
        raise KeyError(f"unknown evaluator {name!r} (registered: {sorted(EVALUATORS)})")
    return EVALUATORS[name](cfg, *args, **kwargs)


def load_state_dict(cfg, path: str) -> Dict[str, torch.Tensor]:
    """The weights of ``cfg.model`` from a reference ``.pth``, or from a
    checkpoint directory's ``variables.pth``, on the CPU.

    A single-object checkpoint (4-channel value-encoder conv1) is widened
    unless ``cfg.model.single_object``. An orbax directory raises: it needs
    the JAX package to read, and ``scripts/orbax_to_pth.py`` converts it.
    """
    from swem_tpu_torch.io.checkpoint import VARIABLES_FILE, read_pth, widen_value_encoder
    from swem_tpu_torch.models.swem import SWEM

    if os.path.isfile(os.path.join(path, VARIABLES_FILE)):
        path = os.path.join(path, VARIABLES_FILE)
    with torch.device("meta"):  # the keys only: no weights are allocated
        keys = SWEM(cfg.model, device="meta").state_dict().keys()
    sd = read_pth(path, keys)
    return sd if cfg.model.single_object else widen_value_encoder(sd)
