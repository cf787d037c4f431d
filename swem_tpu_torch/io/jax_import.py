"""Load the JAX package's SWEM variables and optimizer state into the port.

``swem_tpu``'s ``{'params', 'batch_stats'}`` tree (nested dicts of arrays,
given as numpy) becomes the port's ``state_dict``. The port's module names
are the reference implementation's torch keys, so this is the inverse of
``swem_tpu.io.torch_import.convert_swem_state_dict``: a renaming plus the
layout change flax HWIO -> torch OIHW for conv kernels and (in, out) ->
(out, in) for dense kernels.

``train_snapshot`` carries a training run: optax's moments (each a tree
shaped like the params, renamed and laid out by ``moments_state_dict``, the
same mapping) and its update count become the ``torch.optim`` and
``MultiStepLR`` state of ``train/solver.make_optimizer``'s optimizer, in the
snapshot that ``io/checkpoint.save_train_checkpoint`` writes:
- AdamW, and Adam (optax's ``add_decayed_weights`` chained before it):
  ``ScaleByAdamState`` ``mu``/``nu`` -> ``exp_avg``/``exp_avg_sq``, and
  ``count`` -> ``step`` (both bias corrections use it);
- SGD: ``TraceState.trace`` -> ``momentum_buffer``;
- ``count`` -> the scheduler's ``last_epoch``, and the LR is MultiStepLR's
  after ``count`` steps, optax's piecewise-constant value at ``count``.
``scripts/orbax_to_pth.py`` (which imports both packages) reads the orbax
checkpoint and calls these; this module imports numpy and torch only.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_LEAVES = {
    ("params", "kernel"): "weight",
    ("params", "scale"): "weight",
    ("params", "bias"): "bias",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}
_RENAMES = {
    "downsample_conv": ["downsample", "0"],
    "downsample_bn": ["downsample", "1"],
    "channel_gate": ["ChannelGate"],
    "spatial_gate": ["SpatialGate"],
    "fc1": ["mlp", "1"],
    "fc2": ["mlp", "3"],
    "fusion": ["swem_core", "fusion_layer"],
}


def _flatten(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def torch_key(collection: str, path: Tuple[str, ...]) -> str:
    """flax (collection, module path + leaf) -> the port's state_dict key."""
    *parts, leaf = path
    toks = []
    for p in parts:
        if p == "trunk":
            continue
        stage, _, idx = p.partition("_")
        if stage.startswith("layer") and idx.isdigit():
            # the key encoder names its first stage res2
            toks += ["res2" if parts[0] == "key_encoder" and stage == "layer1" else stage, idx]
        elif p == "conv" and "spatial_gate" in parts:
            toks += ["spatial", "conv"]
        else:
            toks += _RENAMES.get(p, [p])
    return ".".join(toks + [_LEAVES[(collection, leaf)]])


def _torch_layout(leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and arr.ndim == 4:
        return np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
    if leaf == "kernel" and arr.ndim == 2:
        return arr.T
    return arr


def jax_to_state_dict(variables) -> Dict[str, torch.Tensor]:
    """``{'params': ..., 'batch_stats': ...}`` -> state_dict for ``SWEM``."""
    out = {}
    for col in ("params", "batch_stats"):
        for path, arr in _flatten(variables[col]):
            key = torch_key(col, path)
            if key in out:
                raise KeyError(f"two variables map to {key}")
            arr = _torch_layout(path[-1], np.asarray(arr, dtype=np.float32))
            out[key] = torch.tensor(arr)
    return out


# optax's moment trees -> the port's per-parameter optimizer slots, for each
# optimizer of train/solver.make_optimizer
OPTAX_SLOTS = {"AdamW": {"mu": "exp_avg", "nu": "exp_avg_sq"},
               "Adam": {"mu": "exp_avg", "nu": "exp_avg_sq"},
               "SGD": {"trace": "momentum_buffer"}}


def moments_state_dict(tree) -> Dict[str, torch.Tensor]:
    """One optax moment tree (shaped like ``params``) -> tensors under the
    port's parameter names, in the port's layouts."""
    return jax_to_state_dict({"params": tree, "batch_stats": {}})


def _multistep_lr(base_lr: float, milestones, gamma: float, count: int) -> float:
    """``MultiStepLR``'s rate after ``count`` steps, multiplied in as its
    steps multiply it (``milestones`` a ``Counter``)."""
    lr = base_lr
    for epoch in range(1, count + 1):
        if epoch in milestones:
            lr = lr * gamma ** milestones[epoch]
    return lr


def train_snapshot(model: torch.nn.Module, solver, model_state: Dict[str, torch.Tensor],
                   count: int, moments: Dict[str, Dict[str, torch.Tensor]]) -> dict:
    """``{"model", "optimizer", "scheduler", "step"}`` of a run of ``solver``
    (the port's ``SolverConfig``) after ``count`` updates, on the CPU.

    ``model`` names the parameters (``named_parameters()``, the optimizer's
    order; any device, ``meta`` too); ``model_state`` is its ``state_dict``;
    ``moments`` maps optax's moment names (``OPTAX_SLOTS``: ``mu`` and ``nu``,
    or ``trace``) to tensors under the parameter names. A missing or foreign
    moment name or parameter name raises ``KeyError``, a shape that is not
    the parameter's ``ValueError``. The dtypes and devices are a native
    checkpoint's: float32 moments and ``step`` a CPU scalar tensor.
    """
    from swem_tpu_torch.train.solver import make_optimizer

    if solver.optimizer not in OPTAX_SLOTS:
        raise ValueError(f"Illegal optimizer {solver.optimizer}")
    slots = OPTAX_SLOTS[solver.optimizer]
    if set(moments) != set(slots):
        raise KeyError(f"{solver.optimizer} takes the moments {sorted(slots)}, got "
                       f"{sorted(moments)}")
    params = dict(model.named_parameters())
    own = model.state_dict()
    for what, tensors, want in [("model state", model_state, own)] + [
            (f"moment {kind!r}", moments[kind], params) for kind in slots]:
        extra, missing = sorted(set(tensors) - set(want)), sorted(set(want) - set(tensors))
        if extra or missing:
            raise KeyError(f"{what}: names not in the model {extra[:5]}, model names missing "
                           f"{missing[:5]}")
        for k, v in tensors.items():
            if tuple(v.shape) != tuple(want[k].shape):
                raise ValueError(f"{what}: {k} has shape {tuple(v.shape)}, the model "
                                 f"{tuple(want[k].shape)}")

    opt, sched = make_optimizer(solver, model.parameters())
    opt_sd, sched_sd = opt.state_dict(), sched.state_dict()
    lr = _multistep_lr(opt_sd["param_groups"][0]["initial_lr"], sched.milestones, sched.gamma,
                       count)
    opt_sd["param_groups"][0]["lr"] = lr
    sched_sd.update(last_epoch=count, _step_count=count + 1, _last_lr=[lr])
    if "_is_initial" in sched_sd:
        sched_sd["_is_initial"] = False
    # torch.optim keeps ``step`` as a CPU scalar of this dtype (not capturable, not fused)
    step_dtype = torch.float64 if torch.get_default_dtype() == torch.float64 else torch.float32
    state = {}
    for i, name in enumerate(params):
        slot = {"step": torch.tensor(float(count), dtype=step_dtype)} if "mu" in slots else {}
        for kind, torch_name in slots.items():
            slot[torch_name] = moments[kind][name].detach().to("cpu", torch.float32, copy=True)
        state[i] = slot
    opt_sd["state"] = state
    return {"model": {k: v.detach().to("cpu", copy=True) for k, v in model_state.items()},
            "optimizer": opt_sd, "scheduler": sched_sd, "step": int(count)}
