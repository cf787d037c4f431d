"""Load the JAX package's SWEM variables into the port.

``swem_tpu``'s ``{'params', 'batch_stats'}`` tree (nested dicts of arrays,
given as numpy) becomes the port's ``state_dict``. The port's module names
are the reference implementation's torch keys, so this is the inverse of
``swem_tpu.io.torch_import.convert_swem_state_dict``: a renaming plus the
layout change flax HWIO -> torch OIHW for conv kernels and (in, out) ->
(out, in) for dense kernels.
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
