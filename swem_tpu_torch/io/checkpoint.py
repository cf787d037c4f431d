"""Reference ``.pth`` checkpoints straight into the port's ``state_dict``.

The port's module names are the reference implementation's torch keys
(``io/jax_import.py``), so a reference checkpoint loads without renaming:
the ``{"state_dict": ...}`` wrapper is taken off, the ImageNet ``mean``/
``std`` buffers and ``num_batches_tracked`` counters (which the port does
not hold) are skipped, and any other key the model lacks raises.

``widen_value_encoder`` is the single-object -> multi-object surgery: a
4-input-channel value-encoder ``conv1`` gets a fifth, orthogonally drawn
input channel, the same draw as ``swem_tpu.io.checkpoint.widen_value_encoder``.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

VALUE_CONV1 = "value_encoder.conv1.weight"


def _skipped(key: str) -> bool:
    return key.split(".")[-1] in ("mean", "std") or key.endswith("num_batches_tracked")


def read_pth(path: str, expected_keys) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` -> float32 CPU tensors under the port's keys.

    Raises ``KeyError`` on a key outside ``expected_keys`` that is not one of
    the skipped buffers.
    """
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory: orbax checkpoints are read by the JAX package "
                         "(swem_tpu.registry.load_variables); convert its variables with "
                         "swem_tpu_torch.io.jax_import.jax_to_state_dict")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    expected = set(expected_keys)
    out = {}
    for key, value in sd.items():
        if _skipped(key):
            continue
        if key not in expected:
            raise KeyError(f"{path}: checkpoint key {key!r} has no counterpart in the model")
        out[key] = value.detach().to(torch.float32)
    return out


def orthogonal_conv_oihw(rng: np.random.Generator, shape) -> np.ndarray:
    """Orthogonal conv kernel (O, I, kH, kW), ``torch.nn.init.orthogonal_``
    semantics: the (O, I*kH*kW) matrix has orthonormal rows or columns."""
    cout, cin, h, w = shape
    rows, cols = cout, h * w * cin
    a = rng.standard_normal((max(rows, cols), min(rows, cols)))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))
    if rows < cols:
        q = q.T
    return q[:rows, :cols].reshape(cout, cin, h, w).astype(np.float32)


def widen_value_encoder(state_dict: Dict[str, torch.Tensor], seed: int = 0
                        ) -> Dict[str, torch.Tensor]:
    """A 4-input-channel value-encoder conv1 (single object) -> 5 channels,
    the new one drawn by ``orthogonal_conv_oihw`` from numpy's
    ``default_rng(seed)``. Other state dicts come back unchanged."""
    kernel = state_dict[VALUE_CONV1]
    cout, cin, h, w = kernel.shape
    if cin != 4:
        return state_dict
    pad = torch.from_numpy(orthogonal_conv_oihw(np.random.default_rng(seed), (cout, 1, h, w)))
    return {**state_dict, VALUE_CONV1: torch.cat([kernel, pad], dim=1)}
