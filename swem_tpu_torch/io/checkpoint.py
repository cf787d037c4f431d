"""Checkpoints: reference ``.pth`` files straight into the port's
``state_dict``, the trainer's own checkpoints, and ImageNet backbones.

The port's module names are the reference implementation's torch keys
(``io/jax_import.py``), so a reference checkpoint loads without renaming:
the ``{"state_dict": ...}`` wrapper is taken off, the ImageNet ``mean``/
``std`` buffers and ``num_batches_tracked`` counters (which the port does
not hold) are skipped, and any other key the model lacks raises.

``widen_value_encoder`` is the single-object -> multi-object surgery: a
4-input-channel value-encoder ``conv1`` gets a fifth, orthogonally drawn
input channel, the same draw as ``swem_tpu.io.checkpoint.widen_value_encoder``.

The trainer writes two files into its ``checkpoints/`` directory:
``state.pth`` (model ``state_dict``, optimizer, LR scheduler and step: the
whole run, for ``--resume``) and ``variables.pth`` (the model ``state_dict``
alone), which ``registry.load_state_dict`` and so the evaluator read
directly, because the port's keys are the reference's.

``backbone_state_dict`` turns torchvision ResNet files into the key and
value trunks' entries, as ``swem_tpu.io.torch_import.convert_resnet_state_dict``
does: stages past layer3 and ``fc`` dropped, the value trunk's conv1
widened by the mask channels (the same orthogonal draw) and given the zero
biases its convs carry.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import numpy as np
import torch

VALUE_CONV1 = "value_encoder.conv1.weight"
STATE_FILE, VARIABLES_FILE = "state.pth", "variables.pth"


def _skipped(key: str) -> bool:
    return key.split(".")[-1] in ("mean", "std") or key.endswith("num_batches_tracked")


def read_pth(path: str, expected_keys) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` -> float32 CPU tensors under the port's keys.

    Raises ``KeyError`` on a key outside ``expected_keys`` that is not one of
    the skipped buffers.
    """
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory: orbax checkpoints are read by the JAX package "
                         "(swem_tpu.registry.load_variables); convert one with "
                         "scripts/orbax_to_pth.py, which writes variables.pth and state.pth")
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


def to_host(tree):
    """A copy of ``tree`` (nested dicts, lists, tuples) with every tensor
    detached and copied to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


def _save_atomic(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_train_checkpoint(ckpt_dir: str, snapshot: dict) -> None:
    """Write ``snapshot`` ({"model", "optimizer", "scheduler", "step"}, on the
    host) as ``state.pth`` and its model as ``variables.pth``, each file
    replaced whole."""
    os.makedirs(ckpt_dir, exist_ok=True)
    _save_atomic(snapshot, os.path.join(ckpt_dir, STATE_FILE))
    _save_atomic(snapshot["model"], os.path.join(ckpt_dir, VARIABLES_FILE))


def load_train_checkpoint(path: str, map_location="cpu") -> dict:
    """A ``state.pth`` written by ``save_train_checkpoint``, its tensors on
    ``map_location``."""
    return torch.load(path, map_location=map_location, weights_only=True)


_TV_SKIP = re.compile(r"^(fc\.|layer[4-9]\.)|num_batches_tracked$")


def backbone_state_dict(path: str, trunk: str, extra_chan: int = 0,
                        conv_bias: bool = False, seed: int = 0) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet ``.pth`` -> state_dict entries of ``trunk``
    (``"key_encoder"`` or ``"value_encoder"``) through layer3.

    ``extra_chan`` widens conv1's input with orthogonally drawn channels
    (numpy ``default_rng(seed)``); ``conv_bias`` adds a zero bias to every
    conv that has none (the value trunk's convs carry biases). The key
    trunk names its first stage ``res2``.
    """
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    rng = np.random.default_rng(seed)
    out = {}
    for key, value in sd.items():
        if _TV_SKIP.search(key):
            continue
        value = value.detach().to(torch.float32)
        name = key
        if trunk == "key_encoder" and key.startswith("layer1."):
            name = "res2." + key[len("layer1."):]
        name = f"{trunk}.{name}"
        if key.endswith("weight") and value.ndim == 4 and conv_bias \
                and key[:-len("weight")] + "bias" not in sd:
            out[name[:-len("weight")] + "bias"] = torch.zeros(value.shape[0])
        if key == "conv1.weight" and extra_chan > 0:
            cout, _, h, w = value.shape
            pad = torch.from_numpy(orthogonal_conv_oihw(rng, (cout, extra_chan, h, w)))
            value = torch.cat([value, pad], dim=1)
        out[name] = value
    return out


def init_backbones(model, key_path: str, value_path: Optional[str] = None) -> None:
    """Load ImageNet ResNet files into ``model``'s key trunk and, given
    ``value_path``, its value trunk; every other weight stays. Raises unless
    the file covers the trunk's entries exactly."""
    extra = 1 if model.cfg.single_object else 2
    parts = [backbone_state_dict(key_path, "key_encoder")]
    if value_path is not None:
        parts.append(backbone_state_dict(value_path, "value_encoder", extra_chan=extra,
                                         conv_bias=True))
    own = model.state_dict()
    for part, prefixes in zip(parts, (("key_encoder.",), (
            "value_encoder.conv1.", "value_encoder.bn1.", "value_encoder.layer"))):
        want = {k for k in own if k.startswith(prefixes)}
        if set(part) != want:
            raise KeyError(f"backbone file does not match the trunk: missing "
                           f"{sorted(want - set(part))[:5]}, extra {sorted(set(part) - want)[:5]}")
        for k, v in part.items():
            if tuple(v.shape) != tuple(own[k].shape):
                raise ValueError(f"backbone file: {k} has shape {tuple(v.shape)}, the model "
                                 f"{tuple(own[k].shape)}")
    with torch.no_grad():
        for part in parts:
            for k, v in part.items():
                own[k].copy_(v)
