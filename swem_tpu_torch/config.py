"""Model configuration (the port's own copy of ``swem_tpu.config.ModelConfig``).

The port has no kernel routing switch: on a CUDA tensor the EM loop and the
memory read always run through the hand-written kernels, on a CPU tensor
through their plain PyTorch versions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class ModelConfig:
    """SWEM network hyperparameters (defaults: the flagship configuration)."""

    model_name: str = "SWEM"
    backbone: str = "resnet50"  # 'resnet50' | 'resnet18'
    keydim: int = 128
    valdim: int = 512
    num_bases: int = 128  # L
    num_em_iters: int = 4
    em_tau: float = 0.05
    topl: int = 64
    single_object: bool = False
    # static maximum number of foreground objects (the object axis is
    # padded to it; inactive slots carry all-zero masks)
    max_objs: int = 2
    mdim: int = 256  # decoder mid channels

    @property
    def topl_eff(self) -> int:
        return int(min(self.num_bases, self.topl))


def resolve_device(device: Optional[str | torch.device] = None) -> torch.device:
    """``None`` means CUDA; a missing CUDA device raises, never falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "swem_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
