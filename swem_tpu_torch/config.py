"""Model configuration (the port's own copy of ``swem_tpu.config.ModelConfig``).

The port has no kernel routing switch: on a CUDA tensor the EM loop and the
memory read always run through the hand-written kernels, on a CPU tensor
through their plain PyTorch versions.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Iterator, Optional

import torch

# the conv towers' compute dtypes; the JAX package's "float64" is a
# test-only oracle there and is not ported
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    # compute dtype of the conv towers: 'float32' for parity, 'bfloat16' for
    # speed; the EM statistics, the memory and both kernels stay float32
    dtype: str = "float32"

    def __post_init__(self):
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {self.dtype!r}")

    @property
    def topl_eff(self) -> int:
        return int(min(self.num_bases, self.topl))


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    """The conv towers' torch dtype (``swem_tpu.models.swem._dtype_of``)."""
    return DTYPES[cfg.dtype]


class _Float32Scope:
    """The process-wide count of open ``full_float32`` scopes.

    The two TF32 flags are process-global, so scopes that overlap in time
    (a thread warming a grown session while another pushes frames) share
    one saved state: the first scope in saves the flags and turns TF32 off,
    the last one out puts them back. Restoring per scope would let a scope
    that closes first turn TF32 back on inside one that is still open.
    """

    def __init__(self):
        self.lock = threading.Lock()
        self.depth = 0
        self.saved = (False, False)

    def enter(self) -> None:
        cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
        with self.lock:
            if self.depth == 0:
                self.saved = cudnn.allow_tf32, matmul.allow_tf32
                cudnn.allow_tf32 = matmul.allow_tf32 = False
            self.depth += 1

    def exit(self) -> None:
        with self.lock:
            self.depth -= 1
            if self.depth == 0:
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


_FLOAT32_SCOPE = _Float32Scope()


@contextmanager
def full_float32() -> Iterator[None]:
    """Float32 convolutions and matrix products in full float32, not TF32.

    The same at both compute dtypes: bf16 parts are bf16 by their explicit
    casts, and the float32 ones (every float32 conv tower, the ``nu`` GEMM,
    the norms) compute as the JAX package's do at precision HIGHEST.
    PyTorch's own default runs float32 convolutions in TF32. Scoped and
    counted across threads: the two flags are set when the first open scope
    begins and put back as found when the last one ends, also after an
    exception. (``torch.backends.cudnn.flags`` would also reset the CUDA
    backend's float32 precision setting, which slowed float32 matrix
    products on the card, inside the scope and after it.)
    """
    _FLOAT32_SCOPE.enter()
    try:
        yield
    finally:
        _FLOAT32_SCOPE.exit()


def resolve_device(device: Optional[str | torch.device] = None) -> torch.device:
    """``None`` means CUDA; a missing CUDA device raises, never falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "swem_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
