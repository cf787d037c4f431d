"""Configuration: the port's own copies of ``swem_tpu.config``'s dataclasses,
with the fields that inference, the evaluator and training read.

The port has no kernel routing switch: on a CUDA tensor the EM loop and the
memory read always run through the hand-written kernels, on a CPU tensor
through their plain PyTorch versions.
"""

from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Iterator, Optional, Sequence, Tuple

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
    # Gaussian locality reweighting of the memory read (inference only; off,
    # as in the reference, at n_kernel = 0)
    n_kernel: int = 0
    kernel_sigma: float = 7.0
    # random memory-base dropout of the value read, training only (0.0 in
    # the reference)
    p_drop: float = 0.0

    def __post_init__(self):
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got {self.dtype!r}")

    @property
    def topl_eff(self) -> int:
        return int(min(self.num_bases, self.topl))


@dataclass(frozen=True)
class DataConfig:
    """Training data and loader (``swem_tpu.config.DataConfig``)."""

    seed: int = 123  # the loader's and the train step's draws; evaluation bases
    num_frames: int = 3  # frames per training clip
    max_num_objs: int = 2
    only_valid: bool = True
    pretrain_sets: Sequence[str] = ("BIG_small", "HRSOD_small", "FSS", "ECSSD", "DUTS")
    pretrain_set_ratio: Sequence[int] = (5, 5, 1, 1, 1)
    maintrain_sets: Sequence[str] = ("DAVIS17", "YTVOS19")
    data_freq: Sequence[int] = (1, 1)
    data_root: str = "datasets"  # holds DAVIS/, YTVOS19/, STCN_PreTrain/
    vid_load_size: int = 480  # short side at load time
    vid_crop_size: Tuple[int, int] = (384, 384)
    davis_max_skip: int = 25
    davis_samples_per_video: int = 5
    ytvos_max_skip: int = 5
    ytvos_samples_per_video: int = 1
    batch_size: int = 8  # global batch
    num_workers: int = 8


@dataclass(frozen=True)
class SolverConfig:
    """Optimizer and schedule (``swem_tpu.config.SolverConfig``)."""

    stage: int = 0  # 0 pretrain, 1 DAVIS, 2 YTVOS, 3 DAVIS+YTVOS
    base_lr: float = 2e-5
    pretrain_iters: Tuple[int, int] = (150000, 300000)  # (milestone, max_iter)
    maintrain_iters: Tuple[int, int] = (125000, 150000)
    davis_iters: Tuple[int, int] = (50000, 60000)
    gamma: float = 0.1
    optimizer: str = "AdamW"  # 'SGD' | 'Adam' | 'AdamW'
    momentum: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 5e-4
    # activation recomputation: None | 'encoder' (the key encode) | 'block'
    # (each supervised frame's whole block), through torch.utils.checkpoint
    remat: Optional[str] = None

    def __post_init__(self):
        if self.remat not in (None, "encoder", "block"):
            raise ValueError(f"remat must be None, 'encoder' or 'block', got {self.remat!r}")

    @property
    def stage_name(self) -> str:
        return f"S{self.stage}"

    def stage_iters(self) -> Tuple[int, int]:
        if self.stage == 0:
            return tuple(self.pretrain_iters)
        if self.stage == 1:
            return tuple(self.davis_iters)
        return tuple(self.maintrain_iters)


@dataclass(frozen=True)
class LossConfig:
    """Training loss (``swem_tpu.config.LossConfig``)."""

    name: str = "boots_ce"  # 'ce' | 'boots_ce'
    bs_ratio: float = 0.30  # final top-p fraction
    bs_period: Tuple[int, int] = (20000, 70000)  # (start_warm, end_warm)
    aux: Optional[str] = "iou"  # None | 'iou' | 'lovasz'
    aux_ratio: float = 1.0
    only_valid_obj: bool = True


@dataclass(frozen=True)
class EvalConfig:
    """Evaluation settings (``swem_tpu.config.EvalConfig``)."""

    eval_set: str = "DAVIS17"  # DAVIS16|DAVIS17|DAVIS17Test|YTVOS18|YTVOS19
    data_root: str = "datasets"
    ssize: int = 480  # YouTube-VOS short side for inference
    davis_in_size: Tuple[int, int] = (480, 864)  # fixed DAVIS inference size
    chunk: int = 16  # the runner's chunk length
    video_batch: int = 1  # videos per device batch (throughput mode)
    visualize: bool = False
    max_objs: int = 8  # static object-slot budget at evaluation
    flip: bool = False
    scales: Sequence[int] = (480,)
    obj_parallel: int = 1  # object slots over this many devices (parallel/mesh.py)
    per_object_csv: bool = False


@dataclass(frozen=True)
class SWEMConfig:
    """The experiment (``swem_tpu.config.SWEMConfig``)."""

    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    exp_name: str = "swem"
    log_dir: str = "logs"  # runs go to <log_dir>/<model>/<stage>/<exp_name>/
    log_period: int = 100
    save_period: int = 5000
    vis_period: int = 1000  # overlay image grids to tensorboard (0 = off)
    resume: Optional[str] = None
    from_scratch: bool = True

    def replace(self, **kw) -> "SWEMConfig":
        return dataclasses.replace(self, **kw)


def single_object_config(cfg: SWEMConfig) -> SWEMConfig:
    """``max_num_objs == 1`` switches the model to single-object mode."""
    if cfg.data.max_num_objs == 1:
        return cfg.replace(model=dataclasses.replace(cfg.model, single_object=True, max_objs=1))
    return cfg


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


def no_grad():
    """``torch.no_grad()`` where gradients are on, else nothing: a program
    traced with gradients off (``io/export.py``) then records no switch of
    the grad mode, each of which ``torch.export`` turns into a subgraph
    (they cost it most of its trace time)."""
    return torch.no_grad() if torch.is_grad_enabled() else nullcontext()


def resolve_device(device: Optional[str | torch.device] = None) -> torch.device:
    """``None`` means CUDA; a missing CUDA device raises, never falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "swem_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
