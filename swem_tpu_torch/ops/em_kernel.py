"""The EM loop of one memorize: CUDA kernel, its wrapper and its plain version.

Counterpart of ``swem_tpu/ops/em_pallas.py`` (the kernel ``_em_kernel``) and
of the loop inside ``swem_tpu/models/em.py::em_update``. ``em_loop`` takes
the plain PyTorch version for a CPU tensor and launches
``csrc/em_loop.cu`` (one cooperative launch, tensor cores in 3xTF32) for a
CUDA tensor; there is no other route. The source note in ``csrc/em_loop.cu``
says what bounds the kernel and how it is built.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from swem_tpu_torch.ops import build

TILE = 32  # pixels per tile of the kernel
MAX_SMEM = 232448  # dynamic shared memory of one H100 block
launches = 0  # wrapper calls that launched the kernel
_barriers: Dict[Tuple[int, int], torch.Tensor] = {}  # (device, stream) -> grid barrier counter


def l2norm(x: torch.Tensor, dim: int) -> torch.Tensor:
    """L2-normalize with the reference's +1e-6 denominator."""
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + 1e-6)


def e_step(x, kappa, weights, tau: float):
    """x (B,P,Ck); kappa (B,N,2,Ck,L); weights (B,N,2,P) -> z (B,N,2,P,L)."""
    logits = torch.matmul(x[:, None, None], l2norm(kappa, -2))
    return torch.softmax(logits / tau, dim=-1) * weights[..., None]


def m_step(z, x, kappa0, zita0):
    """Running weighted mean from the frame-carry statistics -> (kappa, zita)."""
    zita = zita0 + z.sum(dim=-2)[..., None, :]
    kappa = (zita0 * kappa0 + torch.matmul(x.transpose(1, 2)[:, None, None], z)) / zita
    return kappa, zita


def w_step(xn, kappa, masks, tau: float):
    """Pixel weights = mask * (1 - branch probability); xn is l2-normalized x."""
    z = torch.matmul(xn[:, None, None], l2norm(kappa, -2))
    maxes = z.amax(dim=-1, keepdim=True).amax(dim=2, keepdim=True)
    sum_exp = torch.exp((z - maxes) / tau).sum(dim=-1)
    props = sum_exp / sum_exp.sum(dim=2, keepdim=True)
    return masks * (1.0 - props)


def em_loop_plain(x, masks, kappa0, zita0, *, n_iters: int, tau: float):
    """The W/E/M loop in plain PyTorch -> (z, kappa, zita)."""
    xn = l2norm(x, -1)
    weights, kappa, z, zita = masks, kappa0, None, zita0
    for i in range(n_iters):
        z = e_step(x, kappa, weights, tau)
        kappa, zita = m_step(z, x, kappa0, zita0)
        if i < n_iters - 1:
            weights = w_step(xn, kappa, masks, tau)
    return z, kappa, zita


def _lib():
    lib = build.load("em_loop")
    fn = lib.swem_em_loop
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.swem_em_loop_error.argtypes = [ctypes.c_int]
        lib.swem_em_loop_error.restype = ctypes.c_char_p
    return lib


def smem_bytes(Ck: int, L: int) -> int:
    """Shared memory of one CTA of the kernel (``Smem`` in ``csrc/em_loop.cu``)."""
    def up(v, m):
        return -(-v // m) * m
    p_a, p_t, p_s = up(Ck, 32) + 4, TILE + 4, up(2 * L, 32) + 8
    return 4 * (2 * TILE * p_a + 2 * Ck * p_t + max(TILE * p_s, 4 * (Ck + 2)) + TILE)


def _barrier(device: torch.device, stream: int) -> torch.Tensor:
    """The grid barrier's counter for launches on ``stream``: zeroed once, and
    every launch leaves it as it found it."""
    key = (device.index, stream)
    if key not in _barriers:
        _barriers[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _barriers[key]


def em_loop(x: torch.Tensor, masks: torch.Tensor, kappa0: torch.Tensor,
            zita0: torch.Tensor, *, n_iters: int, tau: float
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the EM loop. x (B,P,Ck); masks (B,N,2,P); kappa0 (B,N,2,Ck,L);
    zita0 (B,N,2,1,L), all float32 -> (z (B,N,2,P,L), kappa, zita).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises. The kernel takes Ck divisible by 16, L divisible by 8, and
    shapes whose tile fits one block's shared memory. It has no backward (the
    loop runs under ``no_grad`` in ``em_update``): an input that requires
    grad raises while gradients are enabled.
    """
    if x.device.type == "cpu":
        return em_loop_plain(x, masks, kappa0, zita0, n_iters=n_iters, tau=tau)
    build.refuse_gradients("em_loop", "swem_tpu/ops/em_pallas.py", x=x, masks=masks,
                           kappa0=kappa0, zita0=zita0)
    B, P, Ck = x.shape
    N, L = masks.shape[1], kappa0.shape[-1]
    if Ck % 16 or L % 8 or Ck < 16 or L < 8:
        raise ValueError(f"em_loop: the kernel takes Ck divisible by 16 and L divisible by 8, "
                         f"got Ck={Ck}, L={L}")
    if smem_bytes(Ck, L) > MAX_SMEM:
        raise ValueError(f"em_loop: the kernel takes shapes whose tile fits {MAX_SMEM} bytes of "
                         f"shared memory, got Ck={Ck}, L={L}: {smem_bytes(Ck, L)} bytes")
    expect = {"x": (B, P, Ck), "masks": (B, N, 2, P), "kappa0": (B, N, 2, Ck, L),
              "zita0": (B, N, 2, 1, L)}
    for name, t in zip(expect, (x, masks, kappa0, zita0)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"em_loop: {name} is on {t.device}, expected {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"em_loop: {name} is {t.dtype}, expected float32")
        if tuple(t.shape) != expect[name]:
            raise ValueError(f"em_loop: {name} has shape {tuple(t.shape)}, expected {expect[name]}")
    if n_iters < 1:
        raise ValueError("em_loop: n_iters must be >= 1")
    x, masks, kappa0, zita0 = (t.contiguous() for t in (x, masks, kappa0, zita0))
    if x.data_ptr() % 16:  # the kernel reads x in 16-byte vectors
        x = x.clone()
    n_tiles = -(-P // TILE)
    dev = x.device
    z = torch.empty((B, N, 2, P, L), device=dev)
    kappa = torch.empty_like(kappa0)
    zita = torch.empty_like(zita0)
    khat = torch.empty((B, N, Ck, 2 * L), device=dev)
    part = torch.empty((B, N, n_tiles, 2 * L, Ck), device=dev)
    zpart = torch.empty((B, N, n_tiles, 2 * L), device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.swem_em_loop(
            x.data_ptr(), masks.data_ptr(), kappa0.data_ptr(), zita0.data_ptr(), z.data_ptr(),
            kappa.data_ptr(), zita.data_ptr(), khat.data_ptr(), part.data_ptr(),
            zpart.data_ptr(), _barrier(dev, stream).data_ptr(),
            B, N, P, Ck, L, n_iters, tau, stream,
        )
    if err != 0:
        raise RuntimeError(f"em_loop kernel failed to launch: CUDA error {err} "
                           f"({lib.swem_em_loop_error(err).decode()})")
    global launches
    launches += 1
    return z, kappa, zita
