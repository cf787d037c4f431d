"""The EM loop of one memorize: CUDA kernel, its wrapper and its plain version.

Counterpart of ``swem_tpu/ops/em_pallas.py`` (the kernel ``_em_kernel``) and
of the loop inside ``swem_tpu/models/em.py::em_update``. ``em_loop`` takes
the plain PyTorch version for a CPU tensor and launches
``csrc/em_loop.cu`` for a CUDA tensor; there is no other route. The source
note in ``csrc/em_loop.cu`` says what bounds the kernel and how it is built.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from swem_tpu_torch.ops import build

P_CHUNK = 128  # pixels per partial M-step sum in the kernel
launches = 0  # wrapper calls that launched the kernel


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
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def em_loop(x: torch.Tensor, masks: torch.Tensor, kappa0: torch.Tensor,
            zita0: torch.Tensor, *, n_iters: int, tau: float
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the EM loop. x (B,P,Ck); masks (B,N,2,P); kappa0 (B,N,2,Ck,L);
    zita0 (B,N,2,1,L), all float32 -> (z (B,N,2,P,L), kappa, zita).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    if x.device.type == "cpu":
        return em_loop_plain(x, masks, kappa0, zita0, n_iters=n_iters, tau=tau)
    B, P, Ck = x.shape
    N, L = masks.shape[1], kappa0.shape[-1]
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
    n_chunks = -(-P // P_CHUNK)
    z = torch.empty((B, N, 2, P, L), device=x.device)
    kappa = torch.empty_like(kappa0)
    zita = torch.empty_like(zita0)
    part = torch.empty((B, 2 * N, n_chunks, Ck, L), device=x.device)
    zpart = torch.empty((B, 2 * N, n_chunks, L), device=x.device)
    err = _lib()(
        x.data_ptr(), masks.data_ptr(), kappa0.data_ptr(), zita0.data_ptr(), z.data_ptr(),
        kappa.data_ptr(), zita.data_ptr(), part.data_ptr(), zpart.data_ptr(),
        B, 2 * N, P, Ck, L, n_iters, tau, P_CHUNK,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"em_loop kernel failed to launch: CUDA error {err}")
    global launches
    launches += 1
    return z, kappa, zita
