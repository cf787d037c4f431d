"""The fused memory read: CUDA kernel, its wrapper and its plain version.

Counterpart of ``swem_tpu/ops/read_pallas.py`` (the kernel ``_read_kernel``)
and of the affinity/softmax/value-read part of
``swem_tpu/models/em.py::read_memory``. ``read_affinity`` is the
l2-normalization of the keys (PyTorch ops, outside the kernel as they are
outside the TPU kernel) followed by ``read_normalized``, which takes the
plain PyTorch version for a CPU tensor and launches ``csrc/read_memory.cu``
(tensor cores, 3xTF32) for a CUDA tensor; there is no other route. The
source note in ``csrc/read_memory.cu`` says what bounds the kernel and how
it is built.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from swem_tpu_torch.ops import build
from swem_tpu_torch.ops.em_kernel import l2norm

launches = 0  # wrapper calls that launched the kernel


def read_plain(qk, mk, mv, base_valid, *, tau: float):
    """qk (B,P,Ck) and mk (B,N,2,Ck,Lm) l2-normalized; mv (B,N,2,Cv,Lm);
    base_valid (B,N,2,Lm) bool -> (mem_out (B,N,P,Cv), exp_aff (B,N,2,Lm,P))."""
    aff = torch.matmul(mk.transpose(-1, -2), qk.transpose(1, 2)[:, None, None])  # (B,N,2,Lm,P)
    valid = base_valid[..., None]
    aff = aff.masked_fill(~valid, float("-inf"))
    maxes = aff.amax(dim=(2, 3), keepdim=True)  # joint over {bg,fg} x Lm
    # the where also guards an object with no valid base (max = -inf -> nan)
    exp_aff = torch.where(valid, torch.exp((aff - maxes) / tau), 0.0)
    p_aff = exp_aff / (exp_aff.sum(dim=(2, 3), keepdim=True) + 1e-30)
    # sum over (s, l) of mv[b,n,s,v,l] p_aff[b,n,s,l,p] -> (B,N,P,Cv)
    mem_out = torch.einsum("bnsvl,bnslp->bnpv", mv, p_aff)
    return mem_out, exp_aff


def _lib():
    lib = build.load("read_memory")
    fn = lib.swem_read_memory
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.swem_read_memory_error.argtypes = [ctypes.c_int]
        lib.swem_read_memory_error.restype = ctypes.c_char_p
    return lib


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous, starting on a 16-byte boundary (the kernel's cp.async copies)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def read_normalized(qk: torch.Tensor, mk: torch.Tensor, mv: torch.Tensor,
                    base_valid: torch.Tensor, *, tau: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Affinity + masked joint softmax + value read on l2-normalized keys.

    qk (B,P,Ck) and mk (B,N,2,Ck,Lm) l2-normalized; mv (B,N,2,Cv,Lm) float32;
    base_valid (B,N,2,Lm) bool -> (mem_out (B,N,P,Cv), exp_aff (B,N,2,Lm,P)).
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises. The kernel takes Ck and Lm divisible by 4 and 2 * Lm <= 1024,
    and has no backward: an input that requires grad raises while gradients
    are enabled.
    """
    if qk.device.type == "cpu":
        return read_plain(qk, mk, mv, base_valid, tau=tau)
    build.refuse_gradients("read_memory", "swem_tpu/ops/read_pallas.py", qk=qk, mk=mk, mv=mv)
    B, P, Ck = qk.shape
    N, Lm, Cv = mk.shape[1], mk.shape[-1], mv.shape[3]
    expect = {"qk": ((B, P, Ck), torch.float32), "mk": ((B, N, 2, Ck, Lm), torch.float32),
              "mv": ((B, N, 2, Cv, Lm), torch.float32), "base_valid": ((B, N, 2, Lm), torch.bool)}
    if Ck % 4 or Lm % 4 or not 0 < 2 * Lm <= 1024:
        raise ValueError(f"read_normalized: the kernel takes Ck and Lm divisible by 4 and "
                         f"2 * Lm <= 1024, got Ck={Ck}, Lm={Lm}")
    for name, t in zip(expect, (qk, mk, mv, base_valid)):
        shape, dtype = expect[name]
        if t.device != qk.device or t.device.type != "cuda":
            raise ValueError(f"read_normalized: {name} is on {t.device}, expected {qk.device}")
        if t.dtype != dtype:
            raise TypeError(f"read_normalized: {name} is {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(
                f"read_normalized: {name} has shape {tuple(t.shape)}, expected {shape}")
    qk, mk, mv = (_aligned(t) for t in (qk, mk, mv))
    valid = base_valid.contiguous().view(torch.uint8)
    mem_out = torch.empty((B, N, P, Cv), device=qk.device)
    exp_aff = torch.empty((B, N, 2, Lm, P), device=qk.device)
    lib = _lib()
    with torch.cuda.device(qk.device):
        err = lib.swem_read_memory(
            qk.data_ptr(), mk.data_ptr(), mv.data_ptr(), valid.data_ptr(), mem_out.data_ptr(),
            exp_aff.data_ptr(), B, 2 * N, P, Ck, Cv, Lm, tau,
            torch.cuda.current_stream(qk.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"read_memory kernel failed to launch: CUDA error {err} "
                           f"({lib.swem_read_memory_error(err).decode()})")
    global launches
    launches += 1
    return mem_out, exp_aff


def read_affinity(qk: torch.Tensor, mk: torch.Tensor, mv: torch.Tensor,
                  base_valid: torch.Tensor, *, tau: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``read_normalized`` on raw keys: qk (B,P,Ck), mk (B,N,2,Ck,Lm)."""
    return read_normalized(l2norm(qk, -1), l2norm(mk, -2), mv, base_valid, tau=tau)
