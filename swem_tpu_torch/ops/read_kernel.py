"""The fused memory read: CUDA kernel, its custom op and its plain version.

Counterpart of ``swem_tpu/ops/read_pallas.py`` (the kernel ``_read_kernel``)
and of the affinity/softmax/value-read part of
``swem_tpu/models/em.py::read_memory``. ``read_affinity`` is the
l2-normalization of the keys (PyTorch ops, outside the kernel as they are
outside the TPU kernel) followed by ``read_normalized``, which calls the
PyTorch custom op ``swem_tpu_torch::read_normalized``: the plain PyTorch
version for a CPU tensor, ``csrc/read_memory.cu`` (tensor cores, 3xTF32)
for a CUDA tensor; there is no other route. As an op, the read is one node
of a ``torch.export`` graph (``io/export.py``). The source note in
``csrc/read_memory.cu`` says what bounds the kernel and how it is built.

The kernel takes Ck and Lm in multiples of 4; ``pad_read`` pads any other
width exactly inside the op (zero key channels; padded bases invalid, which
the kernel already masks), and ``exp_aff`` is cut back.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from swem_tpu_torch.ops import build
from swem_tpu_torch.ops.em_kernel import l2norm

MULT = 4  # the kernel's multiple of Ck and Lm
MAX_SMEM = 232448  # dynamic shared memory of one H100 block
launches = 0  # host launches of the kernel: a CUDA graph counts its capture, not its replays


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


def pad_read(qk, mk, mv, base_valid):
    """The read's inputs padded to the kernel's multiples: Ck rounds up to 4
    with zero channels of qk and mk, Lm to 4 with zero bases of mk and mv
    that ``base_valid`` marks invalid."""
    dc, dl = -qk.shape[-1] % MULT, -mk.shape[-1] % MULT
    if dc:
        qk = F.pad(qk, (0, dc))
    if dc or dl:
        mk = F.pad(mk, (0, dl, 0, dc))
    if dl:
        mv = F.pad(mv, (0, dl))
        base_valid = torch.cat([base_valid, base_valid.new_zeros(base_valid.shape[:-1] + (dl,))],
                               dim=-1)
    return qk, mk, mv, base_valid


def smem_bytes(Ck: int, rows: int = 32, w2p: int = 1024, kc: int = 16) -> int:
    """Shared memory of one CTA of the kernel's tiling (``Tiling`` in
    ``csrc/read_memory.cu``; the defaults are the 1024-column tiling that
    takes every Lm, in column blocks) at a Ck already a multiple of 4."""
    def up(v, m):
        return -(-v // m) * m
    cols, vp, warps = 256, 36, 16
    region_u = max(rows * (up(Ck, kc) + 4), 2 * cols * vp)
    region_sk = max(rows * (w2p + 4), 2 * kc * (w2p + 8))
    red = warps // (rows // 32) * rows + 2 * rows
    return 4 * (region_u + region_sk + red)


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


def _check(qk, mk, mv, base_valid) -> None:
    """Raise on inputs the kernel does not take: another device than one
    CUDA device, another dtype, inconsistent shapes, or a Ck whose query tile
    fits no block's shared memory."""
    B, P, Ck = qk.shape
    N, Lm, Cv = mk.shape[1], mk.shape[-1], mv.shape[3]
    if smem_bytes(Ck + -Ck % MULT) > MAX_SMEM or Lm < 1:
        raise ValueError(f"read_normalized: the kernel takes Lm >= 1 and Ck whose 32-pixel "
                         f"query tile fits {MAX_SMEM} bytes of shared memory, got Ck={Ck}, "
                         f"Lm={Lm}")
    expect = {"qk": ((B, P, Ck), torch.float32), "mk": ((B, N, 2, Ck, Lm), torch.float32),
              "mv": ((B, N, 2, Cv, Lm), torch.float32), "base_valid": ((B, N, 2, Lm), torch.bool)}
    for name, t in zip(expect, (qk, mk, mv, base_valid)):
        shape, dtype = expect[name]
        if t.device != qk.device or t.device.type != "cuda":
            raise ValueError(f"read_normalized: {name} is on {t.device}, expected {qk.device}")
        if t.dtype != dtype:
            raise TypeError(f"read_normalized: {name} is {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(
                f"read_normalized: {name} has shape {tuple(t.shape)}, expected {shape}")


def _launch(qk, mk, mv, base_valid, tau: float):
    """The kernel on padded inputs; ``exp_aff`` cut back to the real Lm."""
    _check(qk, mk, mv, base_valid)
    B, P, _ = qk.shape
    N, Lm, Cv = mk.shape[1], mk.shape[-1], mv.shape[3]
    qk, mk, mv, base_valid = pad_read(qk, mk, mv, base_valid)
    Ck, Lp = qk.shape[-1], mk.shape[-1]
    qk, mk, mv = (_aligned(t) for t in (qk, mk, mv))
    valid = base_valid.contiguous().view(torch.uint8)
    mem_out = torch.empty((B, N, P, Cv), device=qk.device)
    exp_aff = torch.empty((B, N, 2, Lp, P), device=qk.device)
    lib = _lib()
    with torch.cuda.device(qk.device):
        err = lib.swem_read_memory(
            qk.data_ptr(), mk.data_ptr(), mv.data_ptr(), valid.data_ptr(), mem_out.data_ptr(),
            exp_aff.data_ptr(), B, 2 * N, P, Ck, Cv, Lp, tau,
            torch.cuda.current_stream(qk.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"read_memory kernel failed to launch: CUDA error {err} "
                           f"({lib.swem_read_memory_error(err).decode()})")
    global launches
    launches += 1
    if Lp != Lm:
        exp_aff = exp_aff[..., :Lm, :].contiguous()
    return mem_out, exp_aff


@torch.library.custom_op("swem_tpu_torch::read_normalized", mutates_args=())
def read_op(qk: torch.Tensor, mk: torch.Tensor, mv: torch.Tensor, base_valid: torch.Tensor,
            tau: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The read as a custom op: the plain version on a CPU tensor, the
    kernel on a CUDA tensor, or an exception. Outputs are fresh tensors."""
    if qk.device.type == "cpu":
        return read_plain(qk, mk, mv, base_valid, tau=tau)
    return _launch(qk, mk, mv, base_valid, tau)


@read_op.register_fake
def _(qk, mk, mv, base_valid, tau):
    B, P, _ = qk.shape
    N, Lm, Cv = mk.shape[1], mk.shape[-1], mv.shape[3]
    return qk.new_empty((B, N, P, Cv)), qk.new_empty((B, N, 2, Lm, P))


def read_normalized(qk: torch.Tensor, mk: torch.Tensor, mv: torch.Tensor,
                    base_valid: torch.Tensor, *, tau: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Affinity + masked joint softmax + value read on l2-normalized keys.

    qk (B,P,Ck) and mk (B,N,2,Ck,Lm) l2-normalized; mv (B,N,2,Cv,Lm) float32;
    base_valid (B,N,2,Lm) bool -> (mem_out (B,N,P,Cv), exp_aff (B,N,2,Lm,P)).
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises, checked here before the op is called. Any Lm (above 512
    columns of 2 Lm the kernel reads in column blocks) and any Ck whose
    query tile fits shared memory (Ck <= 752). No backward: on the card an
    input that requires grad raises while gradients are enabled.
    """
    if qk.device.type != "cpu":
        build.refuse_gradients("read_memory", "swem_tpu/ops/read_pallas.py", qk=qk, mk=mk, mv=mv)
        _check(qk, mk, mv, base_valid)
    return read_op(qk, mk, mv, base_valid, tau)


def read_affinity(qk: torch.Tensor, mk: torch.Tensor, mv: torch.Tensor,
                  base_valid: torch.Tensor, *, tau: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``read_normalized`` on raw keys: qk (B,P,Ck), mk (B,N,2,Ck,Lm)."""
    return read_normalized(l2norm(qk, -1), l2norm(mk, -2), mv, base_valid, tau=tau)
