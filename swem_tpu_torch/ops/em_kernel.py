"""The EM loop of one memorize: CUDA kernel, its custom op and its plain version.

Counterpart of ``swem_tpu/ops/em_pallas.py`` (the kernel ``_em_kernel``) and
of the loop inside ``swem_tpu/models/em.py::em_update``. ``em_loop`` calls
the PyTorch custom op ``swem_tpu_torch::em_loop``, which takes the plain
PyTorch version for a CPU tensor and launches ``csrc/em_loop.cu`` (one
cooperative launch, tensor cores in 3xTF32) for a CUDA tensor; there is no
other route. As an op, the loop is one node of a ``torch.export`` graph
(``io/export.py``), and a replayed graph launches the kernel, and counts the
launch, as the live call does. The source note in ``csrc/em_loop.cu`` says
what bounds the kernel and how it is built.

The kernel takes Ck in multiples of 16 and L in multiples of 8; ``pad_em``
pads any other width exactly inside the op (zero key channels leave every
dot product and norm as it was; the padded bases are masked out of the
loop's softmaxes by the count of real bases), and the outputs are cut back.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from swem_tpu_torch.ops import build

TILES = (32, 16)  # pixels per tile item of the kernel: the widest whose CTA fits
CK_MULT, L_MULT = 16, 8  # the kernel's multiples of Ck and L
MAX_SMEM = 232448  # dynamic shared memory of one H100 block
launches = 0  # host launches of the kernel: a CUDA graph counts its capture, not its replays
_barriers: Dict[Tuple[int, int], torch.Tensor] = {}  # (device, stream) -> grid barrier counter


def l2norm(x: torch.Tensor, dim: int) -> torch.Tensor:
    """L2-normalize with the reference's +1e-6 denominator."""
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + 1e-6)


def _mask_bases(logits: torch.Tensor, n_bases: Optional[int]) -> torch.Tensor:
    """-inf on the bases past the first ``n_bases`` (padding): they take no
    mass in a softmax over the last axis."""
    if n_bases is None or n_bases == logits.shape[-1]:
        return logits
    pad = torch.arange(logits.shape[-1], device=logits.device) >= n_bases
    return logits.masked_fill(pad, float("-inf"))


def e_step(x, kappa, weights, tau: float, n_bases: Optional[int] = None):
    """x (B,P,Ck); kappa (B,N,2,Ck,L); weights (B,N,2,P) -> z (B,N,2,P,L);
    bases past ``n_bases`` get z = 0."""
    logits = _mask_bases(torch.matmul(x[:, None, None], l2norm(kappa, -2)), n_bases)
    return torch.softmax(logits / tau, dim=-1) * weights[..., None]


def m_step(z, x, kappa0, zita0):
    """Running weighted mean from the frame-carry statistics -> (kappa, zita)."""
    zita = zita0 + z.sum(dim=-2)[..., None, :]
    kappa = (zita0 * kappa0 + torch.matmul(x.transpose(1, 2)[:, None, None], z)) / zita
    return kappa, zita


def w_step(xn, kappa, masks, tau: float, n_bases: Optional[int] = None):
    """Pixel weights = mask * (1 - branch probability); xn is l2-normalized x;
    bases past ``n_bases`` take no part."""
    z = _mask_bases(torch.matmul(xn[:, None, None], l2norm(kappa, -2)), n_bases)
    maxes = z.amax(dim=-1, keepdim=True).amax(dim=2, keepdim=True)
    sum_exp = torch.exp((z - maxes) / tau).sum(dim=-1)
    props = sum_exp / sum_exp.sum(dim=2, keepdim=True)
    return masks * (1.0 - props)


def em_loop_plain(x, masks, kappa0, zita0, *, n_iters: int, tau: float,
                  n_bases: Optional[int] = None):
    """The W/E/M loop in plain PyTorch -> (z, kappa, zita). ``n_bases``: the
    count of real bases when the last ones are ``pad_em``'s padding."""
    xn = l2norm(x, -1)
    weights, kappa, z, zita = masks, kappa0, None, zita0
    for i in range(n_iters):
        z = e_step(x, kappa, weights, tau, n_bases)
        kappa, zita = m_step(z, x, kappa0, zita0)
        if i < n_iters - 1:
            weights = w_step(xn, kappa, masks, tau, n_bases)
    return z, kappa, zita


def pad_em(x, masks, kappa0, zita0):
    """The loop's inputs padded to the kernel's multiples -> (x, masks,
    kappa0, zita0, real L). Ck rounds up to 16 with zero channels of x and
    kappa0; L up to 8 with bases of kappa0 = 0 and zita0 = 1, which stay 0
    through the M step (0 / 1) once the count of real bases keeps them out
    of both softmaxes."""
    Ck, L = x.shape[-1], kappa0.shape[-1]
    dc, dl = -Ck % CK_MULT, -L % L_MULT
    if dc:
        x = F.pad(x, (0, dc))
    if dc or dl:
        kappa0 = F.pad(kappa0, (0, dl, 0, dc))
    if dl:
        zita0 = F.pad(zita0, (0, dl), value=1.0)
    return x, masks, kappa0, zita0, L


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``csrc/em_loop.cu`` on ``lib``."""
    fn = lib.swem_em_loop
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.swem_em_loop_error.argtypes = [ctypes.c_int]
        lib.swem_em_loop_error.restype = ctypes.c_char_p
    return lib


def _lib():
    return bind(build.load("em_loop"))


def smem_bytes(Ck: int, L: int, tile: int = TILES[0]) -> int:
    """Shared memory of one CTA at ``tile`` pixels (``Smem`` in ``csrc/em_loop.cu``),
    for Ck and L already at the kernel's multiples."""
    def up(v, m):
        return -(-v // m) * m
    p_a, p_t, p_s = up(Ck, 32) + 4, tile + 4, up(2 * L, 32) + 8
    return 4 * (2 * tile * p_a + 2 * Ck * p_t + max(tile * p_s, 4 * (Ck + 2)) + tile)


def kernel_tile(Ck: int, L: int) -> Optional[int]:
    """The tile the kernel takes at (Ck, L) (any widths: they are padded
    first), or None where no tile's CTA fits a block's shared memory."""
    Ck, L = Ck + -Ck % CK_MULT, L + -L % L_MULT
    return next((t for t in TILES if smem_bytes(Ck, L, t) <= MAX_SMEM), None)


def _barrier(device: torch.device, stream: int) -> torch.Tensor:
    """The grid barrier's counter for launches on ``stream``: zeroed once, and
    every launch leaves it as it found it."""
    key = (device.index, stream)
    if key not in _barriers:
        _barriers[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _barriers[key]


def _check(x, masks, kappa0, zita0, n_iters: int) -> None:
    """Raise on inputs the kernel does not take: another device than one
    CUDA device, another dtype than float32, inconsistent shapes, or widths
    whose CTA fits no block's shared memory."""
    B, P, Ck = x.shape
    N, L = masks.shape[1], kappa0.shape[-1]
    if kernel_tile(Ck, L) is None:
        raise ValueError(f"em_loop: the kernel takes shapes whose {TILES[-1]}-pixel tile fits "
                         f"{MAX_SMEM} bytes of shared memory, got Ck={Ck}, L={L}")
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


def _launch(x, masks, kappa0, zita0, n_iters: int, tau: float):
    """The kernel on padded inputs; outputs cut back to the real widths."""
    _check(x, masks, kappa0, zita0, n_iters)
    Ck, L = x.shape[-1], kappa0.shape[-1]
    tile = kernel_tile(Ck, L)
    x, masks, kappa0, zita0, _ = pad_em(*(t.contiguous() for t in (x, masks, kappa0, zita0)))
    if x.data_ptr() % 16:  # the kernel reads x in 16-byte vectors
        x = x.clone()
    B, P, Cp = x.shape
    N, Lp = masks.shape[1], kappa0.shape[-1]
    n_tiles = -(-P // tile)
    dev = x.device
    z = torch.empty((B, N, 2, P, Lp), device=dev)
    kappa = torch.empty_like(kappa0)
    zita = torch.empty_like(zita0)
    khat = torch.empty((B, N, Cp, 2 * Lp), device=dev)
    part = torch.empty((B, N, n_tiles, 2 * Lp, Cp), device=dev)
    zpart = torch.empty((B, N, n_tiles, 2 * Lp), device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.swem_em_loop(
            x.data_ptr(), masks.data_ptr(), kappa0.data_ptr(), zita0.data_ptr(), z.data_ptr(),
            kappa.data_ptr(), zita.data_ptr(), khat.data_ptr(), part.data_ptr(),
            zpart.data_ptr(), _barrier(dev, stream).data_ptr(),
            B, N, P, Cp, Lp, L, tile, n_iters, tau, stream,
        )
    if err != 0:
        raise RuntimeError(f"em_loop kernel failed to launch: CUDA error {err} "
                           f"({lib.swem_em_loop_error(err).decode()})")
    global launches
    launches += 1
    if (Cp, Lp) != (Ck, L):
        z, kappa, zita = (z[..., :L].contiguous(), kappa[..., :Ck, :L].contiguous(),
                          zita[..., :L].contiguous())
    return z, kappa, zita


@torch.library.custom_op("swem_tpu_torch::em_loop", mutates_args=())
def em_loop_op(x: torch.Tensor, masks: torch.Tensor, kappa0: torch.Tensor,
               zita0: torch.Tensor, n_iters: int, tau: float
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The loop as a custom op: the plain version on a CPU tensor, the kernel
    on a CUDA tensor, or an exception. Outputs are fresh tensors."""
    if x.device.type == "cpu":
        if n_iters < 1:
            raise ValueError("em_loop: n_iters must be >= 1")
        return em_loop_plain(x, masks, kappa0, zita0, n_iters=n_iters, tau=tau)
    return _launch(x, masks, kappa0, zita0, n_iters, tau)


@em_loop_op.register_fake
def _(x, masks, kappa0, zita0, n_iters, tau):
    B, P, _ = x.shape
    return (x.new_empty((B, masks.shape[1], 2, P, kappa0.shape[-1])), torch.empty_like(kappa0),
            torch.empty_like(zita0))


def em_loop(x: torch.Tensor, masks: torch.Tensor, kappa0: torch.Tensor,
            zita0: torch.Tensor, *, n_iters: int, tau: float
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the EM loop. x (B,P,Ck); masks (B,N,2,P); kappa0 (B,N,2,Ck,L);
    zita0 (B,N,2,1,L), all float32 -> (z (B,N,2,P,L), kappa, zita).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises, checked here before the op is called (so a trace on the
    card's fake tensors checks too). Any Ck and L whose padded 16-pixel
    tile fits one block's shared memory (``kernel_tile``). No backward (the
    loop runs under ``no_grad`` in ``em_update``): on the card an input that
    requires grad raises while gradients are enabled.
    """
    if x.device.type != "cpu":
        build.refuse_gradients("em_loop", "swem_tpu/ops/em_pallas.py", x=x, masks=masks,
                               kappa0=kappa0, zita0=zita0)
        _check(x, masks, kappa0, zita0, n_iters)
    return em_loop_op(x, masks, kappa0, zita0, n_iters, tau)
