"""Shared conv building blocks (NCHW), counterparts of ``swem_tpu/models/layers.py``.

Attribute names follow the reference SWEM implementation's torch
``state_dict`` keys (``ChannelGate.mlp.1``, ``SpatialGate.spatial.conv``,
``downsample``), so ``io/jax_import.py`` maps weights by renaming alone.

Every module takes a compute ``dtype``, as the JAX package's flax modules
do: convolutions and linear layers cast their input, kernel and bias to it,
and the parameters stay float32. The prepared parameters (a kernel or bias
cast to the compute dtype, a batch norm folded) are kept across calls
(``prepared``) wherever autograd and ``torch.compile``/``torch.export``
need not see the preparation. While tracing, the counter
``models.param_preps`` counts each parameter tensor prepared on a call (a
miss), ``models.param_cache_hits`` each one reused.
"""

from __future__ import annotations

from operator import attrgetter, is_
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from swem_tpu_torch.ops.resize import resize_nchw
from swem_tpu_torch.utils.profiling import count, tracing

PREPS, HITS = "models.param_preps", "models.param_cache_hits"
_version = attrgetter("_version")


def stamp_of(sources) -> tuple:
    """The versions and data pointers of the tensors ``sources``: what was
    made from them is stale once their stamp changes (an in-place update
    such as ``load_state_dict`` or an optimizer step bumps a version,
    ``.to`` moves the data). Raises RuntimeError on an inference tensor,
    which tracks no version."""
    return tuple(map(_version, sources)), tuple(map(torch.Tensor.data_ptr, sources))


def keeps_prepared(sources) -> bool:
    """Whether tensors prepared from ``sources`` may be kept across calls:
    not while ``torch.compile`` or ``torch.export`` traces (the parameters
    stay inputs of the program, ``io/export.py``), nor where autograd
    records the preparation (gradients on and a source that requires them)."""
    if torch.compiler.is_compiling():
        return False
    return not torch.is_grad_enabled() or not any(t.requires_grad for t in sources)


def prepared(store: Dict[str, tuple], slot: str, dtype: torch.dtype, sources: tuple,
             make: Callable[[], tuple], n: int) -> tuple:
    """``make()``'s tensors, prepared from ``sources`` for compute dtype
    ``dtype``, kept in ``store[slot]`` and reused while the sources are the
    same tensors, on the same device, at the same versions and data
    pointers. ``n`` is the count of parameter tensors a call prepares or
    reuses, for the counters.

    An in-place update (``load_state_dict``, an optimizer step) bumps a
    version, ``.to(device)`` moves the data, and a copied model holds other
    tensors: each misses and prepares again. A kept tensor is made outside
    ``torch.inference_mode`` and without gradients, so it may meet autograd
    later. Where ``keeps_prepared`` says no, every call prepares (the path
    of training with gradients on, and of an export trace)."""
    if keeps_prepared(sources):
        try:
            stamp = (dtype, sources[0].device, stamp_of(sources))
        except RuntimeError:  # an inference tensor tracks no version: prepare per call
            stamp = None
        if stamp is not None:
            entry = store.get(slot)
            if entry is not None and entry[1] == stamp and all(map(is_, entry[0], sources)):
                if tracing():
                    count(HITS, n)
                return entry[2]
            if tracing():
                count(PREPS, n)
            with torch.inference_mode(False), torch.no_grad():
                out = make()
            store[slot] = (sources, stamp, out)
            return out
    if tracing():
        count(PREPS, n)
    return make()


def cast_params(store: Dict[str, tuple], slot: str, dtype: torch.dtype, weight: torch.Tensor,
                bias: Optional[torch.Tensor], cols: Optional[slice] = None):
    """``weight`` (its input channels ``cols``, when given) and ``bias``
    (None: absent) cast to ``dtype``, kept across calls; parameters already
    in ``dtype`` are used as they are."""
    if weight.dtype == dtype and (bias is None or bias.dtype == dtype):
        return (weight if cols is None else weight[:, cols]), bias

    def make():
        w = weight if cols is None else weight[:, cols]
        return w.to(dtype), (None if bias is None else bias.to(dtype))

    sources = (weight,) if bias is None else (weight, bias)
    return prepared(store, slot, dtype, sources, make, len(sources))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype`` (flax's ``nn.Conv(dtype=...)``)."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype
        self._prepared = {}

    def forward(self, x):
        dt = self.compute_dtype
        w, b = cast_params(self._prepared, "params", dt, self.weight, self.bias)
        return self._conv_forward(x.to(dt), w, b)


class Linear(nn.Linear):
    """``nn.Linear`` that computes in ``compute_dtype`` (flax's ``nn.Dense(dtype=...)``)."""

    def __init__(self, cin: int, cout: int, compute_dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout)
        self.compute_dtype = compute_dtype
        self._prepared = {}

    def forward(self, x):
        dt = self.compute_dtype
        w, b = cast_params(self._prepared, "params", dt, self.weight, self.bias)
        return F.linear(x.to(dt), w, b)


def conv3x3(cin: int, cout: int, stride: int = 1, bias: bool = True,
            dtype: torch.dtype = torch.float32) -> Conv2d:
    return Conv2d(cin, cout, 3, stride=stride, padding=1, bias=bias, compute_dtype=dtype)


def conv1x1(cin: int, cout: int, stride: int = 1, bias: bool = True,
            dtype: torch.dtype = torch.float32) -> Conv2d:
    return Conv2d(cin, cout, 1, stride=stride, bias=bias, compute_dtype=dtype)


class FrozenBatchNorm(nn.Module):
    """BatchNorm permanently in inference mode, folded to one multiply-add.

    ``weight``/``bias`` are parameters, ``running_mean``/``running_var``
    buffers (no ``num_batches_tracked``: the statistics never update). The
    fold, cast to the input's dtype, is kept across calls (``prepared``).
    """

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self._prepared = {}

    def _fold(self, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """Scale and shift (C, 1, 1) in ``dtype``, folded in float32."""
        w = self.weight * torch.rsqrt(self.running_var + self.eps)
        b = self.bias - self.running_mean * w
        return w.to(dtype)[:, None, None], b.to(dtype)[:, None, None]

    def forward(self, x):
        dt = x.dtype
        w, b = prepared(self._prepared, "fold", dt,
                        (self.weight, self.bias, self.running_mean, self.running_var),
                        lambda: self._fold(dt), 1)
        return x * w + b


class ResBlock(nn.Module):
    """Pre-activation residual block: x + conv2(relu(conv1(relu(x))))."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = conv3x3(cin, cout, dtype=dtype)
        self.conv2 = conv3x3(cout, cout, dtype=dtype)
        self.downsample = conv3x3(cin, cout, dtype=dtype) if cin != cout else None

    def forward(self, x):
        r = self.conv2(F.relu(self.conv1(F.relu(x))))
        if self.downsample is not None:
            x = self.downsample(x)
        return x + r


class ChannelGate(nn.Module):
    """CBAM channel attention."""

    def __init__(self, features: int, reduction: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = nn.Sequential(
            nn.Flatten(), Linear(features, features // reduction, dtype), nn.ReLU(),
            Linear(features // reduction, features, dtype),
        )

    def forward(self, x):
        att = self.mlp(x.mean(dim=(-2, -1))) + self.mlp(x.amax(dim=(-2, -1)))
        return x * torch.sigmoid(att)[:, :, None, None]


class _SpatialConv(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(2, 1, 7, padding=3, compute_dtype=dtype)

    def forward(self, x):
        return self.conv(x)


class SpatialGate(nn.Module):
    """CBAM spatial attention: 7x7 conv over [max_c, mean_c]."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spatial = _SpatialConv(dtype)

    def forward(self, x):
        pooled = torch.cat([x.amax(dim=1, keepdim=True), x.mean(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.spatial(pooled))


class CBAM(nn.Module):
    def __init__(self, features: int, reduction: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ChannelGate = ChannelGate(features, reduction, dtype)
        self.SpatialGate = SpatialGate(dtype)

    def forward(self, x):
        return self.SpatialGate(self.ChannelGate(x))


class FeatureFusionBlock(nn.Module):
    """x = ResBlock(cat[x, f16]); x = ResBlock(x + CBAM(x))."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.block1 = ResBlock(cin, cout, dtype)
        self.attention = CBAM(cout, dtype=dtype)
        self.block2 = ResBlock(cout, cout, dtype)

    def forward(self, x, f16):
        x = self.block1(torch.cat([x, f16], dim=1))
        return self.block2(x + self.attention(x))


class GLUFusion(nn.Module):
    """out = layer_f(x) * sigmoid(layer_a(x)), 3x3 convs."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer_f = conv3x3(cin, cout, dtype=dtype)
        self.layer_a = conv3x3(cin, cout, dtype=dtype)

    def forward(self, x):
        return self.layer_f(x) * torch.sigmoid(self.layer_a(x))


class UpsampleBlock(nn.Module):
    """Skip-connected x2 upsampling: ResBlock(skip_conv(skip) + bilinear(up)).

    ``skip`` depends only on the encoder's skip feature (computed once per
    frame), ``merge`` on the sequential decode state.
    """

    def __init__(self, skip_c: int, up_c: int, out_c: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.skip_conv = conv3x3(skip_c, up_c, dtype=dtype)
        self.out_conv = ResBlock(up_c, out_c, dtype)

    def skip(self, skip_f):
        return self.skip_conv(skip_f)

    def merge(self, skip_x, up_f):
        # resized in its own dtype, then cast to the skip's
        up = resize_nchw(up_f, tuple(skip_x.shape[-2:]), "bilinear")
        return self.out_conv(skip_x + up.to(skip_x.dtype))

    def forward(self, skip_f, up_f):
        return self.merge(self.skip(skip_f), up_f)
