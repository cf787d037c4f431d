"""The plain SWEM network: encoders, memory read, fusion and decoder, as
plain PyTorch functions over a ``state_dict``.

A frozen copy of what the port computes on its plain paths, written apart
from it: this file imports nothing of the port, of JAX or of the JAX
package. Weights are a dict of tensors under the port's (and the original
implementation's) ``state_dict`` keys, so one dict made by the benchmark
feeds both sides. Layouts: frames (B, H, W, 3) in [0, 1], masks
(B, H, W, N+1) with channel 0 the background, feature maps NCHW.

Every convolution and linear layer goes through an ``Ops`` object, which
holds the arithmetic: ``Ops(dt)`` computes the conv towers in the
configuration's dtype with the casts where the port puts them (bfloat16:
each layer's input, weight and bias rounded to it, batch norms folded in
float32), everything after the towers in float32;
``vosbench.reference.lowp`` has the lower-precision controls and the FLOP
counter.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from vosbench.reference import memory as mem_ops

# (block kind, blocks per stage, (f16, f8, f4) channels)
BACKBONES = {"resnet50": ("bottleneck", (3, 4, 6), (1024, 512, 256)),
             "resnet18": ("basic", (2, 2, 2), (256, 128, 64))}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Ops:
    """Convolutions and linear layers in the compute dtype ``dt``: input,
    weight and bias cast to it per call, the bias added by the product
    (as ``nn.Conv2d``/``nn.Linear`` do), float32 accumulation."""

    def __init__(self, dt=torch.float32):
        self.dt = dt

    def conv(self, x, w, b=None, stride=1, padding=0):
        dt = self.dt
        return F.conv2d(x.to(dt), w.to(dt), None if b is None else b.to(dt), stride, padding)

    def linear(self, x, w, b):
        dt = self.dt
        return F.linear(x.to(dt), w.to(dt), b.to(dt))


# ---------------------------------------------------------------- shapes
def _bn(spec, name, c):
    for k in ("weight", "bias", "running_mean", "running_var"):
        spec[f"{name}.{k}"] = (c,)


def _conv(spec, name, cout, cin, k, bias):
    spec[f"{name}.weight"] = (cout, cin, k, k)
    if bias:
        spec[f"{name}.bias"] = (cout,)


def _res_block(spec, name, cin, cout):
    _conv(spec, f"{name}.conv1", cout, cin, 3, True)
    _conv(spec, f"{name}.conv2", cout, cout, 3, True)
    if cin != cout:
        _conv(spec, f"{name}.downsample", cout, cin, 3, True)


def _stages(spec, prefix, names, backbone, bias):
    kind, layers, _ = BACKBONES[backbone]
    exp = 4 if kind == "bottleneck" else 1
    inplanes, planes = 64, 64
    for i, (stage, n) in enumerate(zip(names, layers)):
        stride = 1 if i == 0 else 2
        for b in range(n):
            p = f"{prefix}.{stage}.{b}"
            if kind == "bottleneck":
                _conv(spec, f"{p}.conv1", planes, inplanes, 1, bias)
                _bn(spec, f"{p}.bn1", planes)
                _conv(spec, f"{p}.conv2", planes, planes, 3, bias)
                _bn(spec, f"{p}.bn2", planes)
                _conv(spec, f"{p}.conv3", planes * exp, planes, 1, bias)
                _bn(spec, f"{p}.bn3", planes * exp)
            else:
                _conv(spec, f"{p}.conv1", planes, inplanes, 3, bias)
                _bn(spec, f"{p}.bn1", planes)
                _conv(spec, f"{p}.conv2", planes, planes, 3, bias)
                _bn(spec, f"{p}.bn2", planes)
            if b == 0 and (stride != 1 or inplanes != planes * exp):
                _conv(spec, f"{p}.downsample.0", planes * exp, inplanes, 1, bias)
                _bn(spec, f"{p}.downsample.1", planes * exp)
            inplanes = planes * exp
        planes *= 2


def topl_eff(cfg) -> int:
    return int(min(cfg["num_bases"], cfg["topl"]))


def param_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Every weight of the network and its shape, under the state_dict keys."""
    f16, f8, f4 = BACKBONES[cfg["backbone"]][2]
    vf16 = BACKBONES["resnet18"][2][0]
    kd, vd, md = cfg["keydim"], cfg["valdim"], cfg["mdim"]
    spec: Dict[str, Tuple[int, ...]] = {}
    _conv(spec, "key_encoder.conv1", 64, 3, 7, False)
    _bn(spec, "key_encoder.bn1", 64)
    _stages(spec, "key_encoder", ("res2", "layer2", "layer3"), cfg["backbone"], False)
    _conv(spec, "key_proj.key_proj", kd, f16, 3, True)
    _conv(spec, "key_comp", vd, f16, 3, True)
    _conv(spec, "value_encoder.conv1", 64, 4 if cfg.get("single_object") else 5, 7, True)
    _bn(spec, "value_encoder.bn1", 64)
    _stages(spec, "value_encoder", ("layer1", "layer2", "layer3"), "resnet18", True)
    _res_block(spec, "value_encoder.fuser.block1", vf16 + f16, vd)
    spec["value_encoder.fuser.attention.ChannelGate.mlp.1.weight"] = (vd // 16, vd)
    spec["value_encoder.fuser.attention.ChannelGate.mlp.1.bias"] = (vd // 16,)
    spec["value_encoder.fuser.attention.ChannelGate.mlp.3.weight"] = (vd, vd // 16)
    spec["value_encoder.fuser.attention.ChannelGate.mlp.3.bias"] = (vd,)
    _conv(spec, "value_encoder.fuser.attention.SpatialGate.spatial.conv", 1, 2, 7, True)
    _res_block(spec, "value_encoder.fuser.block2", vd, vd)
    cin = 2 * vd + 2 * topl_eff(cfg)
    _conv(spec, "swem_core.fusion_layer.layer_f", vd, cin, 3, True)
    _conv(spec, "swem_core.fusion_layer.layer_a", vd, cin, 3, True)
    _res_block(spec, "decoder.compress", vd, 512)
    _conv(spec, "decoder.up_16_8.skip_conv", 512, f8, 3, True)
    _res_block(spec, "decoder.up_16_8.out_conv", 512, md)
    _conv(spec, "decoder.up_8_4.skip_conv", md, f4, 3, True)
    _res_block(spec, "decoder.up_8_4.out_conv", md, md)
    _conv(spec, "decoder.pred", 1, md, 3, True)
    return spec


def random_weights(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded weights made on ``device`` in a few large draws: convolutions
    He-uniform (limit sqrt(6 / fan_in)), linear layers normal with std
    1 / sqrt(fan_in), biases 0, batch norms the identity (the arithmetic of
    the port's ``SWEM.init_weights``; the draws themselves differ). The
    weights named in ``cfg["init_scales"]`` are then multiplied by their
    factor."""
    spec = param_shapes(cfg)
    g = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    convs = [k for k, s in spec.items() if len(s) == 4]
    linears = [k for k, s in spec.items() if len(s) == 2]
    out = {}
    for keys, draw in ((convs, "uniform"), (linears, "normal")):
        sizes = [math.prod(spec[k]) for k in keys]
        flat = torch.empty(sum(sizes), device=device)
        if draw == "uniform":
            flat.uniform_(-1.0, 1.0, generator=g)
        else:
            flat.normal_(0.0, 1.0, generator=g)
        for k, part in zip(keys, flat.split(sizes)):
            fan_in = math.prod(spec[k][1:])
            scale = math.sqrt(6.0 / fan_in) if draw == "uniform" else 1.0 / math.sqrt(fan_in)
            out[k] = (part * scale).view(spec[k])
    for k, s in spec.items():
        if len(s) == 1:
            one = k.endswith(".running_var") or (k.endswith(".weight"))
            out[k] = (torch.ones if one else torch.zeros)(s, device=device)
    for k, factor in cfg.get("init_scales", {}).items():
        out[k] = out[k] * factor
    return {k: out[k] for k in spec}


# ---------------------------------------------------------------- layers
def normalize_image(frame, dt):
    """(..., H, W, 3) in [0, 1] -> ImageNet-normalized (..., 3, H, W) in
    ``dt``, the float32 constants rounded to it."""
    mean = torch.tensor(IMAGENET_MEAN, device=frame.device).to(dt)
    std = torch.tensor(IMAGENET_STD, device=frame.device).to(dt)
    return ((frame.to(dt) - mean) / std).movedim(-1, -3)


def bn(w, name, x):
    """A frozen batch norm, folded in float32, applied in x's dtype."""
    scale = w[f"{name}.weight"] * torch.rsqrt(w[f"{name}.running_var"] + 1e-5)
    shift = w[f"{name}.bias"] - w[f"{name}.running_mean"] * scale
    return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def conv(ops, w, name, x, stride=1, padding=0):
    return ops.conv(x, w[f"{name}.weight"], w.get(f"{name}.bias"), stride, padding)


def stem_conv(ops, w, name, x, channels=slice(None), bias=True):
    """The 7x7/2 stem on input channels ``channels``, its bias added after
    the product in the compute dtype (the stem's frame and mask channels
    can then run apart)."""
    y = ops.conv(x, w[f"{name}.weight"][:, channels], None, 2, 3)
    b = w.get(f"{name}.bias")
    return y + b.to(y.dtype)[:, None, None] if bias and b is not None else y


def resize_bilinear(x, size):
    """(..., H, W) -> (..., h, w), half-pixel centres. float32 through
    ``F.interpolate``; a lower dtype one axis at a time with the weights
    rounded to it."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    if x.dtype == torch.float32:
        lead = x.shape[:-2]
        y = F.interpolate(x.reshape((-1, 1) + tuple(x.shape[-2:])), size=tuple(size),
                          mode="bilinear", align_corners=False)
        return y.reshape(lead + tuple(size))
    for axis, out in ((x.ndim - 2, size[0]), (x.ndim - 1, size[1])):
        n = x.shape[axis]
        if n == out:
            continue
        scale = torch.tensor(n, dtype=torch.float32) / torch.tensor(out, dtype=torch.float32)
        src = ((torch.arange(out, dtype=torch.float32) + 0.5) * scale - 0.5).clamp_min(0.0)
        i0 = src.floor().long().clamp_max(n - 1)
        i1 = (i0 + 1).clamp_max(n - 1)
        shape = [1] * x.ndim
        shape[axis] = out
        wt = (src - i0.float()).to(x.device, x.dtype).reshape(shape)
        x = (x.index_select(axis, i0.to(x.device)) * (1.0 - wt)
             + x.index_select(axis, i1.to(x.device)) * wt)
    return x


def res_block(ops, w, name, x):
    r = conv(ops, w, f"{name}.conv2", F.relu(conv(ops, w, f"{name}.conv1", F.relu(x), padding=1)),
             padding=1)
    if f"{name}.downsample.weight" in w:
        x = conv(ops, w, f"{name}.downsample", x, padding=1)
    return x + r


def _block(ops, w, p, x, stride, bottleneck):
    if bottleneck:
        out = F.relu(bn(w, f"{p}.bn1", conv(ops, w, f"{p}.conv1", x)))
        out = F.relu(bn(w, f"{p}.bn2", conv(ops, w, f"{p}.conv2", out, stride, 1)))
        out = bn(w, f"{p}.bn3", conv(ops, w, f"{p}.conv3", out))
    else:
        out = F.relu(bn(w, f"{p}.bn1", conv(ops, w, f"{p}.conv1", x, stride, 1)))
        out = bn(w, f"{p}.bn2", conv(ops, w, f"{p}.conv2", out, 1, 1))
    if f"{p}.downsample.0.weight" in w:
        x = bn(w, f"{p}.downsample.1", conv(ops, w, f"{p}.downsample.0", x, stride))
    return F.relu(out + x)


def trunk(ops, w, prefix, names, backbone, x):
    """Stem output -> (f16, f8, f4)."""
    kind, layers, _ = BACKBONES[backbone]
    feats = []
    for i, (stage, n) in enumerate(zip(names, layers)):
        for b in range(n):
            x = _block(ops, w, f"{prefix}.{stage}.{b}", x, 2 if (b == 0 and i > 0) else 1,
                       kind == "bottleneck")
        feats.append(x)
    return feats[2], feats[1], feats[0]


def stem_rest(w, prefix, x):
    """bn -> relu -> 3x3/2 max pool on a stem conv's output."""
    return F.max_pool2d(F.relu(bn(w, f"{prefix}.bn1", x)), 3, stride=2, padding=1)


def cbam(ops, w, name, x):
    def mlp(v):
        h = F.relu(ops.linear(v, w[f"{name}.ChannelGate.mlp.1.weight"],
                              w[f"{name}.ChannelGate.mlp.1.bias"]))
        return ops.linear(h, w[f"{name}.ChannelGate.mlp.3.weight"],
                          w[f"{name}.ChannelGate.mlp.3.bias"])

    x = x * torch.sigmoid(mlp(x.mean(dim=(-2, -1))) + mlp(x.amax(dim=(-2, -1))))[:, :, None, None]
    pooled = torch.cat([x.amax(dim=1, keepdim=True), x.mean(dim=1, keepdim=True)], dim=1)
    return x * torch.sigmoid(conv(ops, w, f"{name}.SpatialGate.spatial.conv", pooled, padding=3))


# ---------------------------------------------------------------- network
class Network:
    """The network's stages over weights ``w``. ``ops`` holds the arithmetic
    of the convolutions and linear layers (default: the configuration's
    compute dtype, ``cfg["dtype"]``); the memory, the read, the EM loop
    and the decode from the last resize on are float32 at every dtype."""

    def __init__(self, cfg, w, ops=None):
        self.cfg, self.w = cfg, w
        self.ops = ops or Ops(DTYPES[cfg["dtype"]])
        self.dt = self.ops.dt

    def encode_key(self, frame):
        """frame (B,H,W,3) -> (qk16, qv16, s16, s8, s4), in the compute dtype."""
        ops, w, cfg = self.ops, self.w, self.cfg
        x = stem_rest(w, "key_encoder", stem_conv(ops, w, "key_encoder.conv1",
                                                  normalize_image(frame, self.dt)))
        s16, s8, s4 = trunk(ops, w, "key_encoder", ("res2", "layer2", "layer3"),
                            cfg["backbone"], x)
        return (conv(ops, w, "key_proj.key_proj", s16, padding=1),
                conv(ops, w, "key_comp", s16, padding=1), s16, s8, s4)

    def frame_stem(self, frame):
        """The value stem's frame channels (with its bias), once per frame."""
        return stem_conv(self.ops, self.w, "value_encoder.conv1",
                         normalize_image(frame, self.dt), slice(0, 3))

    def encode_value(self, frame, masks, s16, vf=None):
        """frame (B,H,W,3); masks (B,H,W,N+1) soft; s16; ``vf`` the frame's
        ``frame_stem`` (the stem then adds the mask channels' product to
        it), else one product over all channels -> mv16 (B,N,Cv,h,w)."""
        ops, w, dt = self.ops, self.w, self.dt
        B, N = frame.shape[0], masks.shape[-1] - 1
        fg = masks[..., 1:].movedim(-1, 1)  # (B,N,H,W)
        others = 1.0 - fg - masks[..., 0][:, None]
        m = torch.stack([fg, others], dim=2).reshape((B * N, 2) + fg.shape[2:]).to(dt)
        if vf is None:
            img = normalize_image(frame, dt).repeat_interleave(N, 0)
            x = stem_conv(ops, w, "value_encoder.conv1", torch.cat([img, m], dim=1))
        else:
            x = vf.repeat_interleave(N, 0) + stem_conv(ops, w, "value_encoder.conv1", m,
                                                       slice(3, None), bias=False)
        f16, _, _ = trunk(ops, w, "value_encoder", ("layer1", "layer2", "layer3"), "resnet18",
                          stem_rest(w, "value_encoder", x))
        x = res_block(ops, w, "value_encoder.fuser.block1",
                      torch.cat([f16, s16.to(dt).repeat_interleave(N, 0)], dim=1))
        x = res_block(ops, w, "value_encoder.fuser.block2",
                      x + cbam(ops, w, "value_encoder.fuser.attention", x))
        return x.reshape((B, N) + x.shape[1:])

    def match(self, qk16, qv16, memory, read=mem_ops.read):
        """Memory read (float32) + GLU fusion -> context (B,N,Cv,h,w)."""
        ops, w, cfg = self.ops, self.w, self.cfg
        B, _, h, wd = qk16.shape
        mk, mv, valid = mem_ops.gather(memory)
        qk = qk16.flatten(2).transpose(1, 2).float()
        mem_out, exp_aff = read(qk, mk, mv, valid, tau=cfg["em_tau"])
        S = mem_ops.topl_feature(exp_aff, topl_eff(cfg))
        qv = qv16.flatten(2).transpose(1, 2).float()[:, None].expand_as(mem_out)
        feats = torch.cat([mem_out, qv, S], dim=-1)
        N = feats.shape[1]
        feats = feats.reshape(B * N, h, wd, feats.shape[-1]).permute(0, 3, 1, 2).to(self.dt)
        ctx = (conv(ops, w, "swem_core.fusion_layer.layer_f", feats, padding=1)
               * torch.sigmoid(conv(ops, w, "swem_core.fusion_layer.layer_a", feats, padding=1)))
        return ctx.reshape((B, N) + ctx.shape[1:])

    def skips(self, s8, s4):
        ops, w = self.ops, self.w
        return (conv(ops, w, "decoder.up_16_8.skip_conv", s8, padding=1),
                conv(ops, w, "decoder.up_8_4.skip_conv", s4, padding=1))

    def decode_objects(self, context, skip8, skip4, valid, out_size):
        """context (B,N,Cv,h,w) -> each object's probability (B,Ho,Wo,N) x
        valid, float32 from the last resize on."""
        ops, w = self.ops, self.w
        B, N = context.shape[:2]
        x = res_block(ops, w, "decoder.compress", context.flatten(0, 1))
        for name, skip in (("up_16_8", skip8), ("up_8_4", skip4)):
            skip = skip.repeat_interleave(N, 0)
            up = resize_bilinear(x, skip.shape[-2:]).to(skip.dtype)
            x = res_block(ops, w, f"decoder.{name}.out_conv", skip + up)
        x = conv(ops, w, "decoder.pred", F.relu(x), padding=1)
        x = resize_bilinear(x.float(), tuple(out_size))
        probs = torch.sigmoid(x[:, 0]).reshape((B, N) + tuple(out_size)).movedim(1, -1)
        return probs * valid[:, None, None, :].to(probs.dtype)


def aggregate(prob):
    """prob (B,H,W,N) -> logits (B,H,W,N+1), background first."""
    bg = torch.prod(1.0 - prob, dim=-1, keepdim=True)
    p = torch.cat([bg, prob], dim=-1).clamp(1e-7, 1.0 - 1e-7)
    return torch.log(p / (1.0 - p))
