"""The PyTorch port's resize, weight bridge and conv modules against swem_tpu.

Inputs are made with numpy from a seed; weights are seeded random flax
variables carried into the port by ``swem_tpu_torch.io.jax_import``.
Everything runs on the CPU in float32.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swem_tpu.config import ModelConfig as JaxModelConfig
from swem_tpu.io.torch_import import convert_swem_state_dict
from swem_tpu.models.encoders import KeyEncoder as JaxKeyEncoder
from swem_tpu.models import swem as jswem
from swem_tpu.models.swem import SWEM as JaxSWEM
from swem_tpu.ops.resize import resize as jax_resize
from swem_tpu_torch.config import ModelConfig
from swem_tpu_torch.io.jax_import import jax_to_state_dict
from swem_tpu_torch.models import swem
from swem_tpu_torch.models.encoders import KeyEncoder
from swem_tpu_torch.models.swem import SWEM
from swem_tpu_torch.ops.resize import resize
from _torch_port_util import port_cfg, t, tiny_pair
from test_model import make_video, tiny_cfg

# Convolutions sum in another order on each side; relative to the largest
# output value, f32 conv stacks agree to ~1e-6, so 1e-5 of the output's scale
# plus rtol 1e-4 leaves room without hiding a wrong weight or layout (O(1)).
CONV_RTOL, CONV_SCALE_ATOL = 1e-4, 1e-5


def nchw_to_nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().movedim(-3, -1).numpy()


def assert_conv_close(got: np.ndarray, ref) -> None:
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=CONV_RTOL,
                               atol=CONV_SCALE_ATOL * float(np.abs(ref).max()))


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


def japply(model, variables, *args, method):
    """``model.apply`` compiled once (no EM loop runs in these modules, so
    jit changes nothing but float32 summation order)."""
    return jax.jit(lambda v, *a: model.apply(v, *a, method=method))(variables, *args)


# ---------------------------------------------------------------- resize
@pytest.mark.parametrize("method", ["nearest", "bilinear", "bicubic"])
@pytest.mark.parametrize("size", [(29, 41), (7, 5)], ids=["up", "down"])
def test_resize_matches_jax(method, size):
    x = np.random.default_rng(1).standard_normal((2, 13, 11, 3)).astype(np.float32)
    ref = np.asarray(jax_resize(jnp.asarray(x), size, method))
    got = resize(t(x), size, method).numpy()
    # nearest is a gather (exact); the interpolations sum their taps in
    # another order: float32 ulps on O(1) values
    tol = 0 if method == "nearest" else 1e-5
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def test_resize_nearest_index_map():
    idx = np.random.default_rng(2).integers(0, 3, (1, 40, 53)).astype(np.uint8)
    ref = np.asarray(jax_resize(jnp.asarray(idx[..., None]), (3, 4), "nearest"))[..., 0]
    got = resize(t(idx)[..., None], (3, 4), "nearest")[..., 0].numpy()
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------- weight bridge
def _random_tree(cfg, seed):
    """A flax variable tree of ``cfg``'s structure filled with distinct random values."""
    abstract = jax.eval_shape(JaxSWEM(cfg).init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64, cfg.max_objs + 1)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), abstract)


def test_bridge_consumes_every_leaf():
    variables = _random_tree(tiny_cfg(), 0)
    sd = jax_to_state_dict(variables)
    port = SWEM(port_cfg(tiny_cfg()), device="cpu")
    n_leaves = len(flat(variables["params"])) + len(flat(variables["batch_stats"]))
    assert len(sd) == n_leaves
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd)  # strict: nothing missing, nothing extra, shapes agree


def test_bridge_round_trip_is_exact():
    variables = _random_tree(tiny_cfg(), 1)
    port = SWEM(port_cfg(tiny_cfg()), device="cpu")
    port.load_state_dict(jax_to_state_dict(variables))
    back = convert_swem_state_dict({k: v.numpy() for k, v in port.state_dict().items()})
    for col in ("params", "batch_stats"):
        got, ref = flat(back[col]), flat(variables[col])
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=str(k))


def test_bridge_flagship_structure():
    """The flagship tree (ResNet-50 keys, ResNet-18 values) maps onto the
    port's flagship module names and shapes one to one."""
    cfg = JaxModelConfig()
    abstract = jax.eval_shape(JaxSWEM(cfg).init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64, 3)))
    sd = jax_to_state_dict(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), abstract))
    port = SWEM(ModelConfig(), device="cpu").state_dict()
    assert set(sd) == set(port)
    assert all(tuple(sd[k].shape) == tuple(port[k].shape) for k in sd)


# ------------------------------------------------------------ conv modules
def _inputs():
    frames, init_mask, _ = make_video(np.random.default_rng(3))
    return np.asarray(frames[0]), np.asarray(init_mask)


def test_key_encoder_and_projections(pair):
    model, variables, port = pair
    frame, _ = _inputs()
    ref = japply(model, variables, jnp.asarray(frame), method="encode_key")
    with torch.no_grad():
        got = port.encode_key(t(frame))
    for g, r in zip(got, ref):  # qk16, qv16, s16, s8, s4
        assert_conv_close(nchw_to_nhwc(g), r)


@pytest.mark.parametrize("split_stem", [False, True])
def test_value_encoder(pair, split_stem):
    """ValueEncoder (trunk, FeatureFusionBlock, CBAM), with and without the
    hoisted stem frame slice."""
    model, variables, port = pair
    frame, mask = _inputs()
    masks = np.random.default_rng(4).random(mask.shape).astype(np.float32)
    _, _, s16, _, _, vf = japply(model, variables, jnp.asarray(frame), method="encode_frame")
    ref = japply(model, variables, jnp.asarray(frame), jnp.asarray(masks), s16,
                 *((vf,) if split_stem else ()), method="encode_value")
    with torch.no_grad():
        got = port.encode_value(t(frame), t(masks), t(s16).movedim(-1, 1),
                                t(vf).movedim(-1, 1) if split_stem else None)
    assert_conv_close(nchw_to_nhwc(got), ref)


def test_glu_fusion(pair):
    model, variables, port = pair
    x = np.random.default_rng(5).standard_normal((2, 4, 4, 2 * 32 + 2 * 4)).astype(np.float32)
    ref = japply(model, variables, jnp.asarray(x), method=lambda m, x: m.fusion(x))
    with torch.no_grad():
        got = port.swem_core.fusion_layer(t(x).movedim(-1, 1))
    assert_conv_close(nchw_to_nhwc(got), ref)


def test_decoder(pair):
    """Decoder: compress ResBlock, both UpsampleBlocks, pred conv, final resize."""
    model, variables, port = pair
    rng = np.random.default_rng(6)
    f16 = rng.standard_normal((2, 4, 4, 32)).astype(np.float32)
    f8 = rng.standard_normal((2, 8, 8, 128)).astype(np.float32)
    f4 = rng.standard_normal((2, 16, 16, 64)).astype(np.float32)
    ref = japply(model, variables, *(jnp.asarray(a) for a in (f16, f8, f4)),
                 method=lambda m, a, b, c: m.decoder(a, b, c, (60, 70)))
    with torch.no_grad():
        got = port.decoder(*(t(a).movedim(-1, 1) for a in (f16, f8, f4)),
                           (60, 70))
    assert_conv_close(nchw_to_nhwc(got), ref)


def test_resnet50_key_trunk():
    """The ResNet-50 bottleneck trunk at 64x64."""
    frame = np.random.default_rng(7).random((1, 64, 64, 3)).astype(np.float32)
    enc = JaxKeyEncoder("resnet50")
    rng = np.random.default_rng(8)
    abstract = jax.eval_shape(enc.init, jax.random.PRNGKey(1), jnp.asarray(frame))
    # He-scaled random weights, batch norms near identity (var > 0)
    variables = {
        "params": jax.tree.map(lambda s: (rng.standard_normal(s.shape) * (
            np.sqrt(2.0 / np.prod(s.shape[:-1])) if len(s.shape) == 4 else 0.1)
            + (1.0 if len(s.shape) == 1 else 0.0)).astype(np.float32), abstract["params"]),
        "batch_stats": jax.tree.map(lambda s: rng.uniform(0.5, 1.5, s.shape).astype(np.float32),
                                    abstract["batch_stats"]),
    }
    ref = jax.jit(enc.apply)(variables, jnp.asarray(frame))
    sd = jax_to_state_dict({col: {"key_encoder": variables[col]} for col in variables})
    port = KeyEncoder("resnet50")
    port.load_state_dict({k.removeprefix("key_encoder."): v for k, v in sd.items()})
    with torch.no_grad():
        got = port(t(frame))
    for g, r in zip(got, ref):
        assert_conv_close(nchw_to_nhwc(g), r)


# ------------------------------------------------------------ mask helpers
def test_mask_helpers_match():
    """aggregate, hard_mask_from_pred and both EM-mask builders (the index
    map path must equal the one-hot path, as in the JAX package)."""
    rng = np.random.default_rng(9)
    prob = rng.random((2, 20, 18, 3)).astype(np.float32)
    np.testing.assert_allclose(swem.aggregate(t(prob)).numpy(),
                               np.asarray(jswem.aggregate(jnp.asarray(prob))),
                               rtol=1e-5, atol=1e-5)
    pred = rng.random((2, 20, 18, 4)).astype(np.float32)
    hard = swem.hard_mask_from_pred(t(pred))
    np.testing.assert_array_equal(hard.numpy(),
                                  np.asarray(jswem.hard_mask_from_pred(jnp.asarray(pred))))
    soft = rng.random((2, 24, 30, 4)).astype(np.float32)
    ref = np.asarray(jswem.prepare_em_masks(jnp.asarray(hard.numpy()), jnp.asarray(soft),
                                            (5, 7)))
    got = swem.prepare_em_masks(hard, t(soft), (5, 7))
    # bilinear taps summed in another order: float32 ulps on [0, 1] weights
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    idx = t(pred).argmax(dim=-1).to(torch.uint8)
    np.testing.assert_allclose(swem.prepare_em_masks_from_idx(idx, t(soft), (5, 7)).numpy(),
                               ref, rtol=0, atol=1e-6)
