"""Shared helpers of the ``test_torch_*`` files: one tiny model in both packages.

The port draws seeded random weights; the JAX package's own converter
(``convert_swem_state_dict``) turns them into flax variables, and the port's
``jax_to_state_dict`` carries those back into the port model under test.
"""

import numpy as np
import torch

from swem_tpu.io.torch_import import convert_swem_state_dict
from swem_tpu.models import em as jem
from swem_tpu.models.swem import SWEM as JaxSWEM
from swem_tpu_torch.config import ModelConfig
from swem_tpu_torch.io.jax_import import jax_to_state_dict
from swem_tpu_torch.models.em import Bases
from swem_tpu_torch.models.swem import SWEM
from test_model import tiny_cfg

TINY_FIELDS = ("backbone", "keydim", "valdim", "num_bases", "num_em_iters", "topl",
               "max_objs", "mdim", "dtype")


def port_cfg(jax_cfg) -> ModelConfig:
    return ModelConfig(**{k: getattr(jax_cfg, k) for k in TINY_FIELDS})


def t(a) -> torch.Tensor:
    """numpy / jax array -> a CPU tensor that owns its data."""
    return torch.tensor(np.asarray(a))


def jax_bases(cfg, key, n_objs=None) -> Bases:
    """The JAX package's draw of initial bases from ``key`` (``n_objs`` slots,
    default ``cfg.max_objs``), as the port's ``Bases``: the two frameworks
    draw different random numbers, so parity tests hand this draw to both."""
    mem = jem.fresh_memory(key, 1, n_objs or cfg.max_objs, cfg.keydim, cfg.valdim,
                           cfg.num_bases)
    return Bases(t(mem.first.kappa), t(mem.first.nu), t(mem.first.zita))


def tiny_pair(seed: int = 0, **cfg_kw):
    """(jax model, flax variables as numpy, port model with the same weights).

    Two layers are scaled down from the random init so that the comparison
    measures the code and not chaos: keys of norm ~3 instead of ~90 (at
    tau = 0.05 the EM softmax over ~90-norm keys is a hard assignment that
    float32 ulps flip) and decoder logits of O(1) instead of O(100).
    """
    jcfg = tiny_cfg(**cfg_kw)
    donor = SWEM(port_cfg(jcfg), device="cpu").init_weights(seed)
    with torch.no_grad():
        donor.key_proj.key_proj.weight.mul_(0.03)
        donor.decoder.pred.weight.mul_(0.01)
    variables = convert_swem_state_dict({k: v.numpy() for k, v in donor.state_dict().items()})
    port = SWEM(port_cfg(jcfg), device="cpu")
    port.load_state_dict(jax_to_state_dict(variables))
    return JaxSWEM(jcfg), variables, port
