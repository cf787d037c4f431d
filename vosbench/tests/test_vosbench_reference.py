"""The plain reference against the port at a tiny width on the CPU, and a
whole run of each driver there."""

import pytest
import torch

from swem_tpu_torch.config import ModelConfig
from swem_tpu_torch.models.swem import SWEM
from vosbench.reference import memory as M
from vosbench.reference.engine import Replay, one_hot
from vosbench.reference.model import Network, param_shapes, random_weights
from vosbench.tests import _tiny

FLAGSHIP = dict(backbone="resnet50", keydim=128, valdim=512, num_bases=128, num_em_iters=4,
                em_tau=0.05, topl=64, max_objs=2, mdim=256, dtype="float32")


@pytest.mark.parametrize("cfg", [_tiny.TINY, FLAGSHIP], ids=["tiny", "flagship"])
def test_weights_match_the_ports_state_dict(cfg):
    model = SWEM(ModelConfig(**cfg), device="cpu")
    ours = param_shapes(cfg)
    theirs = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert ours == theirs


def test_reference_step_matches_the_ports():
    from swem_tpu_torch import engine
    from swem_tpu_torch.models import em

    torch.manual_seed(0)
    cfg = _tiny.TINY
    w = random_weights(cfg, 3, "cpu")
    model = SWEM(ModelConfig(**cfg), device="cpu")
    model.load_state_dict(w)
    frames = torch.rand(4, 1, 64, 64, 3)
    labels = torch.zeros(1, 64, 72, dtype=torch.long)
    labels[:, 10:30, 10:40] = 1
    labels[:, 35:60, 30:70] = 2
    mask = one_hot(labels, 3)
    active = torch.ones(1, 2, dtype=torch.bool)
    g = torch.Generator().manual_seed(5)
    b = M.draw_bases(g, 1, 2, cfg["keydim"], cfg["valdim"], cfg["num_bases"], "cpu")
    rep = Replay(Network(cfg, w), (64, 72))
    mem_r = rep.init(frames[0], mask, active, b)
    mem_p = engine.init_memory(model, None, frames[0], mask, active,
                               bases=em.Bases(b.kappa, b.nu, b.zita))
    for t in range(1, 4):
        mem_r, pred_r = rep.step(mem_r, frames[t], active)
        mem_p, idx_p, pred_p = engine.step(model, mem_p, frames[t], active, (64, 72))
        # the memories agree to the bit; the decode's float32 sums run in
        # another order (about 2e-5 on these probabilities)
        assert torch.equal(mem_r.update.kappa, mem_p.update.kappa)
        assert torch.allclose(pred_r, pred_p, atol=1e-4, rtol=0)
        assert torch.equal(pred_r.argmax(-1).to(torch.uint8), idx_p)


@pytest.mark.parametrize("kind", ["video", "stream"])
def test_a_whole_run_on_the_cpu_is_correct(kind):
    res = _tiny.run(kind)
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "compared"
    assert "setup_s" in res["metrics"]


def test_a_traced_run_reports_per_layer_metrics_only():
    res = _tiny.run("video", trace=True)
    assert "setup_s" not in res["metrics"]
    assert set(res["metrics"]) <= {m["name"] for m in _tiny.cell("video").per_layer}
    assert "busy_s" in res["device"] and "breakdown" in res
