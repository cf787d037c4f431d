"""The work counts against the numbers ``chip_smoke.py`` prints at the
flagship shapes, counted once."""

import pytest

from vosbench import flops

FLAGSHIP = dict(backbone="resnet50", keydim=128, valdim=512, num_bases=128, num_em_iters=4,
                em_tau=0.05, topl=64, max_objs=2, mdim=256, dtype="bfloat16")


def test_em_loop_work_at_the_flagship():
    f, b = flops.em_loop_work(1, 2, 1620, 128, 128, 4)
    assert f == pytest.approx(1.70e9, rel=1e-3)
    assert b == pytest.approx(4.70e6, rel=1e-3)


def test_read_work_at_the_flagship():
    f, b = flops.read_work(1, 2, 1620, 128, 256, 512)
    assert f == pytest.approx(2.12e9, rel=2e-3)
    assert b == pytest.approx(16.72e6, rel=1e-3)


def test_roofline_takes_the_larger_bound():
    f, b = flops.read_work(1, 2, 1620, 128, 256, 512)
    assert flops.roofline_s(f, b) == pytest.approx(b / 3.35e12)
    f, b = flops.em_loop_work(1, 2, 1620, 128, 128, 4)
    assert flops.roofline_s(f, b) == pytest.approx(f / 495e12)


def test_model_work_per_frame_counts_each_part():
    parts = flops.step_flops(FLAGSHIP, 1, 2, (480, 864), (480, 854))
    # the key trunk to layer3 plus projections and skips; two objects' value
    # encodes, fusions and decodes
    assert 1.2e11 < parts["key"] < 1.5e11
    assert parts["em_loop"] == pytest.approx(1.70e9, rel=1e-3)
    assert flops.video_flops(parts, 2) == pytest.approx(
        2 * parts["key"] + parts["value"] + parts["em"] + parts["read"])
