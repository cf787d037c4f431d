"""The port's host-side evaluation modules against swem_tpu's, on the CPU:
dataset readers, palette PNGs, J&F metrics, the reports, reference ``.pth``
loading and the single-object widening, and the decode/write overlap.

Every case feeds both packages the same files or numpy arrays and asks for
equal results: these modules are host-side numpy, so equal means bit-equal.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from swem_tpu.data import davis_test as jdavis
from swem_tpu.data import palette as jpalette
from swem_tpu.data import ytvos_test as jytvos
from swem_tpu.eval import benchmark as jbench
from swem_tpu.eval import metrics as jmetrics
from swem_tpu.io.checkpoint import widen_value_encoder as jax_widen
from swem_tpu.io.torch_import import import_swem_checkpoint
from swem_tpu_torch import registry
from swem_tpu_torch.config import ModelConfig, SWEMConfig
from swem_tpu_torch.data import davis_test, palette, ytvos_test
from swem_tpu_torch.eval import benchmark, metrics
from swem_tpu_torch.io.checkpoint import read_pth, widen_value_encoder
from swem_tpu_torch.io.jax_import import jax_to_state_dict
from swem_tpu_torch.models.swem import SWEM
from swem_tpu_torch.utils.host_io import AsyncWriter, prefetch
import test_eval_e2e
from test_eval_e2e import build_fake_davis, make_label


@pytest.fixture(scope="module")
def fake_davis(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("davis"))
    build_fake_davis(root)
    os.makedirs(os.path.join(root, "ImageSets", "2016"))  # DAVIS-2016: the same videos
    shutil.copy(os.path.join(root, "ImageSets", "2017", "val.txt"),
                os.path.join(root, "ImageSets", "2016", "val.txt"))
    return root


@pytest.fixture(scope="module")
def fake_ytvos(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ytvos"))
    test_eval_e2e.TestEvaluatorE2E._build_fake_ytvos(root)
    return root


def assert_same_video(got, ref):
    """Two dataclass videos with equal fields (arrays bit-equal)."""
    assert type(got).__name__ == type(ref).__name__
    for f, v in vars(ref).items():
        g = getattr(got, f)
        if isinstance(v, np.ndarray):
            assert g.dtype == v.dtype and np.array_equal(g, v), f
        elif f == "injections":
            assert g.keys() == v.keys()
            for t in v:
                assert g[t]["new_slots"] == v[t]["new_slots"]
                assert np.array_equal(g[t]["mask"], v[t]["mask"])
        else:
            assert tuple(g) == tuple(v) if isinstance(v, (list, tuple)) else g == v, f


@pytest.mark.parametrize("single_obj", [False, True])
def test_davis_test_set_matches(fake_davis, single_obj):
    got = davis_test.DavisTestSet(fake_davis, single_obj=single_obj, n_slots=4)
    ref = jdavis.DavisTestSet(fake_davis, single_obj=single_obj, n_slots=4)
    assert len(got) == len(ref) == 2
    for idx in range(len(ref)):
        assert_same_video(got[idx], ref[idx])
        assert got.peek(idx) == ref.peek(idx)


def test_ytvos_test_set_matches(fake_ytvos):
    """All four fake videos: a late object, a shorter video and another size."""
    got = ytvos_test.YTVOSTestSet(fake_ytvos, short_size=64, n_slots=4)
    ref = jytvos.YTVOSTestSet(fake_ytvos, short_size=64, n_slots=4)
    assert len(got) == len(ref) == 4
    for idx in range(len(ref)):
        assert_same_video(got[idx], ref[idx])
        assert got.peek(idx) == ref.peek(idx)
    assert any(v.injections for v in (got[i] for i in range(len(got))))
    for size in range(1, 1300):
        assert ytvos_test.suit_size(size) == jytvos.suit_size(size)


def test_load_image_and_label_match(fake_davis):
    jpg = os.path.join(fake_davis, "JPEGImages", "480p", "vid0", "00001.jpg")
    png = os.path.join(fake_davis, "Annotations", "480p", "vid0", "00001.png")
    assert np.array_equal(davis_test.load_image(jpg), jdavis.load_image(jpg, as_uint8=True))
    assert np.array_equal(palette.load_label_mask(png), jdavis.load_label(png))
    with pytest.raises(FileNotFoundError):
        davis_test.load_image(jpg + ".missing")


@pytest.mark.parametrize("which", ["davis", "ytvos"])
def test_palette_png_round_trips(tmp_path, which):
    """Both palettes equal; a PNG written by either package reads back the
    same label map in both, and the two files are byte-equal."""
    pal = getattr(palette, f"{which}_palette")()
    assert pal == getattr(jpalette, f"{which}_palette")()
    label = np.random.default_rng(0).integers(0, 13, (37, 53)).astype(np.uint8)
    palette.save_seg_mask(label, str(tmp_path / "port.png"), pal)
    jpalette.save_seg_mask(label, str(tmp_path / "jax.png"), pal)
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
    for name in ("port.png", "jax.png"):
        assert np.array_equal(palette.load_label_mask(str(tmp_path / name)), label)
        assert np.array_equal(jpalette.load_label_mask(str(tmp_path / name)), label)


def test_metrics_match_on_random_masks():
    """J, F (with and without void pixels) and statistics equal bit for bit."""
    rng = np.random.default_rng(1)
    for _ in range(4):
        gt = rng.random((5, 41, 67)) > 0.6
        pred = gt ^ (rng.random(gt.shape) > 0.9)
        void = rng.random(gt.shape) > 0.95
        for v in (None, void):
            assert np.array_equal(metrics.jaccard(gt, pred, v), jmetrics.jaccard(gt, pred, v))
            assert np.array_equal(metrics.boundary_f_frames(gt, pred, v),
                                  jmetrics.boundary_f_frames(gt, pred, v))
        series = metrics.jaccard(gt, pred)
        assert metrics.statistics(series) == jmetrics.statistics(series)
    empty = np.zeros((9, 9), bool)
    assert metrics.boundary_f(empty, empty) == jmetrics.boundary_f(empty, empty) == 1.0
    assert np.array_equal(metrics.disk(5), jmetrics.disk(5))


def write_predictions(root, names, n_frames=5, seed=2):
    """Noisy copies of the fake ground truth as palette PNGs (frame 3 of the
    first video missing, which the reader treats as background)."""
    rng = np.random.default_rng(seed)
    pal = palette.davis_palette()
    for name in names:
        os.makedirs(os.path.join(root, name), exist_ok=True)
        for t in range(n_frames):
            if name == names[0] and t == 3:
                continue
            lab = make_label(t)
            lab = np.where(rng.random(lab.shape) > 0.97, rng.integers(0, 3, lab.shape), lab)
            palette.save_seg_mask(lab.astype(np.uint8), os.path.join(root, name, f"{t:05d}.png"),
                                  pal)


@pytest.mark.parametrize("year", ["2017", "2016"])
def test_evaluation_and_reports_match(fake_davis, tmp_path, year):
    """``DavisEvaluation`` on the same PNGs gives the same series (DAVIS-2016
    merges the objects into one), and ``write_reports``' three CSVs are
    byte-equal."""
    res = str(tmp_path / "res")
    write_predictions(res, ["vid0", "vid1"])
    got = benchmark.DavisEvaluation(fake_davis, year=year).evaluate(res)
    ref = jbench.DavisEvaluation(fake_davis, year=year).evaluate(res)
    for m in ("J", "F"):
        for k in ("M", "R", "D"):
            assert got[m][k] == ref[m][k]
        assert got[m]["M_per_object"] == ref[m]["M_per_object"]
        for name, series in ref[m]["per_obj_frame"].items():
            assert np.array_equal(got[m]["per_obj_frame"][name], series)
    g = benchmark.write_reports(got, str(tmp_path / "port"), "DAVIS17", per_object_csv=True)
    r = jbench.write_reports(ref, str(tmp_path / "jax"), "DAVIS17", per_object_csv=True)
    assert g == r
    for csv in ("global_results", "per-sequence_results", "per-object_results"):
        name = f"{csv}-DAVIS17.csv"
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    gt, void, ids = benchmark.DavisGT(fake_davis).get_all_masks("vid0")
    rgt, rvoid, rids = jbench.DavisGT(fake_davis).get_all_masks("vid0")
    assert np.array_equal(gt, rgt) and np.array_equal(void, rvoid) and ids == rids


def reference_pth(tmp_path, single_object: bool, wrap: bool):
    """A reference-style checkpoint of random weights: the model's keys plus
    the ImageNet mean/std buffers and BatchNorm counters the reference saves,
    optionally inside {"state_dict": ...}."""
    cfg = ModelConfig(backbone="resnet18", keydim=8, valdim=16, num_bases=4, topl=2, mdim=16,
                      single_object=single_object)
    sd = SWEM(cfg, device="cpu").init_weights(3).state_dict()
    g = torch.Generator().manual_seed(4)
    sd = {k: v + 0.1 * torch.randn(v.shape, generator=g) for k, v in sd.items()}
    extra = {"key_encoder.mean": torch.zeros(1, 3, 1, 1), "key_encoder.std": torch.ones(1, 3, 1, 1),
             "value_encoder.mean": torch.zeros(1, 3, 1, 1),
             "key_encoder.bn1.num_batches_tracked": torch.tensor(7)}
    path = str(tmp_path / f"swem_{single_object}_{wrap}.pth")
    full = {**sd, **extra}
    torch.save({"state_dict": full} if wrap else full, path)
    return cfg, sd, path


@pytest.mark.parametrize("wrap", [True, False], ids=["wrapped", "bare"])
def test_pth_loads_to_the_bridged_weights(tmp_path, wrap):
    """A reference .pth read by the port equals the JAX package's import
    carried over by the weight bridge, bit for bit, and loads strictly."""
    cfg, sd, path = reference_pth(tmp_path, single_object=False, wrap=wrap)
    got = registry.load_state_dict(SWEMConfig(model=cfg), path)
    ref = jax_to_state_dict(import_swem_checkpoint(path))
    assert got.keys() == ref.keys() == sd.keys()
    for k in ref:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], ref[k]), k
    SWEM(cfg, device="cpu").load_state_dict(got, strict=True)


def test_single_object_pth_is_widened(tmp_path):
    """A 4-channel value-encoder conv1 gets the JAX package's orthogonal
    fifth channel, bit for bit; a single-object model keeps 4 channels."""
    cfg, _, path = reference_pth(tmp_path, single_object=True, wrap=True)
    got = registry.load_state_dict(SWEMConfig(model=ModelConfig(**{
        **vars(cfg), "single_object": False})), path)
    variables = import_swem_checkpoint(path)
    ref = jax_to_state_dict({"params": jax_widen(variables["params"]),
                             "batch_stats": variables["batch_stats"]})
    assert got["value_encoder.conv1.weight"].shape[1] == 5
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    single = registry.load_state_dict(SWEMConfig(model=cfg), path)
    assert single["value_encoder.conv1.weight"].shape[1] == 4
    assert widen_value_encoder(got) is got  # already 5 channels: unchanged


def test_pth_with_a_foreign_key_or_an_orbax_dir_raises(tmp_path):
    cfg, sd, _ = reference_pth(tmp_path, single_object=False, wrap=False)
    path = str(tmp_path / "foreign.pth")
    torch.save({**sd, "decoder.extra.weight": torch.zeros(3)}, path)
    with pytest.raises(KeyError, match="decoder.extra.weight"):
        read_pth(path, sd.keys())
    with pytest.raises(ValueError, match="JAX package"):
        registry.load_state_dict(SWEMConfig(model=cfg), str(tmp_path))


def test_prefetch_and_async_writer(tmp_path):
    """Order kept, failures raised where the item or the flush is read."""
    assert list(prefetch(lambda i: i * i, range(7), depth=3)) == [i * i for i in range(7)]
    assert list(prefetch(lambda i: i, [])) == []

    def fetch(i):
        if i == 2:
            raise OSError("decode failed")
        return i

    gen = prefetch(fetch, range(5))
    assert [next(gen), next(gen)] == [0, 1]
    with pytest.raises(OSError, match="decode failed"):
        next(gen)
    with AsyncWriter(workers=2, max_pending=2) as w:
        for i in range(6):
            w.submit((tmp_path / f"{i}.txt").write_text, str(i))
    assert sorted(p.name for p in tmp_path.glob("*.txt")) == [f"{i}.txt" for i in range(6)]
    w = AsyncWriter()
    w.submit(json.loads, "{")
    with pytest.raises(json.JSONDecodeError):
        w.close()
