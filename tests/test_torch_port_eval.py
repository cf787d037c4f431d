"""The port's evaluator, its locality read and its CLI against swem_tpu's, on the CPU.

Both packages evaluate the same fake DAVIS and YouTube-VOS trees with the
same tiny model (seeded weights carried across by the weight bridge, two
layers scaled down as in ``_torch_port_util.tiny_pair``), the port taking
the JAX package's initial EM bases through ``Evaluator.initial_bases``.
The JAX evaluator runs op by op (``jax.disable_jit``): at tau = 0.05 its
jitted programs disagree with its own eager ones on many pixels at test
widths. Frame sizes are chosen so that both bicubic resizes agree to the
bit: the identity (DAVIS in-size = frame size, YouTube-VOS ``ssize`` = the
short side) or an exact 2x upsample (the second multi-scale scale).

Palette maps are held at >= 99.9% of pixels per video (a pixel may flip at
an argmax near-tie), injected ground truth exactly, and the global CSVs
equal where every map is equal, else within 0.01 of J&F.
"""

import csv
import dataclasses
import json
import os

import numpy as np
import jax
import pytest
import torch
from PIL import Image

from swem_tpu import engine as jeng
from swem_tpu.config import EvalConfig as JaxEvalConfig
from swem_tpu.config import SWEMConfig as JaxSWEMConfig
from swem_tpu.data.palette import davis_palette, save_seg_mask
from swem_tpu.eval.evaluator import Evaluator as JaxEvaluator
from swem_tpu.models import em as jem
from swem_tpu.models.swem import SWEM as JaxSWEM
from swem_tpu_torch.config import EvalConfig, SWEMConfig
from swem_tpu_torch.eval import __main__ as cli
from swem_tpu_torch.eval.evaluator import Evaluator
from swem_tpu_torch.models import em
from swem_tpu_torch.models.swem import SWEM
from swem_tpu_torch.ops import em_kernel, read_kernel
from _torch_port_util import jax_bases, t, tiny_pair
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse fixture)
from test_eval_e2e import build_fake_davis

SEED = 123  # DataConfig.seed of both packages


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=1, max_objs=4)


@pytest.fixture(autouse=True)
def no_jax_warmup(monkeypatch):
    """The JAX runners' warm-up only moves compilation out of the timed span;
    run op by op it would only cost the test time."""
    monkeypatch.setattr(jeng.ChunkedVideoRunner, "warmup", lambda self, *a, **kw: None)


@pytest.fixture(scope="module")
def fake_davis(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("davis"))
    build_fake_davis(root)  # 2 videos of 5 frames at 64x96, 2 objects each
    return root


def build_fake_ytvos(root):
    """One 64x96 video of 5 frames (the DAVIS tree's size, so that the JAX
    package's eager op cache serves both): object 1 from frame 0, object 3
    from frame 2."""
    rng = np.random.default_rng(1)
    name, pal = "video0", davis_palette()
    jdir, adir = (os.path.join(root, d, name) for d in ("JPEGImages", "Annotations"))
    os.makedirs(jdir)
    os.makedirs(adir)
    for i in range(5):
        Image.fromarray((rng.random((64, 96, 3)) * 255).astype(np.uint8)).save(
            os.path.join(jdir, f"{i:05d}.jpg"))
    lab0 = np.zeros((64, 96), np.uint8)
    lab0[8:24, 8:24] = 1
    lab2 = np.zeros((64, 96), np.uint8)
    lab2[40:60, 50:80] = 3
    save_seg_mask(lab0, os.path.join(adir, "00000.png"), pal)
    save_seg_mask(lab2, os.path.join(adir, "00002.png"), pal)
    meta = {"videos": {name: {"objects": {"1": {"frames": ["00000", "00002", "00004"]},
                                          "3": {"frames": ["00002", "00004"]}}}}}
    with open(os.path.join(root, "meta.json"), "w") as f:
        json.dump(meta, f)
    return lab2 > 0


def port_evaluator(port, log_dir, **eval_kw):
    """The port's evaluator on ``port``'s weights with the JAX draw of bases."""
    cfg = SWEMConfig(model=port.cfg, eval=EvalConfig(**eval_kw), log_dir=str(log_dir))
    ev = Evaluator(cfg, port.state_dict(), device="cpu")
    ev.initial_bases = lambda n: jax_bases(ev.model.cfg, jax.random.PRNGKey(SEED), n)
    return ev


def jax_evaluator(model, variables, log_dir, **eval_kw):
    cfg = JaxSWEMConfig(model=model.cfg, eval=JaxEvalConfig(**eval_kw), log_dir=str(log_dir))
    return JaxEvaluator(cfg, variables)


def read_maps(out_root):
    """{video: (T, H, W) uint8} of every PNG under an evaluator's output."""
    return {v: np.stack([np.array(Image.open(os.path.join(out_root, v, f)))
                         for f in sorted(os.listdir(os.path.join(out_root, v)))])
            for v in sorted(os.listdir(out_root))}


def assert_maps_agree(got, ref, share=0.999):
    assert got.keys() == ref.keys() and got
    for v in ref:
        assert got[v].shape == ref[v].shape, v
        same = float((got[v] == ref[v]).mean())
        assert same >= share, f"{v}: {same:.6f} of pixels agree"
    return all(np.array_equal(got[v], ref[v]) for v in ref)


def read_global_csv(save_dir, eval_set="DAVIS17"):
    with open(os.path.join(save_dir, f"global_results-{eval_set}.csv")) as f:
        names, values = list(csv.reader(f))
    return dict(zip(names, map(float, values)))


# ---------------------------------------------------------------------- #
# the evaluator against the JAX evaluator

def test_davis_sequential_matches(pair, fake_davis, tmp_path):
    """DAVIS17 sequential (chunk 2: full chunks), frames at their own size
    (the identity resize), through ``val``: PNGs and CSVs."""
    model, variables, port = pair
    kw = dict(eval_set="DAVIS17", data_root=fake_davis, max_objs=4, davis_in_size=(64, 96),
              chunk=2)
    with jax.disable_jit():
        jev = jax_evaluator(model, variables, tmp_path / "jax", **kw)
        ref = jev.val()
    pev = port_evaluator(port, tmp_path / "port", **kw)
    got = pev.val()
    maps = read_maps(pev.out_root)
    assert [len(m) for m in maps.values()] == [5, 5]  # every frame has a PNG
    assert len(np.unique(maps["vid0"])) > 2  # the comparison has content
    if assert_maps_agree(maps, read_maps(jev.out_root)):
        assert read_global_csv(pev.save_dir) == read_global_csv(jev.save_dir)
        assert got == pytest.approx(ref, abs=1e-12)
    else:
        assert abs(got["J&F-Mean"] - ref["J&F-Mean"]) <= 0.01


def test_multi_scale_flip_matches(pair, tmp_path):
    """Scales 64 (the identity) and 128 (an exact 2x) with flip on one video
    of two frames: four score runs averaged on the device, the flipped
    init mask a negative-stride view."""
    model, variables, port = pair
    root = str(tmp_path / "davis1")
    build_fake_davis(root, n_videos=1, n_frames=2)
    kw = dict(eval_set="DAVIS17", data_root=root, max_objs=4, davis_in_size=(64, 96), chunk=2,
              scales=(64, 128), flip=True)
    with jax.disable_jit():
        jev = jax_evaluator(model, variables, tmp_path / "jax", **kw)
        jev.evaluate_davis()
    pev = port_evaluator(port, tmp_path / "port", **kw)
    before = em_kernel.launches
    pev.evaluate()
    assert em_kernel.launches == before == 0  # the CPU takes the plain versions
    assert_maps_agree(read_maps(pev.out_root), read_maps(jev.out_root))


def test_ytvos_with_a_late_object_matches(pair, tmp_path):
    """YTVOS19: object 3 appears at frame 2 and is injected there; only the
    annotated frames are saved, with the annotation ids (1 and 3)."""
    model, variables, port = pair
    root = str(tmp_path / "ytvos")
    box = build_fake_ytvos(root)
    kw = dict(eval_set="YTVOS19", data_root=root, max_objs=4, ssize=64, chunk=2)
    with jax.disable_jit():
        jev = jax_evaluator(model, variables, tmp_path / "jax", **kw)
        jev.evaluate_ytvos()
    pev = port_evaluator(port, tmp_path / "port", **kw)
    assert pev.val() is None  # no public ground truth
    got = read_maps(pev.out_root)
    assert sorted(os.listdir(os.path.join(pev.out_root, "video0"))) == [
        "00000.png", "00002.png", "00004.png"]
    assert set(np.unique(got["video0"])) <= {0, 1, 3}
    assert (got["video0"][1][box] == 3).all()  # frame 2: the injected box, exactly
    assert_maps_agree(got, read_maps(jev.out_root))


@pytest.mark.parametrize("eval_set", ["DAVIS17", "YTVOS19"])
def test_video_batch_matches_sequential(pair, fake_davis, tmp_path, eval_set):
    """video_batch=2 against sequential within the port. YTVOS19 runs the
    four-video tree of ``test_eval_e2e``: a late object, a shorter batch-mate
    padded with its last frame, and a video of another size in its own
    group."""
    _, _, port = pair
    if eval_set == "DAVIS17":
        kw = dict(data_root=fake_davis, davis_in_size=(64, 96))
    else:
        import test_eval_e2e

        root = str(tmp_path / "ytvos4")
        test_eval_e2e.TestEvaluatorE2E._build_fake_ytvos(root)
        kw = dict(data_root=root, ssize=64)
    maps = {}
    for vb in (1, 2):
        ev = port_evaluator(port, tmp_path / f"vb{vb}", eval_set=eval_set, max_objs=4, chunk=2,
                            video_batch=vb, visualize=vb == 1, **kw)
        assert ev.evaluate() > 0 and ev.fps > 0
        maps[vb] = read_maps(ev.out_root)
    assert len(maps[1]) == (2 if eval_set == "DAVIS17" else 4)
    assert_maps_agree(maps[2], maps[1])
    if eval_set == "DAVIS17":  # --visualize: one overlay per frame (DAVIS only)
        overlays = tmp_path / "vb1" / "SWEM" / "S0" / "swem" / "results" / "DAVIS17" / "overlay"
        assert sorted(len(os.listdir(overlays / v)) for v in ("vid0", "vid1")) == [5, 5]


def test_one_model_serves_every_bucket(pair, tmp_path, fake_davis):
    """Buckets 2, 4 and 8 of a 12-slot YouTube-VOS budget; the multi-scale
    mode refuses video batches; object parallelism on the CPU, one device,
    clamps to unsharded runners."""
    _, _, port = pair
    ev = port_evaluator(port, tmp_path / "b", eval_set="DAVIS17", data_root=fake_davis,
                        max_objs=8)
    assert [ev._slot_bucket(n) for n in (0, 1, 2, 3, 4, 5, 8, 9)] == [2, 2, 2, 4, 4, 8, 8, 8]
    assert ev.initial_bases(4).kappa.shape[1] == 4
    base = dict(eval_set="DAVIS17", data_root=fake_davis)
    with pytest.raises(ValueError, match="video_batch"):
        Evaluator(SWEMConfig(model=port.cfg, eval=EvalConfig(**base, video_batch=2, flip=True),
                             log_dir=str(tmp_path)), port.state_dict(), device="cpu")
    ev = Evaluator(SWEMConfig(model=port.cfg, eval=EvalConfig(**base, obj_parallel=2),
                              log_dir=str(tmp_path)), port.state_dict(), device="cpu")
    assert ev._obj_mesh(4) is None and ev._batch_mesh(2) == (1, None)


@pytest.mark.parametrize("multi_scale", [False, True])
def test_single_frame_videos(pair, tmp_path, multi_scale):
    """A video of only its annotated frame predicts nothing and saves frame 0."""
    _, _, port = pair
    root = str(tmp_path / "davis_t1")
    build_fake_davis(root, n_videos=1, n_frames=1)
    scales = dict(scales=(64, 128), flip=True) if multi_scale else {}
    ev = port_evaluator(port, tmp_path / "logs", eval_set="DAVIS17", data_root=root,
                        max_objs=4, davis_in_size=(64, 96), **scales)
    ev.evaluate()
    assert read_maps(ev.out_root)["vid0"].shape == (1, 64, 96)


# ---------------------------------------------------------------------- #
# the Gaussian locality read (n_kernel > 0)

def _read_inputs(rng, B=2, N=3, h=6, w=8, Ck=16, Cv=12, Lm=16):
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, h * w, Ck), (B, N, 2, Ck, Lm), (B, N, 2, Cv, Lm))]
    valid = np.ones((B, N, 2, Lm), bool)
    valid[:, 0, :, Lm // 2:] = False  # object 0: update bank not yet valid
    valid[:, 2] = False  # object 2: never seen
    return arrays + [valid], (h, w)


@pytest.mark.parametrize("n_kernel,sigma", [(2, 7.0), (5, 2.0)])
def test_locality_read_matches(n_kernel, sigma):
    """``read_memory(n_kernel > 0)`` against the JAX package's XLA read at
    rtol 1e-5 (atol 1e-6 for values near 0). The masked rows hold -inf
    affinities, so their top-k over pixels ties everywhere and the two
    packages may pick other pixels; exp_aff zeroes those rows all the same:
    no NaN, and an object with no valid base reads exactly 0."""
    arrays, hw = _read_inputs(np.random.default_rng(n_kernel))
    kw = dict(tau=0.05, topl=4, n_kernel=n_kernel, sigma=sigma, hw=hw)
    ref_out, ref_S = jem.read_memory(*arrays, **kw)
    before = read_kernel.launches
    got_out, got_S = em.read_memory(*(t(a) for a in arrays), **kw)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(ref_out), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_S.numpy(), np.asarray(ref_S), rtol=1e-5, atol=1e-6)
    assert torch.isfinite(got_out).all() and torch.isfinite(got_S).all()
    assert not got_out[:, 2].any()
    _, exp_aff = em._read_ops(*(t(a) for a in arrays), tau=0.05, n_kernel=n_kernel,
                              sigma=sigma, hw=hw)
    assert not exp_aff[~t(arrays[3])].any()  # every masked base row exactly 0
    plain_out, _ = em.read_memory(*(t(a) for a in arrays), tau=0.05, topl=4)
    assert not torch.allclose(plain_out, got_out)  # the weighting changes the read
    assert read_kernel.launches == before == 0
    with pytest.raises(ValueError, match="hw"):
        em.read_memory(*(t(a) for a in arrays), tau=0.05, topl=4, n_kernel=2)


def test_locality_read_through_match(pair):
    """``SWEM.match`` hands the query grid to the locality read: the pair's
    weights with n_kernel = 2, sigma = 7 read a memory of two slots (both
    banks valid, the second slot never seen) as the JAX package's do. The
    grid and slots are the DAVIS tests', whose eager ops JAX has cached."""
    model, variables, port = pair
    jax_local = JaxSWEM(dataclasses.replace(model.cfg, n_kernel=2, kernel_sigma=7.0))
    local = SWEM(dataclasses.replace(port.cfg, n_kernel=2, kernel_sigma=7.0), device="cpu")
    local.load_state_dict(port.state_dict())
    cfg, rng = model.cfg, np.random.default_rng(4)
    jmem = jem.fresh_memory(jax.random.PRNGKey(5), 1, 2, cfg.keydim, cfg.valdim, cfg.num_bases)
    nu = rng.standard_normal(jmem.first.nu.shape).astype(np.float32)
    bank = jem.Bases(jmem.first.kappa, nu, jmem.first.zita)
    jmem = jem.VOSMemory(first=bank, update=bank, obj_seen=np.asarray([[True, False]]),
                         mem_count=np.int32(2))
    pbank = em.Bases(t(bank.kappa), t(nu), t(bank.zita))
    pmem = em.VOSMemory(first=pbank, update=pbank, obj_seen=t(jmem.obj_seen), mem_count=2)
    qk = rng.standard_normal((1, 4, 6, cfg.keydim)).astype(np.float32)
    qv = rng.standard_normal((1, 4, 6, cfg.valdim)).astype(np.float32)
    ref = np.asarray(jax_local.apply(variables, qk, qv, jmem, method="match"))  # (B,N,h,w,Cv)
    args = (t(qk).permute(0, 3, 1, 2), t(qv).permute(0, 3, 1, 2), pmem)
    with torch.no_grad():
        got, other = local.match(*args), port.match(*args)
    np.testing.assert_allclose(got.permute(0, 1, 3, 4, 2).numpy(), ref, rtol=1e-5, atol=1e-5)
    assert not torch.allclose(other, got)  # the same weights without the locality read


# ---------------------------------------------------------------------- #
# the entry point

def cli_argv(root, pth, log_dir, *extra):
    return ["--eval_set", "DAVIS17", "--data_root", root, "--resume", pth, "--log_dir",
            str(log_dir), "--backbone", "resnet18", "--key_dim", "16", "--val_dim", "32",
            "--num_bases", "8", "--em_iters", "2", "--top_l", "4", "--max_objs", "4",
            "--chunk", "2", "--davis_in_size", "64", "96", *extra]


def test_cli_on_the_cpu(pair, fake_davis, tmp_path, monkeypatch):
    """``python -m swem_tpu_torch.eval --device cpu`` in-process: a .pth in,
    global_results-DAVIS17.csv out. Without --device it wants CUDA and
    raises without a card, --obj_parallel 2 on the CPU's one device gives
    the same results, and the multi-process flags join a process group:
    --distributed alone the environment's (none here), the three rendezvous
    flags only together."""
    # eval.py's flags have no --mdim: the decoder is the flagship's 256 wide
    cfg = dataclasses.replace(pair[2].cfg, mdim=256)
    pth = str(tmp_path / "swem.pth")
    torch.save({"state_dict": SWEM(cfg, device="cpu").init_weights(0).state_dict()}, pth)
    got = cli.main(cli_argv(fake_davis, pth, tmp_path / "logs", "--device", "cpu"))
    save_dir = tmp_path / "logs" / "SWEM" / "S3" / "swem" / "results" / "DAVIS17"
    assert read_global_csv(save_dir) == pytest.approx(got, abs=5e-4)
    assert np.isfinite(got["J&F-Mean"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(cli_argv(fake_davis, pth, tmp_path / "logs2"))
    assert cli.main(cli_argv(fake_davis, pth, tmp_path / "logs3", "--device", "cpu",
                             "--obj_parallel", "2")) == got
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for flag, match in ((["--distributed"], "RANK"), (["--num_processes", "4"], "go together"),
                        (["--process_id", "0"], "go together"),
                        (["--coordinator", "localhost:1234"], "go together")):
        with pytest.raises(ValueError, match=match):
            cli.main(cli_argv(fake_davis, pth, tmp_path / "logs3", "--device", "cpu", *flag))
    args = cli.get_args(cli_argv(fake_davis, pth, tmp_path, "--n_kernel", "4", "--sigma", "5"))
    cfg = cli.build_config(args)
    assert (cfg.model.n_kernel, cfg.model.kernel_sigma, cfg.solver.stage_name) == (4, 5.0, "S3")
    assert dataclasses.asdict(cfg.eval)["davis_in_size"] == (64, 96)
