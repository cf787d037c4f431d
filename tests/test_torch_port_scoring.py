"""The port's offline scoring and host helpers against swem_tpu's, on the CPU.

- ``eval.benchmark``: the counterparts of ``tests/test_unsupervised.py``'s
  six tests, each also held against the JAX package's function on the same
  seeded inputs, with exact equality (the same numpy arithmetic on the
  same bools, and SciPy's assignment on the same score matrix).
- ``python -m swem_tpu_torch.evaluation_method`` and ``.evaluation_codalab``
  against the root ``evaluation_method.py`` and ``evaluation_codalab.py`` on
  one synthetic DAVIS tree (void pixels, a missing prediction, permuted and
  spurious proposals): byte-equal CSVs and ``scores.txt`` for both tasks
  and ``--per_object_csv``, the same exits; the port's CLI also in a
  process where JAX and ``swem_tpu`` cannot be imported.
- ``utils.visualization``, ``registry``, ``utils``, ``utils.profiling`` and
  ``data.ytvos_test``'s ``dataset_file``.
"""

import json
import logging
import os
import random
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from swem_tpu.data import ytvos_test as jytvos
from swem_tpu.data.palette import davis_palette, save_seg_mask
from swem_tpu.eval import benchmark as jbench
from swem_tpu.utils import count_model_size as jax_count_model_size
from swem_tpu.utils import pad_divide_by as jax_pad_divide_by
from swem_tpu.utils import visualization as jvis
from swem_tpu_torch import evaluation_codalab, evaluation_method, registry, utils
from swem_tpu_torch.config import ModelConfig, SWEMConfig
from swem_tpu_torch.data import ytvos_test
from swem_tpu_torch.eval import benchmark
from swem_tpu_torch.utils import profiling, visualization
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_port_data import fake_ytvos  # noqa: F401  (fixture)
from test_unsupervised import make_gt

ROOT = Path(__file__).resolve().parents[1]
H, W, T = 48, 64, 6
SEQS = ("seqA", "seqB")


def both_unsupervised(gt, proposals, **kw):
    """(J, F) of the port and of the JAX package; raises what either raises."""
    got = benchmark.evaluate_unsupervised(gt, proposals, **kw)
    ref = jbench.evaluate_unsupervised(gt, proposals, **kw)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r)
    return got


# ------------------------------------ tests/test_unsupervised.py's six --
def test_permuted_proposals_score_one(rng):
    gt = make_gt()
    j, f = both_unsupervised(gt, gt[rng.permutation(gt.shape[0])])
    np.testing.assert_allclose(j, 1.0)
    np.testing.assert_allclose(f, 1.0)


def test_extra_proposals_dont_hurt():
    gt = make_gt(n=2)
    extra = np.zeros((1,) + gt.shape[1:], bool)
    extra[0, :, 30:38, 40:55] = True
    j, _ = both_unsupervised(gt, np.concatenate([gt[::-1], extra], axis=0))
    np.testing.assert_allclose(j, 1.0)


def test_fewer_proposals_zero_padded():
    gt = make_gt(n=3)
    j, _ = both_unsupervised(gt, gt[:1])
    assert j.shape == (3, 4)
    means = sorted(j.mean(-1))
    assert means[-1] == 1.0 and means[0] == 0.0


def test_too_many_proposals_rejected():
    gt = make_gt(n=1)
    too_many = np.zeros((25,) + gt.shape[1:], bool)
    for fn in (benchmark.evaluate_unsupervised, jbench.evaluate_unsupervised):
        with pytest.raises(ValueError, match="25 proposals exceed the maximum 20"):
            fn(gt, too_many)


def test_confident_pixels_low_uncertainty():
    score = np.zeros((1, 4, 4, 3), np.float32)
    score[..., 0], score[..., 1], score[..., 2] = 0.98, 0.01, 0.01
    flat = np.full((1, 4, 4, 3), 1 / 3, np.float32)
    u_conf, u_unc = visualization.calc_uncertainty(score), visualization.calc_uncertainty(flat)
    assert u_conf.mean() < u_unc.mean()
    assert u_conf.shape == (1, 4, 4, 1)
    for s in (score, flat):
        assert np.array_equal(visualization.calc_uncertainty(s), jvis.calc_uncertainty(s))


def test_reads_unsupervised_annotations_folder(tmp_path):
    """task='unsupervised' reads Annotations_unsupervised and scores the
    Hungarian-matched proposals end to end, as the JAX package does."""
    root = tmp_path / "davis"
    (root / "ImageSets" / "2019").mkdir(parents=True)
    (root / "ImageSets" / "2019" / "val.txt").write_text("seq0\n")
    adir = root / "Annotations_unsupervised" / "480p" / "seq0"
    rdir = tmp_path / "res" / "seq0"
    adir.mkdir(parents=True)
    rdir.mkdir(parents=True)
    pal = davis_palette()
    for t in range(4):
        lab = np.zeros((40, 60), np.uint8)
        lab[10:30, 10:30] = 1
        lab[10:30, 35:55] = 2
        save_seg_mask(lab, str(adir / f"{t:05d}.png"), pal)
        save_seg_mask(np.choose(lab, [0, 2, 1]).astype(np.uint8), str(rdir / f"{t:05d}.png"), pal)
    got = benchmark.DavisEvaluation(str(root), year="2019", task="unsupervised").evaluate(
        str(tmp_path / "res"))
    ref = jbench.DavisEvaluation(str(root), year="2019", task="unsupervised").evaluate(
        str(tmp_path / "res"))
    np.testing.assert_allclose(got["J"]["M"], 1.0)
    np.testing.assert_allclose(got["F"]["M"], 1.0)
    assert_same_metrics(got, ref)


def test_unsupervised_matches_on_random_proposals(rng):
    """Random blobs, void pixels and ties (two identical proposals):
    the same series, so the same assignment, tie-breaks included."""
    gt = rng.random((3, T, 24, 32)) < 0.3
    proposals = rng.random((5, T, 24, 32)) < 0.3
    proposals[4] = proposals[1]
    void = rng.random((T, 24, 32)) < 0.05
    for metric in (("J", "F"), ("J",), ("F",)):
        both_unsupervised(gt, proposals, void=void, metric=metric)


def assert_same_metrics(got: dict, ref: dict):
    assert got.keys() == ref.keys()
    for m in ref:
        for k in ("M", "R", "D"):
            assert got[m][k] == ref[m][k], (m, k)
        assert got[m]["M_per_object"] == ref[m]["M_per_object"]
        assert got[m]["per_obj_frame"].keys() == ref[m]["per_obj_frame"].keys()
        for name, v in ref[m]["per_obj_frame"].items():
            assert np.array_equal(got[m]["per_obj_frame"][name], v), (m, name)


# --------------------------------------------------------- the CLIs --
def boxes(t: int, n: int, shift: int = 0) -> np.ndarray:
    """A label map of ``n`` boxes moving with ``t``, a void band at the bottom."""
    lab = np.zeros((H, W), np.uint8)
    for i in range(n):
        y, x = 4 + 12 * i + t, 3 + 16 * i + 2 * t + shift
        lab[y:y + 9, x:x + 12] = i + 1
    lab[-3:, :] = 255
    return lab


@pytest.fixture(scope="module")
def davis_tree(tmp_path_factory):
    """DAVIS 2017 val of two sequences (2 and 3 objects) with both annotation
    folders; predictions (shifted, one frame missing); proposals (ids
    permuted, a spurious one); the ground truth copied as a submission."""
    root = tmp_path_factory.mktemp("scoring")
    davis = root / "davis"
    (davis / "ImageSets" / "2017").mkdir(parents=True)
    (davis / "ImageSets" / "2017" / "val.txt").write_text("\n".join(SEQS) + "\n")
    pal = davis_palette()
    rng = np.random.default_rng(11)
    for s, seq in enumerate(SEQS):
        n = 2 + s
        perm = np.concatenate([[0], rng.permutation(n) + 1])
        dirs = {k: root / k / seq for k in ("pred", "proposals", "gt_copy")}
        dirs["ann"] = davis / "Annotations" / "480p" / seq
        dirs["unsup"] = davis / "Annotations_unsupervised" / "480p" / seq
        for d in dirs.values():
            d.mkdir(parents=True)
        for t in range(T):
            gt = boxes(t, n)
            for key in ("ann", "unsup", "gt_copy"):
                save_seg_mask(gt, str(dirs[key] / f"{t:05d}.png"), pal)
            if not (s == 1 and t == 3):  # a prediction missing
                pred = boxes(t, n, shift=int(rng.integers(0, 3)))
                pred[-3:] = 0
                save_seg_mask(pred, str(dirs["pred"] / f"{t:05d}.png"), pal)
            prop = np.where(gt == 255, 0, perm[np.where(gt == 255, 0, gt)]).astype(np.uint8)
            prop[0:5, -8:] = n + 1  # a spurious proposal
            save_seg_mask(prop, str(dirs["proposals"] / f"{t:05d}.png"), pal)
    return root


def run_cli(port: bool, name: str, argv, monkeypatch, capsys):
    """A scoring CLI in this process: (exit code or message, stdout without
    its timing line)."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + [str(a) for a in argv])
    code = 0
    try:
        if port:
            {"evaluation_method": evaluation_method,
             "evaluation_codalab": evaluation_codalab}[name].main()
        else:
            runpy.run_path(str(ROOT / f"{name}.py"), run_name="__main__")
    except SystemExit as e:
        code = e.code
    out = capsys.readouterr().out
    return code, "\n".join(ln for ln in out.splitlines() if not ln.startswith("Total time"))


def files(d: Path, pattern: str) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.glob(pattern))}


@pytest.mark.parametrize("task,results,extra", [
    ("semi-supervised", "pred", []),
    ("semi-supervised", "pred", ["--per_object_csv"]),
    ("unsupervised", "proposals", []),
])
def test_evaluation_method_matches_root_cli(davis_tree, tmp_path, monkeypatch, capsys, task,
                                            results, extra):
    outs = {}
    for port in (False, True):
        res = tmp_path / ("port" if port else "root")
        import shutil

        shutil.copytree(davis_tree / results, res)
        outs[port] = run_cli(port, "evaluation_method", [
            "--davis_path", davis_tree / "davis", "--task", task, "--results_path", res] + extra,
            monkeypatch, capsys)
        outs[port] += (files(res, "*.csv"),)
    assert outs[True] == outs[False]
    code, stdout, csvs = outs[True]
    assert code == 0 and "--- Global results for DAVIS17 ---" in stdout
    assert sorted(csvs) == sorted(["global_results-DAVIS17.csv",
                                   "per-sequence_results-DAVIS17.csv"]
                                  + (["per-object_results-DAVIS17.csv"] if extra else []))
    jf = float(csvs["global_results-DAVIS17.csv"].decode().split()[1].split(",")[0])
    assert 0.0 < jf < 1.0 if task == "semi-supervised" else jf == 1.0


def codalab_input(davis_tree, root: Path, submission: str, drop=None) -> Path:
    import shutil

    shutil.copytree(davis_tree / "davis", root / "ref")
    shutil.copytree(davis_tree / submission, root / "res")
    if drop:
        shutil.rmtree(root / "res" / drop)
    return root


@pytest.mark.parametrize("case", ["ground truth", "prediction", "missing sequence",
                                  "no submission"])
def test_evaluation_codalab_matches_root_cli(davis_tree, tmp_path, monkeypatch, capsys, case):
    outs = {}
    for port in (False, True):
        side = tmp_path / ("port" if port else "root")
        inp = codalab_input(davis_tree, side / "input",
                            "pred" if case == "prediction" else "gt_copy",
                            drop=SEQS[1] if case == "missing sequence" else None)
        if case == "no submission":
            import shutil

            shutil.rmtree(inp / "res")
        code, stdout = run_cli(port, "evaluation_codalab",
                               [inp, side / "output", "--set", "val"], monkeypatch, capsys)
        scores = (side / "output" / "scores.txt")
        outs[port] = (code if isinstance(code, int) else code.replace(str(side), "<side>"),
                      stdout, scores.read_bytes() if scores.exists() else None)
    assert outs[True] == outs[False]
    code, _, scores = outs[True]
    if case == "ground truth":
        assert code == 0 and scores.decode().startswith("GlobalMean: 1.000000\n")
    elif case == "prediction":
        assert code == 0 and len(scores.decode().splitlines()) == 7
    elif case == "missing sequence":
        assert code == f"Submission is missing sequences: {[SEQS[1]]} ..." and scores is None
    else:
        assert code == "Could not find submission file <side>/input/res" and scores is None


def test_port_cli_runs_without_jax(davis_tree, tmp_path):
    """``python -m swem_tpu_torch.evaluation_method`` where importing JAX,
    flax, optax, orbax or swem_tpu fails: ``--help``, then the
    semi-supervised scores, byte-equal to the root CLI's."""
    import shutil

    block = ("import sys, runpy\n"
             "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'swem_tpu'):\n"
             "    sys.modules[m] = None\n"
             "sys.argv = ['evaluation_method'] + sys.argv[1:]\n"
             "runpy.run_module('swem_tpu_torch.evaluation_method', run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", block, "--help"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "--results_path" in out.stdout, out.stderr
    shutil.copytree(davis_tree / "pred", tmp_path / "port")
    shutil.copytree(davis_tree / "pred", tmp_path / "root")
    for side, cmd in (("port", [sys.executable, "-c", block]),
                      ("root", [sys.executable, str(ROOT / "evaluation_method.py")])):
        out = subprocess.run(cmd + ["--davis_path", str(davis_tree / "davis"), "--results_path",
                                    str(tmp_path / side)], cwd=ROOT, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
    assert files(tmp_path / "port", "*.csv") == files(tmp_path / "root", "*.csv")


# ------------------------------------------------------- host helpers --
def test_save_heatmap_writes_the_same_png(tmp_path, rng):
    img = rng.random((30, 40, 3)).astype(np.float32)
    heat = rng.random((8, 10)).astype(np.float32)
    for invert in (True, False):
        visualization.save_heatmap(str(tmp_path / "port.png"), img, heat, invert=invert)
        jvis.save_heatmap(str(tmp_path / "jax.png"), img, heat, invert=invert)
        assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()


def test_trainer_registry(tmp_path):
    """"SWEM" is registered at first use; another name plugs in; an unknown
    one raises ``KeyError``."""
    from swem_tpu_torch.train.loop import Trainer

    cfg = SWEMConfig(model=ModelConfig(backbone="resnet18", keydim=8, valdim=16, num_bases=4,
                                       num_em_iters=2, topl=2, mdim=16),
                     log_dir=str(tmp_path))
    tr = registry.get_trainer(cfg, device="cpu")
    assert type(tr) is Trainer and registry.TRAINERS["SWEM"] is Trainer
    assert tr.state.step == 0

    @registry.register_trainer("Other")
    class Other:
        def __init__(self, cfg, tag):
            self.tag = tag

    try:
        other = registry.get_trainer(SWEMConfig(model=ModelConfig(model_name="Other")), "x")
        assert isinstance(other, Other) and other.tag == "x"
    finally:
        del registry.TRAINERS["Other"]
    with pytest.raises(KeyError, match="unknown trainer 'Nope'"):
        registry.get_trainer(SWEMConfig(model=ModelConfig(model_name="Nope")))


def test_small_utilities_match(tmp_path):
    utils.init_random_seed(3)
    got = (random.random(), np.random.rand())
    random.seed(3)
    np.random.seed(3)
    assert got == (random.random(), np.random.rand())
    for shape in ((480, 854), (1, 1), (16, 17), (720, 1280), (33, 15)):
        for d in (8, 16, 32):
            assert utils.pad_divide_by(shape, d) == jax_pad_divide_by(shape, d)
    from _torch_port_util import tiny_pair

    _, variables, port = tiny_pair()
    want = jax_count_model_size(variables["params"])
    assert utils.count_model_size(port) == utils.count_model_size(port.state_dict()) == want
    snap = Path(utils.save_scripts(str(tmp_path)))
    assert snap == tmp_path / "scripts_snapshot"
    assert (snap / "utils" / "__init__.py").read_bytes() == Path(utils.__file__).read_bytes()
    assert (snap / "csrc" / "em_loop.cu").is_file() and not list(snap.rglob("__pycache__"))
    utils.save_scripts(str(tmp_path))  # a second snapshot replaces the first


def test_ytvos_dataset_file(fake_ytvos, tmp_path):  # noqa: F811
    """``dataset_file`` in the JAX package's position picks the meta file."""
    from test_torch_port_data import assert_same_video

    with open(os.path.join(fake_ytvos, "meta.json")) as f:
        meta = json.load(f)
    first = next(iter(meta["videos"]))
    with open(os.path.join(fake_ytvos, "meta_one.json"), "w") as f:
        json.dump({"videos": {first: meta["videos"][first]}}, f)
    got = ytvos_test.YTVOSTestSet(fake_ytvos, "meta_one.json", 64, 4)
    ref = jytvos.YTVOSTestSet(fake_ytvos, "meta_one.json", 64, 4)
    assert got.videos == ref.videos == [first]
    assert_same_video(got[0], ref[0])
    os.remove(os.path.join(fake_ytvos, "meta_one.json"))


def write_chrome_trace(trace_dir: Path, events, name="host_1.100.pt.trace.json") -> None:
    trace_dir.mkdir(parents=True, exist_ok=True)
    (trace_dir / name).write_text(json.dumps({"traceEvents": events}))


def test_device_seconds_from_trace(tmp_path):
    """Overlapping kernels count once, copies, sets and host events not at
    all; the newest trace is read; a trace without kernels raises."""
    events = [
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 100.0, "dur": 50.0},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 120.0, "dur": 50.0},   # overlaps a
        {"ph": "X", "cat": "kernel", "name": "c", "ts": 300.0, "dur": 10.5},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 180.0, "dur": 100.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 400.0, "dur": 30.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 1000.0},
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 120.0},
    ]
    write_chrome_trace(tmp_path / "run", events)
    assert profiling.device_seconds_from_trace(str(tmp_path)) == pytest.approx(80.5e-6, abs=1e-12)
    assert profiling.load_latest_trace(str(tmp_path))["traceEvents"] == events
    write_chrome_trace(tmp_path / "run", events[3:], name="host_1.200.pt.trace.json")
    os.utime(tmp_path / "run" / "host_1.100.pt.trace.json", (1000, 1000))
    with pytest.raises(RuntimeError, match="no CUDA kernel event"):
        profiling.device_seconds_from_trace(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        profiling.load_latest_trace(str(tmp_path / "empty"))


def test_profile_trace_and_memory_on_the_cpu(tmp_path, caplog):
    """On the CPU: ``profile_trace`` writes a trace the loader reads, which
    has no kernel to count; no memory statistics."""
    with profiling.profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any(e.name == "aten::mm" for e in prof.events())
    data = profiling.load_latest_trace(str(tmp_path / "trace"))
    assert any(ev.get("name") == "aten::mm" for ev in data["traceEvents"])
    with pytest.raises(RuntimeError):
        profiling.device_seconds_from_trace(str(tmp_path / "trace"))
    with pytest.raises(RuntimeError):
        profiling.device_busy_seconds(prof)
    assert profiling.device_memory_stats("cpu") is None
    assert profiling.device_memory_stats(torch.device("cpu")) is None
    logger = logging.getLogger("scoring_test")
    with caplog.at_level(logging.INFO, logger="scoring_test"):
        profiling.log_memory(logger, "cpu", prefix="after step: ")
    assert caplog.messages == ["after step: memory stats unavailable on this backend"]
