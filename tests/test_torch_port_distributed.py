"""The port's data parallelism against one process and swem_tpu, on the CPU.

Two ranks (``_torch_port_mp_worker.py``) join a Gloo process group through
the JAX CLI's rendezvous flags, each on one PyTorch thread, while this
process and one more (``jax_reference_step``) compute the references; the
ranks import only the port and get
their inputs (numpy-born weights, the global batch, the JAX package's
draws) through files. Held, with the tolerances stated per test:
- the loader's shards: interleaved, the one-shard batches bit for bit; each
  the JAX loader's shard of the same id bit for bit; its workers on one
  OpenMP/BLAS/OpenCV/PyTorch thread, the parent's environment untouched;
- one DDP train step (global batch 4, 2 per rank, ``TRAIN_DIMS``) against
  the JAX package's step, run op by op, on the global batch and draws: the
  logged global
  loss at 1e-5 relative, every averaged gradient at
  ||port - jax|| <= 1e-4 ||jax|| + 1e-7 (``test_torch_port_train.py``'s
  bounds); the ranks' gradients and parameters bit-equal to each other; the
  logged loss within 1e-6 of the port's one-process step;
- the training CLI at 2 ranks: rank 0 alone writes, its ``state.pth`` has
  no ``module.`` keys and resumes in a one-process ``Trainer``;
- distributed evaluation on 4 fake DAVIS videos, sequentially and at
  ``video_batch=2``: disjoint slices covering the set, the PNGs bit-equal
  to the port's one-process evaluator, J&F within 1e-9 from rank 0 alone,
  and video 0 at >= 99.9% of pixels against the JAX evaluator run op by op.
"""

import glob
import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch
from PIL import Image

from swem_tpu import engine as jeng
from swem_tpu.config import DataConfig as JaxDataConfig
from swem_tpu.config import EvalConfig as JaxEvalConfig
from swem_tpu.config import ModelConfig as JaxModelConfig
from swem_tpu.config import SolverConfig as JaxSolverConfig
from swem_tpu.config import SWEMConfig as JaxSWEMConfig
from swem_tpu.data.factory import build_train_loader as jax_build_train_loader
from swem_tpu.eval.evaluator import Evaluator as JaxEvaluator
from swem_tpu.models import em as jem
from swem_tpu_torch import parallel
from swem_tpu_torch.config import DataConfig, EvalConfig, ModelConfig, SolverConfig, SWEMConfig
from swem_tpu_torch.data.factory import build_train_loader
from swem_tpu_torch.data.loader import TrainLoader
from swem_tpu_torch.eval import __main__ as eval_cli
from swem_tpu_torch.eval.evaluator import Evaluator
from swem_tpu_torch.io.checkpoint import STATE_FILE, VARIABLES_FILE
from swem_tpu_torch.models import em
from swem_tpu_torch.models.swem import SWEM
from swem_tpu_torch.train import __main__ as train_cli
from swem_tpu_torch.train import trainer
from swem_tpu_torch.train.loop import Trainer
from _torch_port_util import TINY_FIELDS, jax_bases, t, tiny_pair
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse fixture)
from test_eval_e2e import build_fake_davis
from test_factory import build_roots
from test_torch_port_train import KEY, TRAIN_DIMS, jax_step_grads, port_step
from test_torch_port_train_data import data_kw, solver_kw, take

WORKER = Path(__file__).with_name("_torch_port_mp_worker.py")
WORLD, GLOBAL_B, T, HW, N = 2, 4, 3, 32, 2
SEED = 123  # DataConfig.seed: the evaluators' bases
EVAL_KW = dict(eval_set="DAVIS17", max_objs=4, davis_in_size=(64, 96), chunk=2)
TINY_ARGS = ["--backbone", "resnet18", "--key_dim", "8", "--val_dim", "16", "--num_bases", "4",
             "--em_iters", "2", "--top_l", "2"]


def free_ports(n: int):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("localhost", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def global_batch() -> dict:
    """uint8 frames and slot labels of 4 clips: two boxes, the first moving;
    slot 2 invalid in clips 1 and 2, so that the ranks' halves differ."""
    rng = np.random.default_rng(4)
    label = np.zeros((GLOBAL_B, T, HW, HW), np.uint8)
    for i in range(T):
        label[:, i, 4 + 2 * i:14 + 2 * i, 4:14] = 1
    label[:, :, 18:28, 18:28] = 2
    valid = np.ones((GLOBAL_B, N + 1), np.float32)
    valid[1:3, 2] = 0.0
    label[1:3][label[1:3] == 2] = 0
    return {"frames": rng.integers(0, 256, (GLOBAL_B, T, HW, HW, 3), dtype=np.uint8),
            "label": label, "valid_obj": valid}


def jax_reference_step(out_path: str) -> None:
    """The JAX package's loss and gradients on the global batch and draws,
    op by op, saved to ``out_path``; run in a process of its own beside the
    ranks. On this batch the jitted step moves its own loss by 6e-5 and its
    gradients by up to 4% (EM at tau = 0.05 amplifies XLA's fused
    rounding); op by op it agrees with the port to 1e-7."""
    jmodel, variables, _ = tiny_pair(seed=3, jcfg=JaxModelConfig(**TRAIN_DIMS))
    with jax.disable_jit():
        out, _, grads = jax_step_grads(jmodel, variables, global_batch(), 0)
    torch.save({"loss": float(out["total_loss"]), "grads": grads}, out_path)


def read_maps(out_root):
    """{video: (T, H, W) uint8} of every PNG under an evaluator's output."""
    return {v: np.stack([np.array(Image.open(os.path.join(out_root, v, f)))
                         for f in sorted(os.listdir(os.path.join(out_root, v)))])
            for v in sorted(os.listdir(out_root))}


def port_evaluator(port, log_dir, root, bases, **eval_kw):
    cfg = SWEMConfig(model=port.cfg, eval=EvalConfig(data_root=root, **EVAL_KW, **eval_kw),
                     log_dir=str(log_dir))
    ev = Evaluator(cfg, port.state_dict(), device="cpu")
    ev.initial_bases = lambda n: em.Bases(*bases[n])
    return ev


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ddp_train_data"))
    build_roots(root)  # DAVIS and YouTube-VOS train layouts, 2 videos each
    return root


@pytest.fixture(scope="module")
def runs(tmp_path_factory, train_root):
    """Both ranks' results, and this process's references computed while
    the ranks run."""
    work = tmp_path_factory.mktemp("ddp")
    davis, davis_one = str(work / "davis"), str(work / "davis_one")
    build_fake_davis(davis, n_videos=4)
    build_fake_davis(davis_one, n_videos=1)  # video 0 alone, the same bits
    # the train step's inputs: tamed weights, the global batch, JAX's draw
    _, _, port = tiny_pair(seed=3, jcfg=JaxModelConfig(**TRAIN_DIMS))
    batch = global_batch()
    mem = jem.fresh_memory(jax.random.fold_in(KEY, 0), GLOBAL_B, N, 8, 16, 4)
    bases = [t(mem.first.kappa), t(mem.first.nu), t(mem.first.zita)]
    torch.save({"weights": port.state_dict(), "batch": {k: t(v) for k, v in batch.items()},
                "bases": bases}, work / "step_inputs.pt")
    # the evaluators' inputs: the JAX package's bases per slot bucket
    ejmodel, evariables, eport = tiny_pair(seed=1, max_objs=4)
    ebases = {n: list(vars(jax_bases(ejmodel.cfg, jax.random.PRNGKey(SEED), n)).values())
              for n in (2, 4)}
    torch.save(eport.state_dict(), work / "eval_weights.pt")
    torch.save(ebases, work / "eval_bases.pt")
    cli0 = work / "cli0" / "SWEM" / "S2" / "ddp"
    train_argv = ["--stage", "2", "--data_root", train_root, *TINY_ARGS, "--crop_size", "32",
                  "--batch_size", "2", "--num_workers", "0", "--exp", "ddp", "--log_period",
                  "1", "--save_period", "2", "--vis_period", "1", "--total_iters", "2", "2"]
    spec = {"dir": str(work), "ports": free_ports(3), "global_batch": GLOBAL_B,
            "train_dims": TRAIN_DIMS, "solver": {"base_lr": 2e-4},
            "step_inputs": str(work / "step_inputs.pt"),
            "eval_dims": {k: getattr(eport.cfg, k) for k in TINY_FIELDS},
            "eval_weights": str(work / "eval_weights.pt"),
            "eval_bases": str(work / "eval_bases.pt"), "davis": davis,
            "eval": {k: v for k, v in EVAL_KW.items()}, "train_argv": train_argv,
            "eval_argv": ["--eval_set", "DAVIS17", "--data_root", davis, "--resume",
                          str(cli0 / "checkpoints" / VARIABLES_FILE), "--log_dir",
                          str(work / "eval_cli"), *TINY_ARGS, "--max_objs", "4", "--chunk",
                          "2", "--davis_in_size", "64", "96"]}
    (work / "spec.json").write_text(json.dumps(spec))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = str(WORKER.parents[1]) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    tests = str(WORKER.parent)
    jax_step = (f"import sys; sys.path[:0] = [{tests!r}]; import conftest, "
                f"test_torch_port_distributed as m; m.jax_reference_step({str(work / 'jax.pt')!r})")
    commands = [[str(WORKER), str(work / "spec.json"), str(r)] for r in range(WORLD)]
    logs = [open(work / f"proc{i}.log", "w") for i in range(WORLD + 1)]
    procs = [subprocess.Popen([sys.executable, *cmd], stdout=log, stderr=subprocess.STDOUT,
                              env=env) for cmd, log in zip(commands + [["-c", jax_step]], logs)]
    try:
        ref = {}
        cfg = SWEMConfig(model=port.cfg, solver=SolverConfig(base_lr=2e-4))
        out, _, _ = port_step(port, batch, em.Bases(*bases), cfg=cfg)
        ref["port_loss"] = float(out["total_loss"])
        for tag, kw in (("seq", {}), ("vb", {"video_batch": 2})):
            ev = port_evaluator(eport, work / f"one_{tag}", davis, ebases, **kw)
            ref[f"metrics_{tag}"], ref[f"maps_{tag}"] = ev.val(), read_maps(ev.out_root)
        ref["n_videos"] = len(ev.dataset)
        # the JAX evaluator on video 0, op by op, its warm-up only moving compilation
        with pytest.MonkeyPatch.context() as mp, jax.disable_jit():
            mp.setattr(jeng.ChunkedVideoRunner, "warmup", lambda self, *a, **kw: None)
            jcfg = JaxSWEMConfig(model=ejmodel.cfg, eval=JaxEvalConfig(data_root=davis_one,
                                                                     **EVAL_KW),
                                 log_dir=str(work / "jax"))
            jev = JaxEvaluator(jcfg, evariables)
            jev.evaluate_davis()
            ref["jax_maps"] = read_maps(jev.out_root)
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    for i, p in enumerate(procs):
        assert p.returncode == 0, (work / f"proc{i}.log").read_text()[-4000:]
    jax_ref = torch.load(work / "jax.pt", weights_only=True)
    ref["jax_loss"], ref["jax_grads"] = jax_ref["loss"], jax_ref["grads"]
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"ranks": ranks, "ref": ref, "work": work, "cli0": cli0, "train_argv": train_argv,
            "port": port}


# ---------------------------------------------------------------- loader --
def test_loader_shards_interleave_and_match_jax(train_root):
    """3 steps from iteration 1 at global batch 4: rows r::2 of the one-shard
    batch are shard r's, bit for bit, and shard r is the JAX loader's shard
    r; a global batch that 2 shards do not divide raises."""
    kw = {**data_kw(train_root), "batch_size": GLOBAL_B}
    cfg = SWEMConfig(data=DataConfig(**kw), solver=SolverConfig(**solver_kw(3)))
    jcfg = JaxSWEMConfig(data=JaxDataConfig(**kw), solver=JaxSolverConfig(**solver_kw(3)))
    whole = take(build_train_loader(cfg, start_iter=1), 3)
    for r in range(WORLD):
        shard = take(build_train_loader(cfg, start_iter=1, shard_id=r, num_shards=WORLD), 3)
        ref = take(jax_build_train_loader(jcfg, start_iter=1, shard_id=r, num_shards=WORLD), 3)
        for step, (a, w, j) in enumerate(zip(shard, whole, ref)):
            assert set(a) == set(w) == set(j)
            for k in a:
                assert a[k].dtype == j[k].dtype and np.array_equal(a[k], j[k]), (r, step, k)
                assert np.array_equal(a[k], w[k][r::WORLD]), (r, step, k)
    odd = cfg.replace(data=DataConfig(**{**kw, "batch_size": 3}))
    with pytest.raises(ValueError, match="does not divide"):
        build_train_loader(odd, shard_id=0, num_shards=WORLD)


def test_loader_workers_run_one_thread(monkeypatch):
    """The loader's spawned workers start with OpenMP/BLAS at one thread and
    run OpenCV and PyTorch on one; the parent's environment is left as it
    was."""
    from _torch_port_mp_worker import ThreadProbe

    monkeypatch.setenv("OMP_NUM_THREADS", "7")
    monkeypatch.delenv("OPENBLAS_NUM_THREADS", raising=False)
    before = dict(os.environ)
    (batch,) = take(TrainLoader(ThreadProbe, 2, num_workers=1), 1)
    assert dict(os.environ) == before
    assert batch["env"].tolist() == [[1, 1, 1]] * 2
    assert batch["cv2"].tolist() == [1, 1] and batch["torch"].tolist() == [1, 1]


# ------------------------------------------------------------ train step --
def test_ddp_step_matches_jax_and_one_process(runs):
    """Each rank's step on its rows: the gradients DDP averaged against the
    JAX package's on the global batch, the logged global loss against JAX's
    and the port's one-process loss; both ranks bit-equal."""
    r0, r1 = (r["step"] for r in runs["ranks"])
    ref = runs["ref"]
    assert [(r["rank"], r["world"]) for r in runs["ranks"]] == [(0, 2), (1, 2)]
    assert runs["ranks"][0]["after_destroy"] == (0, 1)
    assert r0["loss"] != r1["loss"]  # the halves differ ...
    assert r0["logged"] == r1["logged"]  # ... their global mean does not
    got = r0["logged"]["total_loss"]
    np.testing.assert_allclose(got, ref["jax_loss"], rtol=1e-5)
    np.testing.assert_allclose(got, ref["port_loss"], rtol=1e-6)
    np.testing.assert_allclose(got, (r0["loss"] + r1["loss"]) / 2, rtol=1e-6)
    for name in r0["grads"]:
        assert torch.equal(r0["grads"][name], r1["grads"][name]), name
        assert torch.equal(r0["params"][name], r1["params"][name]), name
    assert set(ref["jax_grads"]) == set(r0["grads"])
    for name, g in ref["jax_grads"].items():
        d = float((r0["grads"][name] - g).norm())
        assert d <= 1e-4 * float(g.norm()) + 1e-7, (name, d, float(g.norm()))


def test_ranks_draw_their_rows_of_the_global_draw(runs):
    """``draw_step`` in a group draws the bases and keep masks for the
    global batch and keeps rows rank::world, the rows of the loader's
    shard: what one process draws for the global batch, row for row."""
    one = SWEM(ModelConfig(**TRAIN_DIMS, p_drop=0.2), device="cpu")
    bases, keeps = trainer.draw_step(one, trainer.step_generator(7, 3), GLOBAL_B, T)
    assert parallel.process_count() == 1
    for r, rank in enumerate(runs["ranks"]):
        drawn, got_keeps = rank["step"]["drawn"], rank["step"]["keeps"]
        for a, b in zip(drawn, (bases.kappa, bases.nu, bases.zita)):
            assert a.shape[0] == GLOBAL_B // WORLD and torch.equal(a, b[r::WORLD])
        assert len(got_keeps) == T - 1
        assert all(torch.equal(a, b[r::WORLD]) for a, b in zip(got_keeps, keeps))


# ------------------------------------------------------------------- CLI --
def test_cli_rank0_writes_and_resumes_in_one_process(runs, tmp_path):
    """2 ranks of ``python -m swem_tpu_torch.train --coordinator ...``, each
    with a log directory of its own: rank 0 alone wrote checkpoints and
    tensorboard files, both logged the same global losses, both hold the
    same weights; ``state.pth`` has the model's keys and resumes in one
    process at step 2."""
    cli0 = runs["cli0"]
    cli1 = runs["work"] / "cli1" / "SWEM" / "S2" / "ddp"
    assert {STATE_FILE, VARIABLES_FILE} <= set(os.listdir(cli0 / "checkpoints"))
    assert any("tfevents" in f for f in os.listdir(cli0 / "tb"))
    assert not (cli1 / "checkpoints").exists() and not (cli1 / "tb").exists()

    def logged(exp_dir, rank):
        (path,) = glob.glob(str(exp_dir / f"train_stage_p{rank}_*.log"))
        return re.findall(r"it \d+/\d+ loss \S+ \(main \S+, aux \S+\)", Path(path).read_text())

    lines = logged(cli0, 0)
    assert len(lines) == 2 and lines == logged(cli1, 1)
    r0, r1 = (r["cli_params"] for r in runs["ranks"])
    assert all(r0[k].equal(r1[k]) for k in r0)
    assert [r["cli_step"] for r in runs["ranks"]] == [2, 2]
    snap = torch.load(cli0 / "checkpoints" / STATE_FILE, weights_only=True)
    assert snap["step"] == 2 and not any(k.startswith("module.") for k in snap["model"])
    assert all(snap["model"][k].equal(v) for k, v in r0.items())
    args = train_cli.get_args(runs["train_argv"] + [
        "--log_dir", str(tmp_path), "--total_iters", "2", "3", "--device", "cpu",
        "--resume", str(cli0 / "checkpoints")])
    one = Trainer(train_cli.build_config(args), device="cpu")
    assert one.state.step == 2 and not isinstance(
        one.state.forward, torch.nn.parallel.DistributedDataParallel)
    assert all(one.model.state_dict()[k].equal(v) for k, v in r0.items())
    assert one.train().step == 3


# ------------------------------------------------------------ evaluation --
@pytest.mark.parametrize("tag", ["seq", "vb"])
def test_distributed_eval_matches_one_process(runs, tag):
    """Sequential (videos round-robin) and ``video_batch=2`` (batches
    round-robin): disjoint slices covering the 4 videos, their PNGs in the
    shared tree bit-equal to one process's, J&F from rank 0 alone within
    1e-9 of one process's."""
    ranks = [r[f"eval_{tag}"] for r in runs["ranks"]]
    ref = runs["ref"]
    seen = [set(r["videos"]) for r in ranks]
    assert all(seen) and not seen[0] & seen[1]
    assert seen[0] | seen[1] == set(ref[f"maps_{tag}"]) and len(ref[f"maps_{tag}"]) == 4
    if tag == "seq":
        assert ranks[0]["videos"] == ["vid0", "vid2"] and ranks[1]["videos"] == ["vid1", "vid3"]
    assert ranks[0]["out_root"] == ranks[1]["out_root"]
    got = read_maps(ranks[0]["out_root"])
    assert got.keys() == ref[f"maps_{tag}"].keys()
    assert all(np.array_equal(got[v], ref[f"maps_{tag}"][v]) for v in got)
    assert ranks[1]["metrics"] is None and ranks[0]["metrics"]
    for k, v in ref[f"metrics_{tag}"].items():
        assert abs(ranks[0]["metrics"][k] - v) < 1e-9, k
        assert np.isfinite(ranks[0]["metrics"][k])


def test_distributed_eval_matches_jax(runs):
    """Video 0, which rank 0 evaluated, against the JAX evaluator run op by
    op on the same weights and bases: >= 99.9% of pixels."""
    got = read_maps(runs["ranks"][0]["eval_seq"]["out_root"])["vid0"]
    ref = runs["ref"]["jax_maps"]["vid0"]
    assert got.shape == ref.shape
    same = float((got == ref).mean())
    assert same >= 0.999, f"{same:.6f} of pixels agree"


def test_eval_cli_distributed_scores_on_rank0(runs):
    """``python -m swem_tpu_torch.eval`` with the rendezvous flags on the
    trained ``variables.pth``: rank 0 returns finite J&F, rank 1 None; every
    video has its PNGs."""
    r0, r1 = (r["eval_cli"] for r in runs["ranks"])
    assert r1 is None and np.isfinite(r0["J&F-Mean"])
    out = runs["work"] / "eval_cli" / "SWEM" / "S3" / "swem" / "results" / "DAVIS17" / "output"
    assert sorted(os.listdir(out)) == [f"vid{i}" for i in range(4)]
    assert all(len(os.listdir(out / v)) == 5 for v in os.listdir(out))


def test_obj_parallel_still_raises(tmp_path, monkeypatch):
    """``--obj_parallel 2`` is taken, with or without ``--distributed`` (a
    one-process group here): the CLI raises only what the run itself raises
    (the missing checkpoint), and leaves no process group behind. Under a
    group of several processes each evaluates on its own device alone, so
    its object shards clamp to 1, as a JAX host with one chip does."""
    argv = ["--eval_set", "DAVIS17", "--data_root", str(tmp_path), "--resume",
            str(tmp_path / "none.pth"), "--device", "cpu", "--obj_parallel", "2"]
    rendezvous = ["--distributed", "--coordinator", f"localhost:{free_ports(1)[0]}",
                  "--num_processes", "1", "--process_id", "0"]
    for extra in ([], rendezvous):
        with pytest.raises(FileNotFoundError):
            eval_cli.main(argv + extra)
        assert not torch.distributed.is_initialized()
    monkeypatch.setattr(parallel, "process_count", lambda: 2)
    assert parallel.eval_devices("cpu") == [torch.device("cpu")]
    assert parallel.derive_eval_mesh_extents(len(parallel.eval_devices("cpu")), 2, 2) == (1, 1)
