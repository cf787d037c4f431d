"""The port's ``torch.export`` artifacts (``swem_tpu_torch.io.export``), on the CPU.

Mirrors ``tests/test_export.py``: an artifact's replay must reproduce the
live ``ChunkedVideoRunner`` and ``StreamingSession`` bit for bit on the same
device (the same ATen ops run in the same order; only the dispatch differs),
plainly and with mid-video injection. Beside that: the programs hold no
weights, the replay agrees with the JAX package's runner run op by op (its
jitted programs drift from that at tau = 0.05, so they are not the oracle),
and a fresh interpreter replays an artifact without the port's model code
or JAX.

The tiny model is ``tiny_pair``'s (three slots); frames are uint8 at 32x32,
upsampled exactly 2x to 64x64 by the artifact's bicubic preprocess, where
both packages' taps agree to the bit. Artifacts are exported once per
module.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from swem_tpu import engine as jeng
from swem_tpu.ops.resize import resize as jax_resize
from swem_tpu_torch import engine
from swem_tpu_torch.io.export import ExportedRunner, ExportedSession, export_runner
from swem_tpu_torch.models import em
from swem_tpu_torch.ops import em_kernel, read_kernel
from swem_tpu_torch.ops.resize import resize
from swem_tpu_torch.serve import StreamingSession
from _torch_port_util import jax_bases, tiny_pair
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse fixture)
from test_model import make_video

ROOT = Path(__file__).resolve().parents[1]
RAW, IN, OUT = (32, 32), (64, 64), (64, 64)
N_SLOTS, CHUNK = 3, 2
KEY = jax.random.PRNGKey(31)  # the injectable artifact's bases: the JAX package's draw


def port_pre(f):
    return resize(f.float() / 255.0, IN, "bicubic")


def jax_pre(f):
    return jax_resize(f.astype(jnp.float32) / 255.0, IN, "bicubic")


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=1, max_objs=N_SLOTS)


@pytest.fixture(scope="module")
def plain_art(pair, tmp_path_factory):
    """An index artifact (chunk 2, seed 0's bases), exported once."""
    path = str(tmp_path_factory.mktemp("export") / "plain")
    export_runner(pair[2], path, frame_hw=RAW, out_size=OUT, chunk=CHUNK, preprocess=port_pre)
    return path


@pytest.fixture(scope="module")
def inj_art(pair, tmp_path_factory):
    """An injectable artifact on the JAX package's draw of bases, exported once."""
    path = str(tmp_path_factory.mktemp("export") / "injectable")
    export_runner(pair[2], path, frame_hw=RAW, out_size=OUT, chunk=CHUNK, preprocess=port_pre,
                  injectable=True, bases=jax_bases(pair[0].cfg, KEY))
    return path


def artifact_bases(path) -> em.Bases:
    return em.Bases(*torch.load(os.path.join(path, "bases.pt")))


def video(seed, T):
    """uint8 frames (T,1,32,32,3), a one-hot init mask (1,64,64,4) and active (1,3)."""
    rng = np.random.default_rng(seed)
    frames = (rng.random((T, 1) + RAW + (3,)) * 255).astype(np.uint8)
    _, init_mask, active = make_video(rng, T=1, n_objs=N_SLOTS, n_slots=N_SLOTS)
    return frames, np.asarray(init_mask), np.asarray(active)


def late_third_object(init_mask):
    """(init mask without object 3, its (1,Ho,Wo) uint8 index map, active [T,T,F])."""
    first = init_mask.copy()
    first[..., 0] += first[..., 3]
    first[..., 3] = 0.0
    return first, (init_mask[..., 3] > 0).astype(np.uint8) * 3, np.asarray([[True, True, False]])


def live_runner(port, **kw):
    return engine.ChunkedVideoRunner(port, OUT, chunk=CHUNK, preprocess=port_pre, **kw)


def live_session(pair):
    return StreamingSession(pair[2].cfg, pair[2].state_dict(), raw_hw=RAW, in_size=IN,
                            out_size=OUT, n_slots=N_SLOTS, seed=0, device="cpu")


def test_export_matches_live_runner(pair, plain_art):
    """Replay == live ChunkedVideoRunner, the ladder's tail included (T - 1 =
    9 = 2 + 2 + 2 + 2 + 1), and the replay launches nothing on the CPU."""
    frames, init_mask, active = video(0, 10)
    exported = ExportedRunner(plain_art, device="cpu")
    exported.warmup()
    got = exported(frames, init_mask, active)
    want = live_runner(pair[2])(None, frames, init_mask, active, bases=artifact_bases(plain_art))
    assert got.shape == (9, 1) + OUT and got.dtype == np.uint8
    assert len(np.unique(got)) > 2  # the comparison has content
    np.testing.assert_array_equal(got, want)
    assert (em_kernel.launches, read_kernel.launches) == (0, 0)


def test_export_manifest_and_files(plain_art):
    with open(os.path.join(plain_art, "manifest.json")) as f:
        m = json.load(f)
    assert m["sizes"] == [CHUNK] + engine.ladder_sizes(CHUNK)
    assert m["frame_dtype"] == "uint8" and m["device"] == "cpu"
    assert m["torch_version"] == torch.__version__
    assert m["frame_hw"] == list(RAW) and m["out_size"] == list(OUT)
    assert m["model_config"]["backbone"] == "resnet18" and m["n_slots"] == N_SLOTS
    for name in ["init", "memorize"] + [f"chunk_{s}" for s in m["sizes"]]:
        assert os.path.exists(os.path.join(plain_art, "programs", f"{name}.pt2")), name
    for name in ("weights.pt", "bases.pt"):
        assert os.path.exists(os.path.join(plain_art, name))


def test_exported_session_matches_runner_and_live_session(pair, plain_art):
    """Streaming replay (the chunk_1 program) == the offline replay, and ==
    the live StreamingSession frame by frame."""
    T = 5
    frames, init_mask, active = video(1, T)
    offline = ExportedRunner(plain_art, device="cpu")(frames, init_mask, active)
    labels = np.argmax(init_mask[0], axis=-1).astype(np.uint8)
    sess = ExportedSession(plain_art, device="cpu")
    sess.warmup()
    sess.start(frames[0, 0], labels)
    stream = [sess.push(f[0]) for f in frames[1:]]
    assert sess.frames_seen == T
    # the offline runner skips the FINAL frame's memorize, which only affects
    # the memory after the video: the per-frame predictions are the same
    np.testing.assert_array_equal(np.stack(stream), offline[:, 0])
    live = live_session(pair)
    live.start(frames[0, 0], labels)
    np.testing.assert_array_equal(np.stack(stream), np.stack([live.push(f[0]) for f in frames[1:]]))


@pytest.fixture(scope="module")
def cli_art(pair, tmp_path_factory):
    """The port's variables.pth -> python -m swem_tpu_torch.export --device
    cpu --chunk 1 (default /255 preprocess, seed 0's bases) -> (artifact,
    the CLI's stdout)."""
    port, tmp = pair[2], tmp_path_factory.mktemp("cli")
    ck = tmp / "variables.pth"
    torch.save(port.state_dict(), ck)
    art = str(tmp / "art")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    cfg = port.cfg
    out = subprocess.run(
        [sys.executable, "-m", "swem_tpu_torch.export", "--device", "cpu", "--resume", str(ck),
         "--out", art, "--backbone", cfg.backbone, "--key_dim", str(cfg.keydim),
         "--val_dim", str(cfg.valdim), "--num_bases", str(cfg.num_bases),
         "--em_iters", str(cfg.num_em_iters), "--top_l", str(cfg.topl),
         "--max_objs", str(N_SLOTS), "--mdim", str(cfg.mdim), "--in_size", "64", "64",
         "--out_size", "64", "64", "--chunk", "1"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return art, out.stdout


def test_export_cli_end_to_end(pair, cli_art):
    """The CLI's artifact replays equal to the live runner with the same
    preprocess and bases."""
    art, stdout = cli_art
    assert stdout.strip() == f"wrote artifact to {art}"
    cfg = pair[2].cfg
    rng = np.random.default_rng(2)
    frames = (rng.random((6, 1, 64, 64, 3)) * 255).astype(np.uint8)
    _, init_mask, active = make_video(rng, T=1, n_objs=2, n_slots=N_SLOTS)
    preds = ExportedRunner(art, device="cpu")(frames, init_mask, active)
    assert preds.shape == (5, 1, 64, 64) and preds.dtype == np.uint8
    bases = em.init_bases(torch.Generator().manual_seed(0), 1, N_SLOTS, cfg.keydim, cfg.valdim,
                          cfg.num_bases)
    want = engine.ChunkedVideoRunner(pair[2], (64, 64), chunk=1,
                                     preprocess=lambda f: f.float() / 255)(
        None, frames, np.asarray(init_mask), np.asarray(active), bases=bases)
    np.testing.assert_array_equal(preds, want)


def test_injectable_export_matches_live_runner(pair, inj_art):
    """Injectable replay == live injectable runner, slot activations threaded
    across the chunk boundaries: object 3 appears at frame 3, in the second
    chunk of frames 1..7 = 2 + 2 + 2 + 1."""
    frames, init_mask, _ = video(3, 8)
    first, idx_map, active = late_third_object(init_mask)
    injections = {3: (idx_map, np.asarray([[False, False, True]]))}
    exported = ExportedRunner(inj_art, device="cpu")
    exported.warmup()
    got = exported(frames, first, active, injections=injections)
    want = live_runner(pair[2], injectable=True)(None, frames, first, active, injections,
                                                 bases=artifact_bases(inj_art))
    np.testing.assert_array_equal(got, want)
    box = idx_map[0] > 0
    assert (got[2, 0][box] == 3).all() and not (got[:2] == 3).any()
    assert (got[3:] == 3).sum() > 0  # the injected object persists


def test_exported_session_injection_matches_live(pair, inj_art):
    """ExportedSession.add_objects == serve.StreamingSession.add_objects."""
    frames, init_mask, _ = video(4, 6)
    first, idx_map, _ = late_third_object(init_mask)
    labels0 = np.argmax(first[0], axis=-1).astype(np.uint8)
    live = live_session(pair)
    live.start(frames[0, 0], labels0, bases=artifact_bases(inj_art))
    want = [live.push(frames[1, 0]), live.push(frames[2, 0]),
            live.add_objects(frames[3, 0], idx_map[0], [3]),
            live.push(frames[4, 0]), live.push(frames[5, 0])]
    sess = ExportedSession(inj_art, device="cpu")
    sess.warmup()
    sess.start(frames[0, 0], labels0)
    got = [sess.push(frames[1, 0]), sess.push(frames[2, 0]),
           sess.add_objects(frames[3, 0], idx_map[0], [3]),
           sess.push(frames[4, 0]), sess.push(frames[5, 0])]
    assert sess.frames_seen == 6
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    assert (got[2][idx_map[0] > 0] == 3).all()


def test_exported_session_out_of_budget_labels_drop_to_background(inj_art):
    """start()'s one-hot clips out-of-budget ids to BACKGROUND (the
    to_onehot contract), not to all-zero pixel vectors."""
    frames, _, _ = video(5, 3)
    labels = np.zeros(OUT, np.uint8)
    labels[10:30, 20:50] = 1
    labels[40:60, 30:60] = N_SLOTS + 2  # beyond the slot budget
    sess = ExportedSession(inj_art, device="cpu")
    sess.start(frames[0, 0], labels)
    got = [sess.push(f[0]) for f in frames[1:]]
    ref = ExportedSession(inj_art, device="cpu")
    ref.start(frames[0, 0], np.where(labels <= N_SLOTS, labels, 0).astype(np.uint8))
    np.testing.assert_array_equal(np.stack(got), np.stack([ref.push(f[0]) for f in frames[1:]]))


def test_exported_session_add_objects_needs_injectable(plain_art):
    frames, init_mask, active = video(6, 2)
    with pytest.raises(ValueError, match="injectable"):
        ExportedRunner(plain_art, device="cpu")(frames, init_mask, active,
                                                injections={1: (None, None)})
    sess = ExportedSession(plain_art, device="cpu")
    sess.start(frames[0, 0], np.argmax(init_mask[0], -1).astype(np.uint8))
    with pytest.raises(ValueError, match="injectable"):
        sess.add_objects(frames[1, 0], np.zeros(OUT, np.uint8), [1])


def test_export_chunk1_dedupes_sizes(cli_art):
    """chunk=1's ladder is [1] again: one program, one manifest entry."""
    art, _ = cli_art
    with open(os.path.join(art, "manifest.json")) as f:
        assert json.load(f)["sizes"] == [1]
    assert sorted(os.listdir(os.path.join(art, "programs"))) == [
        "chunk_1.pt2", "init.pt2", "memorize.pt2"]
    rng = np.random.default_rng(3)
    frames = (rng.random((4, 1, 64, 64, 3)) * 255).astype(np.uint8)
    _, init_mask, active = make_video(rng, T=1, n_objs=2, n_slots=N_SLOTS)
    assert ExportedRunner(art, device="cpu")(frames, init_mask, active).shape == (3, 1, 64, 64)


def test_export_input_validation(plain_art):
    exported = ExportedRunner(plain_art, device="cpu")
    frames, init_mask, active = video(8, 5)
    with pytest.raises(TypeError):
        exported(frames.astype(np.float32), init_mask, active)
    with pytest.raises(ValueError):
        exported(frames[:, :, :16], init_mask, active)
    # T == 1: nothing to predict
    assert exported(frames[:1], init_mask, active).shape == (0, 1) + OUT
    # an artifact replays on the device type it was exported on
    with pytest.raises(ValueError, match="exported on cpu"):
        ExportedRunner(plain_art, device="meta")


def test_programs_hold_no_weights_and_call_the_ops(plain_art, inj_art):
    """Each program file is under a tenth of weights.pt (the weights are
    inputs, stored once), and both kernels' custom ops are nodes of the
    graphs: K2 once per frame of a chunk, K1 once per memorize."""
    for path in (plain_art, inj_art):
        weights = os.path.getsize(os.path.join(path, "weights.pt"))
        for name in os.listdir(os.path.join(path, "programs")):
            size = os.path.getsize(os.path.join(path, "programs", name))
            assert size < weights / 10, (name, size, weights)
    ops = {"init": (1, 0), "chunk_2": (1, 2), "chunk_1": (0, 1), "memorize": (1, 0)}
    runner = ExportedRunner(plain_art, device="cpu")
    for name, (n_em, n_read) in ops.items():
        graph = runner._load(name).graph
        targets = [n.target for n in graph.nodes if n.op == "call_function"]
        assert targets.count(torch.ops.swem_tpu_torch.em_loop.default) == n_em, name
        assert targets.count(torch.ops.swem_tpu_torch.read_normalized.default) == n_read, name


def test_replay_agrees_with_jax_eager_runner(pair, inj_art):
    """The injectable replay against the JAX package's injectable
    ChunkedVideoRunner run op by op, same weights and bases: >= 99.9% of
    pixels (an argmax near-tie may flip a pixel), the injected box exactly."""
    model, variables, _ = pair
    frames, init_mask, _ = video(9, 6)
    first, idx_map, active = late_third_object(init_mask)
    injections = {3: (idx_map, np.asarray([[False, False, True]]))}
    with jax.disable_jit():
        ref = jeng.ChunkedVideoRunner(model, OUT, chunk=CHUNK, preprocess=jax_pre,
                                      injectable=True)(variables, KEY, frames, first, active,
                                                       injections=injections)
    got = ExportedRunner(inj_art, device="cpu")(frames, first, active, injections=injections)
    ref = np.asarray(ref)
    assert len(np.unique(ref)) > 2
    assert float((got == ref).mean()) >= 0.999
    box = idx_map[0] > 0
    assert (got[2, 0][box] == 3).all() and (ref[2, 0][box] == 3).all()


def test_fresh_interpreter_replays_without_models_or_jax(inj_art, tmp_path):
    """A new Python process loads and replays the artifact with neither the
    port's model code nor JAX imported, and gets the bits of this one."""
    frames, init_mask, active = video(10, 6)
    np.savez(tmp_path / "video.npz", frames=frames, init_mask=init_mask, active=active)
    code = (
        "import sys, numpy as np\n"
        "from swem_tpu_torch.io.export import ExportedRunner\n"
        f"v = np.load({str(tmp_path / 'video.npz')!r})\n"
        f"preds = ExportedRunner({inj_art!r}, device='cpu')(v['frames'], v['init_mask'], "
        "v['active'])\n"
        f"np.save({str(tmp_path / 'preds.npy')!r}, preds)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'swem_tpu')"
        " or m in ('swem_tpu_torch.models', 'swem_tpu_torch.engine', 'swem_tpu_torch.serve')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr[-3000:]
    want = ExportedRunner(inj_art, device="cpu")(frames, init_mask, active)
    np.testing.assert_array_equal(np.load(tmp_path / "preds.npy"), want)
