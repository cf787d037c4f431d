"""The port's injectable runner against the benchmark's plain reference with
objects injected mid-video (``vosbench/reference/inject.py``), on seeded
random weights at a tiny width on the CPU, float32 and bf16.

One video in the YouTube-VOS layout: five objects in a bucket of eight
slots, two annotated at frame 0, one injected at frame 5 (the first frame of
the second chunk) and two at frame 7 (inside it), chunks of 4 + 4 + 4 + 1.
The reference follows the runner's served maps (its memory takes them as
hard masks) and its probabilities are compared with the runner's soft
masks frame by frame; the same comparison with the reference's towers in
float8 (the benchmark's control) fails the tolerance.
"""

import numpy as np
import pytest
import torch

from swem_tpu_torch.config import ModelConfig
from swem_tpu_torch.engine import ChunkedVideoRunner
from swem_tpu_torch.eval.evaluator import _preprocess
from swem_tpu_torch.models.swem import SWEM
from vosbench import harness, verdict
from vosbench.reference import inject as ref_inject
from vosbench.reference.model import random_weights
from vosbench.synth import moving_boxes
from _torch_port_util import one_torch_thread  # noqa: F401  (autouse fixture)

TINY = dict(backbone="resnet18", keydim=16, valdim=32, num_bases=8, num_em_iters=2, em_tau=0.05,
            topl=4, max_objs=2, mdim=32,
            # the benchmark's scales: soft EM assignments at tau 0.05, so that
            # a rounding difference does not flip a pixel's label
            init_scales={"key_proj.key_proj.weight": 0.003, "decoder.pred.weight": 0.01})
RAW, IN = (64, 96), (48, 64)
T, CHUNK, BUCKET = 14, 4, 8
CHUNKS = [4, 4, 4, 1]
FIRSTS = {1: 0, 2: 0, 3: 5, 4: 7, 5: 7}  # pool box -> first annotated frame; slot = box - 1
# On one thread the two agree to the bit at both dtypes: the reference casts
# where the port casts, so its bf16 towers round alike. The tolerance is
# room for the decode's float32 sums run in another order (about 2e-5 on
# these probabilities, vosbench/tests/test_vosbench_reference.py); float8
# towers miss by over 0.1.
TOL = {"float32": 1e-4, "bfloat16": 1e-4}


class Kept:
    """Keeps every judged prediction."""

    def __init__(self):
        self.preds = []

    def add(self, pred, served):
        self.preds.append(pred[0])


def video(seed=11):
    """(frames (T,H,W,3) uint8, init_mask (1,H,W,9), active (1,8), injections)."""
    frames, labels = moving_boxes(seed, T, RAW, 5)
    init = np.where(np.isin(labels[0], [1, 2]), labels[0], 0)
    init_mask = (init[None, ..., None] == np.arange(BUCKET + 1)).astype(np.float32)
    active = np.zeros((1, BUCKET), bool)
    active[0, :2] = True
    injections = {}
    for box, t in FIRSTS.items():
        if t:
            idx, new = injections.setdefault(t, (np.zeros((1,) + RAW, np.uint8),
                                                 np.zeros((1, BUCKET), bool)))
            idx[0][labels[t] == box] = box
            new[0, box - 1] = True
    return frames, init_mask, active, injections


def run(cfg, w, vid, bases):
    """The runner's soft masks (T-1,H,W,9) of video ``vid``."""
    model = SWEM(ModelConfig(**{k: cfg[k] for k in harness.MODEL_KEYS}), device="cpu")
    model.load_state_dict(w)
    runner = ChunkedVideoRunner(model, RAW, chunk=CHUNK, scores=True, preprocess=_preprocess(IN),
                                injectable=True)
    return runner(None, vid[0][:, None], *vid[1:], bases=harness.program_bases(bases))[:, 0]


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def served(request):
    """(cfg, weights, video, bases, the runner's soft masks (T-1,H,W,9))."""
    cfg = dict(TINY, dtype=request.param)
    w = random_weights(cfg, 2 ** 31 + 7, "cpu")
    vid = video()
    bases = harness.draw_bases(5, 1, 1, dict(cfg, max_objs=BUCKET), "cpu")[0]
    return cfg, w, vid, bases, run(cfg, w, vid, bases)


def reference(served, arithmetic="float32"):
    """The reference's probabilities of every frame, following the served
    maps, with its towers in ``arithmetic``."""
    cfg, w, (frames, init_mask, active, injections), bases, scores = served
    net, scope = verdict.network(cfg, w, arithmetic)
    kept = Kept()
    with scope():
        ref_inject.replay(net, RAW, torch.from_numpy(frames)[:, None], IN,
                          torch.from_numpy(init_mask),
                          torch.from_numpy(active), bases, injections,
                          served=scores.argmax(-1).to(torch.uint8).numpy(), chunks=CHUNKS,
                          every=kept)
    return torch.stack(kept.preds)


def test_the_chunks_place_the_injections():
    from vosbench.drivers.ytvos import position

    assert ChunkedVideoRunner(None, RAW, chunk=CHUNK)._sizes(T - 1) == CHUNKS
    assert [position(T, t, CHUNK) for t in (5, 7)] == ["first", "inside"]


def test_runner_matches_the_reference_through_injections(served):
    cfg, scores = served[0], served[-1]
    ref = reference(served)
    gap = (ref - scores).abs().amax(dim=(1, 2, 3))
    assert gap.max() <= TOL[cfg["dtype"]], gap
    # every slot holds an object by the end, and each injected object holds
    # its ground truth exactly at its frame
    labels = scores.argmax(-1)
    _, _, _, injections = served[2]
    for t, (idx, new) in injections.items():
        hot = torch.from_numpy(idx[0]) > 0
        assert torch.equal(labels[t - 1][hot], torch.from_numpy(idx[0]).long()[hot])
    assert set(labels[-1].unique().tolist()) >= {1, 2, 3, 4, 5}


def test_float8_towers_fail_the_tolerance(served):
    cfg, scores = served[0], served[-1]
    low = reference(served, "fp8")
    assert (low - scores).abs().max() > 10 * TOL[cfg["dtype"]]


def test_injection_follows_the_ports_semantics():
    from swem_tpu_torch import engine

    g = torch.Generator().manual_seed(3)
    pred = torch.softmax(torch.randn((2, 6, 7, 5), generator=g), -1)
    active = torch.tensor([[True, False, False, False], [True, True, False, False]])
    idx = torch.zeros((2, 6, 7), dtype=torch.uint8)
    idx[0, 1:3, 2:5] = 2
    idx[0, 4:6, 0:2] = 4
    idx[1, 0:2, 0:2] = 3
    idx[1, 3:5, 3:6] = 1  # an old slot's pixels in the map: not injected
    new = torch.tensor([[False, True, False, True], [False, False, True, False]])
    truth = ref_inject.injected_truth(idx, new)
    mask, flags = engine._injection(idx.numpy(), new.numpy(), 4, torch.device("cpu"))
    assert torch.equal(truth, mask) and torch.equal(flags, new)
    want = engine._inject(pred, active, mask, new)
    got = ref_inject.inject(pred.clone(), active, truth, new)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_a_new_slot_left_out_of_the_memorize_departs_on_the_next_frame(served, monkeypatch):
    """The new slots left out of the memorize at their injection frame
    (they join ``active`` from the next frame on): every frame up to the
    first injection, that one included, still meets the tolerance; the
    frame after it misses it by far."""
    from swem_tpu_torch import engine

    cfg, w, vid, bases, _ = served
    inject = engine._inject
    monkeypatch.setattr(engine, "_inject", lambda pred, active, mask, new:
                        (inject(pred, active, mask, new)[0], active))
    scores = run(cfg, w, vid, bases)
    gap = (reference((cfg, w, vid, bases, scores)) - scores).abs().amax(dim=(1, 2, 3))
    t = min(vid[3])
    # gap[t - 1] is frame t's
    assert gap[:t].max() <= TOL[cfg["dtype"]], gap
    assert gap[t] > 100 * TOL[cfg["dtype"]], gap
