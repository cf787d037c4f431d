"""One rank of ``test_torch_port_distributed.py``: the port's data parallelism
on the CPU over Gloo, one PyTorch thread per process.

    python tests/_torch_port_mp_worker.py <spec.json> <rank>

``spec.json`` (written by the test process) names the input files: the
weights, the global batch and bases, the evaluation bases and trees; and
three free localhost ports. The rank runs, in order:

1. in a process group joined with the three rendezvous flags
   (``parallel.init_distributed``): one DDP train step on its rows of the
   global batch and bases (``parallel.shard_rows``), the step's own draws
   (``trainer.draw_step``) and the logged global losses
   (``parallel.global_mean``); then ``Evaluator.val`` sequentially and at
   ``video_batch=2``, recording the videos it saved;
2. the training CLI with ``--coordinator``/``--num_processes``/
   ``--process_id`` for 2 steps, into a log directory of its own;
3. the evaluation CLI, the same way, on rank 0's ``variables.pth``.

It saves what it saw to ``rank<r>.pt`` beside the spec. It imports only the
port.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from swem_tpu_torch import parallel
from swem_tpu_torch.config import EvalConfig, ModelConfig, SolverConfig, SWEMConfig
from swem_tpu_torch.eval import __main__ as eval_cli
from swem_tpu_torch.eval.evaluator import Evaluator
from swem_tpu_torch.models import em
from swem_tpu_torch.models.swem import SWEM
from swem_tpu_torch.train import __main__ as train_cli
from swem_tpu_torch.train import trainer


class ThreadProbe:
    """A loader dataset whose samples report the thread settings of the
    worker that built them (``test_loader_workers_run_one_thread``)."""

    def __len__(self) -> int:
        return 4

    def sample(self, rng, idx: int, it: int) -> dict:
        import cv2

        return {"env": np.array([int(os.environ.get(k, 0)) for k in
                                 ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")]),
                "cv2": np.array(cv2.getNumThreads()), "torch": np.array(torch.get_num_threads())}


def model(fields: dict, weights: dict) -> SWEM:
    m = SWEM(ModelConfig(**fields), device="cpu")
    m.load_state_dict(weights)
    return m


def train_step(spec: dict, rank: int, world: int) -> dict:
    """One DDP step on this rank's rows; its gradients, parameters after the
    step, local and global losses, and the step's own draws."""
    inputs = torch.load(spec["step_inputs"], weights_only=True)
    port = model(spec["train_dims"], inputs["weights"])
    cfg = SWEMConfig(model=port.cfg, solver=SolverConfig(**spec["solver"]))
    state = trainer.create_train_state(port, cfg.solver)
    assert isinstance(state.forward, torch.nn.parallel.DistributedDataParallel)
    batch = {k: parallel.shard_rows(v, rank, world) for k, v in inputs["batch"].items()}
    bases = em.Bases(*(parallel.shard_rows(t, rank, world) for t in inputs["bases"]))
    out = trainer.make_train_step(cfg)(state, trainer.batch_to_device(batch, "cpu"),
                                       bases=bases)
    keys = ("total_loss", "main_loss", "aux_loss")
    logged = parallel.global_mean(torch.stack([out[k] for k in keys]))
    # the draws of a step under the group: this rank's rows of the global draw
    dropping = SWEM(ModelConfig(**{**spec["train_dims"], "p_drop": 0.2}), device="cpu")
    drawn, keeps = trainer.draw_step(dropping, trainer.step_generator(7, 3),
                                     spec["global_batch"] // world, 3)
    return {"loss": float(out["total_loss"]), "logged": dict(zip(keys, logged.tolist())),
            "grads": {n: p.grad.clone() for n, p in port.named_parameters()},
            "params": {n: p.detach().clone() for n, p in port.named_parameters()},
            "drawn": [drawn.kappa, drawn.nu, drawn.zita], "keeps": keeps}


def evaluate(spec: dict, tag: str, **eval_kw) -> dict:
    """``Evaluator.val`` on the shared tree with the test's bases; the
    videos this rank saved and its metrics."""
    weights = torch.load(spec["eval_weights"], weights_only=True)
    bases = torch.load(spec["eval_bases"], weights_only=True)
    fields = spec["eval_dims"]
    ev_kw = {**spec["eval"], "davis_in_size": tuple(spec["eval"]["davis_in_size"]), **eval_kw}
    cfg = SWEMConfig(model=ModelConfig(**fields),
                     eval=EvalConfig(data_root=spec["davis"], **ev_kw),
                     log_dir=os.path.join(spec["dir"], tag))
    ev = Evaluator(cfg, weights, device="cpu")
    ev.initial_bases = lambda n: em.Bases(*bases[n])
    saved, save = [], ev._save

    def recording_save(writer, video, preds):
        saved.append(video.name)
        save(writer, video, preds)

    ev._save = recording_save
    return {"videos": saved, "metrics": ev.val(), "out_root": ev.out_root}


def main():
    spec_path, rank = sys.argv[1], int(sys.argv[2])
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    world = 2
    out = {}
    parallel.init_distributed(f"localhost:{spec['ports'][0]}", world, rank, backend="gloo")
    out["rank"], out["world"] = parallel.process_index(), parallel.process_count()
    out["step"] = train_step(spec, rank, world)
    out["eval_seq"] = evaluate(spec, "eval_seq")
    out["eval_vb"] = evaluate(spec, "eval_vb", video_batch=2)
    dist.destroy_process_group()
    out["after_destroy"] = (parallel.process_index(), parallel.process_count())

    mp_flags = ["--num_processes", str(world), "--process_id", str(rank), "--device", "cpu"]
    state = train_cli.main(spec["train_argv"] + [
        "--log_dir", os.path.join(spec["dir"], f"cli{rank}"),
        "--coordinator", f"localhost:{spec['ports'][1]}"] + mp_flags)
    out["cli_step"] = state.step
    out["cli_params"] = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    out["eval_cli"] = eval_cli.main(spec["eval_argv"] + [
        "--coordinator", f"localhost:{spec['ports'][2]}"] + mp_flags)
    torch.save(out, os.path.join(os.path.dirname(spec_path), f"rank{rank}.pt"))
    print(json.dumps({"rank": rank, "videos": out["eval_seq"]["videos"]}))


if __name__ == "__main__":
    main()
