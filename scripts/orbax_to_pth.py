"""Carry a checkpoint of the JAX trainer to the PyTorch port.

The JAX trainer (``train.py``) writes ``<ckpt_dir>/variables`` (the weights)
and ``<ckpt_dir>/state`` (the whole run: weights, optax state, step) with
orbax. This script reads them with the JAX package and writes the port's
files into ``--dst``:
- ``variables.pth``: the weights, read through
  ``swem_tpu.registry.load_variables`` (so a single-object checkpoint is
  widened for a multi-object model, as the JAX evaluator widens it);
- ``state.pth``, when ``<src>/state`` exists (and unless ``--weights_only``):
  the weights with the optimizer's moments, the LR schedule and the step
  (``swem_tpu_torch.io.jax_import.train_snapshot``).

It is the one tool that imports both packages, so it runs where the TPU
run's JAX (with flax, optax and orbax) is installed, next to PyTorch:

    python scripts/orbax_to_pth.py --src logs/SWEM/S3/swem/checkpoints \\
        --dst ckpt_torch --stage 3

Pass the model and solver flags of the ``train.py`` run that wrote the
checkpoint (the abstract state is built from them). Then, on the card:

    python -m swem_tpu_torch.eval --resume ckpt_torch ...     # the weights
    python -m swem_tpu_torch.train --resume ckpt_torch --stage 3 ...
                                          # the run, from the same step,
                                          # moments and LR
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def get_args(argv=None):
    p = argparse.ArgumentParser(description="orbax checkpoint of swem_tpu -> the port's .pth")
    p.add_argument("--src", required=True, help="the JAX trainer's checkpoint directory")
    p.add_argument("--dst", required=True, help="directory for variables.pth and state.pth")
    p.add_argument("--weights_only", action="store_true",
                   help="write variables.pth only (e.g. for a stage transfer)")
    # train.py's model and solver flags
    p.add_argument("--model", default="SWEM")
    p.add_argument("--backbone", default="resnet50", choices=["resnet50", "resnet18"])
    p.add_argument("--stage", type=int, default=0, choices=[0, 1, 2, 3])
    p.add_argument("--num_obj", type=int, default=2)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--key_dim", type=int, default=128)
    p.add_argument("--val_dim", type=int, default=512)
    p.add_argument("--num_bases", type=int, default=128)
    p.add_argument("--em_iters", type=int, default=4)
    p.add_argument("--tau", type=float, default=0.05)
    p.add_argument("--top_l", type=int, default=64)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--total_iters", type=int, nargs=2, default=None,
                   help="override (milestone, max_iter) for the stage")
    return p.parse_args(argv)


def build_configs(args) -> tuple:
    """(the JAX package's SWEMConfig, the port's) of the flags, as
    ``train.py`` and ``python -m swem_tpu_torch.train`` build them."""
    from swem_tpu import config as jc
    from swem_tpu_torch import config as pc

    out = []
    for c in (jc, pc):
        model = c.ModelConfig(model_name=args.model, backbone=args.backbone, keydim=args.key_dim,
                              valdim=args.val_dim, num_bases=args.num_bases,
                              num_em_iters=args.em_iters, em_tau=args.tau, topl=args.top_l,
                              max_objs=args.num_obj, dtype=args.dtype)
        solver = c.SolverConfig(stage=args.stage, base_lr=args.lr,
                                weight_decay=args.weight_decay)
        if args.total_iters is not None:
            over = tuple(args.total_iters)
            solver = dataclasses.replace(solver, pretrain_iters=over, maintrain_iters=over,
                                         davis_iters=over)
        cfg = c.SWEMConfig(model=model, solver=solver,
                           data=c.DataConfig(max_num_objs=args.num_obj))
        out.append(c.single_object_config(cfg))
    return tuple(out)


def optax_moments(opt_state) -> tuple:
    """(count, {"mu": tree, "nu": tree} or {"trace": tree}) of a
    ``swem_tpu.train.solver.make_optimizer`` state, whose nesting depends
    on the optimizer (AdamW ``(adam, wd, schedule)``, Adam and SGD
    ``(wd, (adam or trace, schedule))``). Every count in it must agree."""
    import optax

    moments, counts = {}, []

    def walk(node):
        if isinstance(node, optax.ScaleByAdamState):
            moments.update(mu=node.mu, nu=node.nu)
            counts.append(int(node.count))
        elif isinstance(node, optax.TraceState):
            moments["trace"] = node.trace
        elif isinstance(node, optax.ScaleByScheduleState):
            counts.append(int(node.count))
        elif isinstance(node, (tuple, list)):
            for child in node:
                walk(child)

    walk(opt_state)
    if not moments or not counts or len(set(counts)) != 1:
        raise ValueError(f"not an optimizer state of swem_tpu.train.solver: moments "
                         f"{sorted(moments)}, counts {counts}")
    return counts[0], moments


def convert(src: str, dst: str, jax_cfg, port_cfg, weights_only: bool = False) -> dict:
    """Write ``<dst>/variables.pth`` and, from ``<src>/state``, ``<dst>/state.pth``;
    returns the paths written and the state's step."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from swem_tpu.io.checkpoint import restore_checkpoint
    from swem_tpu.models.swem import SWEM as JaxSWEM
    from swem_tpu.registry import load_variables
    from swem_tpu.train.solver import make_optimizer
    from swem_tpu.train.trainer import create_train_state
    from swem_tpu_torch.io.checkpoint import STATE_FILE, VARIABLES_FILE, save_train_checkpoint
    from swem_tpu_torch.io.jax_import import (
        jax_to_state_dict,
        moments_state_dict,
        train_snapshot,
    )
    from swem_tpu_torch.models.swem import SWEM

    with torch.device("meta"):  # names and shapes only: no weights are allocated
        model = SWEM(port_cfg.model, device="meta")
    weights = jax_to_state_dict(jax.device_get(load_variables(jax_cfg, src)))
    model.load_state_dict(weights, assign=True)  # raises unless every key and shape is the model's
    os.makedirs(dst, exist_ok=True)
    written = {"variables": os.path.join(dst, VARIABLES_FILE)}
    state_dir = os.path.join(src, "state")
    if weights_only or not os.path.isdir(state_dir):
        torch.save(weights, written["variables"])
        return written

    # the abstract TrainState of the run: the trainer's model (n_kernel 0)
    # and optimizer; the sample's spatial size does not shape any variable
    m = jax_cfg.model
    jmodel = JaxSWEM(dataclasses.replace(m, n_kernel=0))
    tx, _ = make_optimizer(jax_cfg.solver)
    frame = jnp.zeros((1, 64, 64, 3), jnp.float32)
    mask = jnp.zeros((1, 64, 64, m.max_objs + 1), jnp.float32)
    abstract = jax.eval_shape(
        lambda: create_train_state(jmodel, jax.random.PRNGKey(0), tx, frame, mask))
    try:
        state = jax.device_get(restore_checkpoint(state_dir, abstract))
    except Exception as e:  # orbax names the leaf; say which flags decide the shapes
        raise ValueError(f"{state_dir} does not restore into the state of these flags: pass the "
                         "model and solver flags of the run that wrote it, or --weights_only "
                         "for its weights alone") from e
    count, moments = optax_moments(state.opt_state)
    if count != int(state.step):
        raise ValueError(f"{state_dir}: the optimizer's count {count} is not the step "
                         f"{int(state.step)}")
    snap = train_snapshot(
        model, port_cfg.solver,
        jax_to_state_dict({"params": state.params, "batch_stats": state.batch_stats}), count,
        {kind: moments_state_dict(tree) for kind, tree in moments.items()})
    for k, v in weights.items():
        if not np.array_equal(v.numpy(), snap["model"][k].numpy()):
            raise ValueError(f"{src}: 'state' and 'variables' hold different weights ({k})")
    save_train_checkpoint(dst, snap)  # state.pth, and variables.pth from the same weights
    written.update(state=os.path.join(dst, STATE_FILE), step=count)
    return written


def main(argv=None) -> dict:
    args = get_args(argv)
    jax_cfg, port_cfg = build_configs(args)
    written = convert(args.src, args.dst, jax_cfg, port_cfg, weights_only=args.weights_only)
    print(f"wrote {written['variables']}"
          + (f" and {written['state']} (step {written['step']})" if "state" in written else ""))
    return written


if __name__ == "__main__":
    main()
