"""Evaluation CLI of the port: ``python -m swem_tpu_torch.eval``.

Takes ``eval.py``'s flags, plus ``--device`` (default: CUDA; ``cpu`` runs
the plain PyTorch path). Examples:

    python -m swem_tpu_torch.eval --eval_set DAVIS17 --data_root /data/DAVIS \\
        --resume ckpts/swem.pth --dtype bfloat16
    python -m swem_tpu_torch.eval --eval_set YTVOS19 \\
        --data_root /data/YTVOS19/valid_all_frames --resume ckpts/swem.pth

``--resume`` is a reference ``.pth``, the port's ``variables.pth`` or a
checkpoint directory holding one (the port trainer's, or one that
``scripts/orbax_to_pth.py`` wrote from the JAX trainer's orbax checkpoint);
an orbax directory itself is read by the JAX package. ``--obj_parallel N``
shards each video's object slots over up to N of the visible cards (one
process; see ``eval/evaluator.py``).

Distributed evaluation: each process evaluates a round-robin slice of the
videos into the shared ``--log_dir`` and process 0 scores them:

    python -m torch.distributed.run --standalone --nproc_per_node 8 \
        -m swem_tpu_torch.eval --distributed --eval_set DAVIS17 ...
    python -m swem_tpu_torch.eval --coordinator host0:12345 --num_processes 2 \
        --process_id 0 ...   # and process 1

``--distributed`` alone takes the group from the environment (``env://``);
the three flags rendezvous at ``tcp://<coordinator>``. The group is Gloo
(it only waits at a barrier); each process computes on ``--device`` when
given, else on ``cuda:<LOCAL_RANK>``, and on that device alone: with
``--distributed``, ``--obj_parallel`` clamps to 1.
"""

from __future__ import annotations

import argparse


def get_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m swem_tpu_torch.eval",
                                description="SWEM evaluation on PyTorch/CUDA")
    p.add_argument("--model", default="SWEM")
    p.add_argument("--backbone", default="resnet50", choices=["resnet50", "resnet18"])
    p.add_argument("--eval_set", default="DAVIS17",
                   choices=["DAVIS16", "DAVIS17", "DAVIS17Test", "YTVOS18", "YTVOS19"])
    p.add_argument("--data_root", required=True, help="dataset root for eval_set")
    p.add_argument("--resume", required=True,
                   help="checkpoint: a reference torch .pth, a variables.pth or a directory "
                   "holding one")
    p.add_argument("--exp_name", default="swem")
    p.add_argument("--log_dir", default="logs")
    p.add_argument("--ssize", type=int, default=480)
    p.add_argument("--key_dim", type=int, default=128)
    p.add_argument("--val_dim", type=int, default=512)
    p.add_argument("--num_bases", type=int, default=128)
    p.add_argument("--em_iters", type=int, default=4)
    p.add_argument("--tau", type=float, default=0.05)
    p.add_argument("--top_l", type=int, default=64)
    p.add_argument("--max_objs", type=int, default=8)
    p.add_argument("--n_kernel", type=int, default=0,
                   help="Gaussian locality reweighting kernels (0 = off)")
    p.add_argument("--sigma", type=float, default=7.0)
    p.add_argument("--stage", type=int, default=3)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--video_batch", type=int, default=1,
                   help="videos per device batch (throughput mode)")
    p.add_argument("--obj_parallel", type=int, default=1,
                   help="object slots over this many devices (clamped to a power of two "
                        "dividing the slot bucket and the device count)")
    p.add_argument("--distributed", action="store_true",
                   help="each process evaluates a disjoint slice of the videos, process 0 "
                        "scores them; the group from the environment (env://) unless "
                        "--coordinator etc. are given")
    p.add_argument("--coordinator", default=None,
                   help="host:port rendezvous (with --num_processes and --process_id)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--scales", type=int, nargs="+", default=[480],
                   help="multi-scale inference (score averaging)")
    p.add_argument("--flip", action="store_true", help="add flipped-input scores")
    p.add_argument("--davis_in_size", type=int, nargs=2, default=(480, 864),
                   metavar=("H", "W"), help="fixed DAVIS inference size")
    p.add_argument("--per_object_csv", action="store_true",
                   help="also write the per-object per-frame J/F series to "
                        "per-object_results-<set>.csv")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA, raising without one; 'cpu' for the "
                        "plain PyTorch path)")
    return p.parse_args(argv)


def build_config(args):
    from swem_tpu_torch.config import EvalConfig, ModelConfig, SolverConfig, SWEMConfig

    model = ModelConfig(
        model_name=args.model, backbone=args.backbone, keydim=args.key_dim,
        valdim=args.val_dim, num_bases=args.num_bases, num_em_iters=args.em_iters,
        em_tau=args.tau, topl=args.top_l, max_objs=args.max_objs, dtype=args.dtype,
        n_kernel=args.n_kernel, kernel_sigma=args.sigma,
    )
    ev = EvalConfig(
        eval_set=args.eval_set, data_root=args.data_root, ssize=args.ssize,
        max_objs=args.max_objs, visualize=args.visualize, chunk=args.chunk,
        davis_in_size=tuple(args.davis_in_size), scales=tuple(args.scales), flip=args.flip,
        video_batch=args.video_batch, obj_parallel=args.obj_parallel,
        per_object_csv=args.per_object_csv,
    )
    return SWEMConfig(model=model, eval=ev, solver=SolverConfig(stage=args.stage),
                      exp_name=args.exp_name, log_dir=args.log_dir)


def main(argv=None):
    args = get_args(argv)
    flags = (args.coordinator, args.num_processes, args.process_id)
    if not args.distributed and flags == (None,) * 3:
        return _evaluate(args, args.device)
    from swem_tpu_torch import parallel

    with parallel.process_group(*flags, backend="gloo", device=args.device) as device:
        return _evaluate(args, device)


def _evaluate(args, device):
    from swem_tpu_torch import registry

    cfg = build_config(args)
    evaluator = registry.get_evaluator(cfg, registry.load_state_dict(cfg, args.resume),
                                       device=device)
    results = evaluator.val()
    evaluator.logger.info("Evaluation done.")
    return results


if __name__ == "__main__":
    main()
