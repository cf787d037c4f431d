"""Training CLI of the port: ``python -m swem_tpu_torch.train``.

Takes ``train.py``'s flags, plus ``--device`` (default: CUDA, raising
without one; ``cpu`` runs the plain PyTorch path). Stages: 0 static
pretrain, 1 DAVIS, 2 YouTube-VOS, 3 DAVIS + YouTube-VOS. Examples:

    python -m swem_tpu_torch.train --stage 0 --data_root /data --exp s0
    python -m swem_tpu_torch.train --stage 3 --data_root /data --dtype bfloat16 \\
        --resume logs/SWEM/S0/s0/checkpoints --from_scratch --exp s3

``--resume`` takes a checkpoint directory written by this trainer (its
``state.pth``, or with ``--from_scratch`` its ``variables.pth``) or a
reference ``.pth``; an orbax directory is read by the JAX package, and
``scripts/orbax_to_pth.py`` converts it into such a directory (the
optimizer's moments, LR schedule and step included).
``--from_scratch`` is needed for a stage transfer: without it the run
resumes the earlier stage's step.

Data parallelism, one process per device (``--batch_size`` is the global
batch, split evenly over the processes):

    python -m torch.distributed.run --standalone --nproc_per_node 8 \
        -m swem_tpu_torch.train --distributed --stage 3 --data_root /data ...
    python -m swem_tpu_torch.train --coordinator host0:12345 --num_processes 2 \
        --process_id 0 --stage 3 --data_root /data ...   # and process 1

``--distributed`` alone joins the group that the environment describes
(``env://``, as ``torch.distributed.run`` sets it); the three flags
rendezvous at ``tcp://<coordinator>``. Each process computes on
``--device`` when given, else on ``cuda:<LOCAL_RANK>``. ``--dist_backend``
defaults to NCCL on CUDA and Gloo on the CPU; NCCL refuses two processes
on one card, so such a run needs ``--dist_backend gloo``.
"""

from __future__ import annotations

import argparse


def get_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m swem_tpu_torch.train",
                                description="SWEM training on PyTorch/CUDA")
    p.add_argument("--model", default="SWEM")
    p.add_argument("--backbone", default="resnet50", choices=["resnet50", "resnet18"])
    p.add_argument("--stage", type=int, default=0, choices=[0, 1, 2, 3])
    p.add_argument("--data_root", required=True)
    p.add_argument("--exp", default="swem", help="experiment name")
    p.add_argument("--log_dir", default="logs")
    p.add_argument("--batch_size", type=int, default=8, help="batch size")
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
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--resume", default=None,
                   help="checkpoint directory of this trainer, or a reference .pth")
    p.add_argument("--from_scratch", action="store_true",
                   help="load weights only, reset optimizer/iteration")
    p.add_argument("--total_iters", type=int, nargs=2, default=None,
                   help="override (milestone, max_iter) for the stage")
    p.add_argument("--backbone_init", default=None,
                   help="torchvision resnet .pth files 'key.pth,value.pth' for "
                        "ImageNet backbone init")
    p.add_argument("--distributed", action="store_true",
                   help="data parallel over processes; the group from the environment "
                        "(env://) unless --coordinator etc. are given")
    p.add_argument("--coordinator", default=None,
                   help="host:port rendezvous (with --num_processes and --process_id)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                   help="process group backend (default: NCCL on CUDA, Gloo on the CPU)")
    p.add_argument("--remat", default=None, nargs="?", const="encoder",
                   choices=["encoder", "block"],
                   help="recompute activations in the backward pass (torch.utils.checkpoint): "
                        "'encoder' = the key encode, 'block' = each supervised frame")
    p.add_argument("--crop_size", type=int, default=384)
    p.add_argument("--log_period", type=int, default=100)
    p.add_argument("--save_period", type=int, default=5000)
    p.add_argument("--vis_period", type=int, default=1000)
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA, raising without one; 'cpu' for the "
                        "plain PyTorch path)")
    return p.parse_args(argv)


def build_config(args):
    import dataclasses

    from swem_tpu_torch.config import (
        DataConfig,
        LossConfig,
        ModelConfig,
        SolverConfig,
        SWEMConfig,
        single_object_config,
    )

    model = ModelConfig(
        model_name=args.model, backbone=args.backbone, keydim=args.key_dim,
        valdim=args.val_dim, num_bases=args.num_bases, num_em_iters=args.em_iters,
        em_tau=args.tau, topl=args.top_l, max_objs=args.num_obj, dtype=args.dtype,
    )
    solver = SolverConfig(stage=args.stage, base_lr=args.lr, weight_decay=args.weight_decay,
                          remat=args.remat)
    if args.total_iters is not None:
        over = tuple(args.total_iters)
        solver = dataclasses.replace(solver, pretrain_iters=over, maintrain_iters=over,
                                     davis_iters=over)
    data = DataConfig(seed=args.seed, max_num_objs=args.num_obj, data_root=args.data_root,
                      batch_size=args.batch_size, num_workers=args.num_workers,
                      vid_crop_size=(args.crop_size, args.crop_size))
    cfg = SWEMConfig(model=model, data=data, solver=solver, loss=LossConfig(),
                     exp_name=args.exp, log_dir=args.log_dir, resume=args.resume,
                     from_scratch=args.from_scratch, log_period=args.log_period,
                     save_period=args.save_period, vis_period=args.vis_period)
    return single_object_config(cfg)


def main(argv=None):
    args = get_args(argv)
    flags = (args.coordinator, args.num_processes, args.process_id)
    if not args.distributed and flags == (None,) * 3:
        return _train(args, args.device)
    import torch

    from swem_tpu_torch import parallel

    on_cpu = args.device is not None and torch.device(args.device).type == "cpu"
    backend = args.dist_backend or ("gloo" if on_cpu else "nccl")
    with parallel.process_group(*flags, backend=backend, device=args.device) as device:
        return _train(args, device)


def _train(args, device):
    from swem_tpu_torch.io.checkpoint import init_backbones
    from swem_tpu_torch.train.loop import Trainer

    trainer = Trainer(build_config(args), device=device)
    if args.backbone_init:
        paths = args.backbone_init.split(",")
        init_backbones(trainer.model, paths[0], paths[1] if len(paths) > 1 else None)
        trainer.reset_optimizer()
        trainer.logger.info(f"Initialized backbones from {paths}")
    return trainer.train()


if __name__ == "__main__":
    main()
