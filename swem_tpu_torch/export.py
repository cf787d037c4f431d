"""Export CLI of the port: ``python -m swem_tpu_torch.export``.

Writes a trained SWEM checkpoint as a ``torch.export`` inference artifact
(``io/export.py``): programs, weights and a manifest, which replay
DAVIS-style fixed-size inference with torch and the port's kernel ops
alone. Takes ``scripts/export_model.py``'s flags, with ``--device`` (default:
CUDA; ``cpu`` exports the plain PyTorch path) in place of ``--platforms``:
an artifact replays on the device type it was exported on.

    python -m swem_tpu_torch.export --resume ckpts/swem.pth \\
        --out artifacts/swem_480p --in_size 480 864 --out_size 480 854

``--resume`` is a reference ``.pth``, the port's ``variables.pth`` or a
directory holding one, as ``python -m swem_tpu_torch.eval`` reads them; an
orbax directory raises (it needs the JAX package; ``scripts/orbax_to_pth.py``
converts it). Replay with::

    from swem_tpu_torch.io.export import ExportedRunner
    runner = ExportedRunner("artifacts/swem_480p"); runner.warmup()
    preds = runner(frames_u8, init_mask_onehot, active)   # (T,1,H,W,3) uint8
"""

from __future__ import annotations

import argparse


def get_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m swem_tpu_torch.export",
                                description="SWEM inference export on PyTorch/CUDA")
    p.add_argument("--resume", required=True,
                   help="checkpoint: a reference torch .pth or the port's variables.pth")
    p.add_argument("--out", required=True, help="artifact output directory")
    p.add_argument("--backbone", default="resnet50", choices=["resnet50", "resnet18"])
    p.add_argument("--key_dim", type=int, default=128)
    p.add_argument("--val_dim", type=int, default=512)
    p.add_argument("--num_bases", type=int, default=128)
    p.add_argument("--em_iters", type=int, default=4)
    p.add_argument("--tau", type=float, default=0.05)
    p.add_argument("--top_l", type=int, default=64)
    p.add_argument("--max_objs", type=int, default=8)
    p.add_argument("--mdim", type=int, default=256, help="decoder width")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--in_size", type=int, nargs=2, default=(480, 864), metavar=("H", "W"),
                   help="raw uint8 frame size fed to the artifact (DAVIS eval default)")
    p.add_argument("--out_size", type=int, nargs=2, default=(480, 854), metavar=("H", "W"),
                   help="prediction size")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--scores", action="store_true",
                   help="emit float32 soft masks instead of uint8 indices")
    p.add_argument("--injectable", action="store_true",
                   help="export mid-video object injection inputs (ExportedRunner "
                        "injections / ExportedSession.add_objects)")
    p.add_argument("--seed", type=int, default=0, help="the frame-0 bases' draw")
    p.add_argument("--device", default=None,
                   help="torch device the artifact runs on (default: CUDA, raising without "
                        "one; 'cpu' for the plain PyTorch path)")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    from swem_tpu_torch import registry
    from swem_tpu_torch.config import EvalConfig, ModelConfig, SWEMConfig
    from swem_tpu_torch.io.export import export_runner
    from swem_tpu_torch.models.swem import SWEM

    model_cfg = ModelConfig(
        backbone=args.backbone, keydim=args.key_dim, valdim=args.val_dim,
        num_bases=args.num_bases, num_em_iters=args.em_iters, em_tau=args.tau,
        topl=args.top_l, max_objs=args.max_objs, mdim=args.mdim, dtype=args.dtype,
    )
    cfg = SWEMConfig(model=model_cfg, eval=EvalConfig(data_root="", max_objs=args.max_objs))
    model = SWEM(model_cfg, args.device)
    model.load_state_dict(registry.load_state_dict(cfg, args.resume))
    export_runner(model, args.out, frame_hw=tuple(args.in_size),
                  out_size=tuple(args.out_size), batch=args.batch, chunk=args.chunk,
                  scores=args.scores, injectable=args.injectable, seed=args.seed)
    print(f"wrote artifact to {args.out}")


if __name__ == "__main__":
    main()
