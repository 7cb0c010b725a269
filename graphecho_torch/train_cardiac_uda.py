"""CLI entry: CardiacUDA Site_G→Site_R training, port of
`graphecho_tpu/train_cardiac_uda.py`.

Mirrors `python train_cardiac_uda.py` (the reference's trainer):

    python -m graphecho_torch.train_cardiac_uda --epochs 400 --batch-size 8 \\
        --root /data/cardiac_uda --infos /data/cardiac_uda/infos.npy \\
        --view-num 4 --save-dir ./result/model --temporal-graph --cyc-loss

`--backbone pvig_s` trains the FPN on a Pyramid ViG-S backbone in place of
the recipe's VGG16-BN, from random weights.

`python -m graphecho_torch.data.infos --root /data/cardiac_uda` writes the
infos file. Without --root/--infos it runs on synthetic data (pipeline smoke
mode). It runs on CUDA unless `--device` names another device. With
`--save-dir` a run resumes from the latest checkpoint there, and
SIGTERM/SIGINT stops it after the current step with a checkpoint. Reading
CardiacUDA needs neither cv2 nor nibabel. `--use-mesh` with one process per
GPU (`torchrun`, or `--num-processes/--process-id/--coordinator`) trains data
parallel.
"""

from __future__ import annotations

import argparse

from graphecho_torch.train_camus_echo import init_distributed


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--steps-per-epoch", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--view-num", default="4", choices=list("1234"))
    p.add_argument("--root", default=None)
    p.add_argument("--infos", default=None, help="path to infos.npy")
    p.add_argument("--save-dir", default=None)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--use-mesh", action="store_true",
                   help="data parallel over the process group, one process per device")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--pretrained-backbone", default=None,
                   help="torch .pth to initialize the FPN from: torchvision zoo ResNet "
                        "weights or a reference GraphEcho checkpoint")
    p.add_argument("--backbone", default="VGG16", choices=("VGG16", "pvig_s"),
                   help="the FPN's backbone: the recipe's VGG16-BN or Pyramid ViG-S")
    p.add_argument("--no-graph-matching", action="store_true")
    p.add_argument("--no-discriminator", action="store_true")
    p.add_argument("--temporal-graph", action="store_true")
    p.add_argument("--cyc-loss", action="store_true")
    # multi-process launch (reference NCCL init `train_camus_echo.py:526-535`):
    # `parallel.mesh.initialize_distributed`; unset values come from the
    # launcher's environment (WORLD_SIZE, RANK, MASTER_ADDR, ...)
    p.add_argument("--num-processes", type=int, default=None,
                   help="processes in the run, one per device")
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (multi-process only)")
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda)")
    return p


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.backbone == "pvig_s" and args.pretrained_backbone:
        parser.error("--pretrained-backbone: no Pyramid ViG checkpoint loads into the FPN; "
                     "pvig_s starts from random weights")
    init_distributed(args)
    if args.root and args.infos:
        from graphecho_torch.real_training import run_cardiac_uda

        run_cardiac_uda(args, device=args.device)
    else:
        from graphecho_torch.entrypoints import train_cardiac_uda

        train_cardiac_uda(
            num_epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
            checkpoint_dir=args.save_dir, use_mesh=args.use_mesh, seed=args.seed,
            torch_init=args.pretrained_backbone, device=args.device,
            view_num=args.view_num,
            graph_matching=not args.no_graph_matching,
            discriminator=not args.no_discriminator,
            temporal_graph=args.temporal_graph, cyc_loss=args.cyc_loss,
            backbone=args.backbone)


if __name__ == "__main__":
    main()
