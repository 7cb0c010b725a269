"""CLI entry: CAMUS→EchoNet UDA training, port of `graphecho_tpu/train_camus_echo.py`.

Mirrors `python train_camus_echo.py` (the reference's trainer) but with
actual flags (the reference imports argparse and never uses it):

    python -m graphecho_torch.train_camus_echo --epochs 400 --batch-size 8 \\
        --camus-root /data/camus --echonet-root /data/echonet \\
        --save-dir ./result/model --log-dir ./result/log

Without dataset roots it runs on synthetic data (pipeline smoke mode). It runs
on CUDA unless `--device` names another device. With `--save-dir` a run
resumes from the latest checkpoint there, and SIGTERM/SIGINT stops it after
the current step with a checkpoint. Data parallel, one process per GPU:

    torchrun --nproc-per-node 4 -m graphecho_torch.train_camus_echo --use-mesh ...

or start each process with `--num-processes N --process-id I --coordinator
host:port --use-mesh`. EchoNet needs cv2 (`.avi`) and pandas
(its CSVs); CAMUS needs neither.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--steps-per-epoch", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--view-num", default="2", choices=list("1234"))
    p.add_argument("--camus-root", default=None)
    p.add_argument("--echonet-root", default=None)
    p.add_argument("--save-dir", default=None)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--use-mesh", action="store_true",
                   help="data parallel over the process group, one process per device")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--pretrained-backbone", default=None,
                   help="torch .pth to initialize the FPN from: torchvision zoo ResNet "
                        "weights or a reference GraphEcho checkpoint")
    p.add_argument("--no-graph-matching", action="store_true")
    p.add_argument("--no-discriminator", action="store_true")
    p.add_argument("--temporal-graph", action="store_true")
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


def init_distributed(args) -> None:
    """Join the process group the flags (or the launcher's environment)
    describe, as the JAX CLIs call `initialize_distributed`; a no-op for one
    process."""
    from graphecho_torch.parallel.mesh import initialize_distributed

    initialize_distributed(coordinator=args.coordinator, num_processes=args.num_processes,
                           process_id=args.process_id)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    init_distributed(args)
    if args.camus_root and args.echonet_root:
        from graphecho_torch.real_training import run_camus_echo

        run_camus_echo(args, device=args.device)
    else:
        from graphecho_torch.entrypoints import train_camus_echo

        train_camus_echo(
            num_epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
            checkpoint_dir=args.save_dir, use_mesh=args.use_mesh, seed=args.seed,
            torch_init=args.pretrained_backbone, device=args.device,
            view_num=args.view_num,
            graph_matching=not args.no_graph_matching,
            discriminator=not args.no_discriminator,
            temporal_graph=args.temporal_graph)


if __name__ == "__main__":
    main()
