"""CLI entry: CAMUS→EchoNet UDA training, port of `graphecho_tpu/train_camus_echo.py`.

Mirrors `python train_camus_echo.py` (the reference's trainer) but with
actual flags (the reference imports argparse and never uses it):

    python -m graphecho_torch.train_camus_echo --epochs 400 --batch-size 8 \\
        --camus-root /data/camus --echonet-root /data/echonet \\
        --save-dir ./result/model --log-dir ./result/log

Without dataset roots it runs on synthetic data (pipeline smoke mode). It runs
on CUDA unless `--device` names another device. With `--save-dir` a run
resumes from the latest checkpoint there, and SIGTERM/SIGINT stops it after
the current step with a checkpoint. EchoNet needs cv2 (`.avi`) and pandas
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
                   help="data-parallel over all local devices (not ported yet)")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--pretrained-backbone", default=None,
                   help="torch .pth to initialize the FPN from (not ported yet)")
    p.add_argument("--no-graph-matching", action="store_true")
    p.add_argument("--no-discriminator", action="store_true")
    p.add_argument("--temporal-graph", action="store_true")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-process training (not ported yet)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 (multi-process only; not ported yet)")
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda)")
    return p


def check_deferred(args) -> None:
    """Raise for the flags whose code paths the port does not have yet."""
    deferred = {
        "--use-mesh": (args.use_mesh, "the data-parallel slice"),
        "--num-processes > 1": ((args.num_processes or 1) > 1, "the data-parallel slice"),
        "--coordinator": (args.coordinator is not None, "the data-parallel slice"),
        "--pretrained-backbone": (args.pretrained_backbone is not None, "the tooling slice"),
    }
    for flag, (on, where) in deferred.items():
        if on:
            raise NotImplementedError(
                f"{flag} is not ported to graphecho_torch yet; it comes with {where} "
                "(ROADMAP.md, Queue 1)")


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    check_deferred(args)
    if args.camus_root and args.echonet_root:
        from graphecho_torch.real_training import run_camus_echo

        run_camus_echo(args, device=args.device)
    else:
        from graphecho_torch.entrypoints import train_camus_echo

        train_camus_echo(
            num_epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
            checkpoint_dir=args.save_dir, seed=args.seed, device=args.device,
            view_num=args.view_num,
            graph_matching=not args.no_graph_matching,
            discriminator=not args.no_discriminator,
            temporal_graph=args.temporal_graph)


if __name__ == "__main__":
    main()
