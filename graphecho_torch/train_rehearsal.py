"""Training rehearsal: a paper recipe for hundreds of optimizer steps, to show
that the trainer trains; the counterpart of `scripts/train_rehearsal.py`.

    python -m graphecho_torch.train_rehearsal --recipe camus_temporal --bf16 \\
        --epochs 10 --steps-per-epoch 30 --ckpt runs/camus --out runs/camus.jsonl \\
        [--sigterm-at-step 137]

The recipe (`profile_step.RECIPES`: the paper's configs at batch 8 + 8) trains
at full width on synthetic, learnable frames (`data/synthetic.py`: bright
ellipses where the masks are), validates on a fixed eval set after every
epoch and checkpoints the whole state into `--ckpt`. `--sigterm-at-step N`
sends the process a SIGTERM once global step N is done: the trainer stops
after the next step with a checkpoint. Run again with the same `--ckpt`, it
resumes there and runs the epochs that remain, starting mid-epoch at the live
global step.

The curve across an interruption equals the uninterrupted one: step s trains
on `SyntheticEchoData(cfg, seed=data_seed + 1000 + s)`, the eval set is always
`seed=data_seed + 99`, the checkpoint holds every tensor of the state
(weights, optimizer moments, BatchNorm statistics, seed banks, queues, the
generator), and on CUDA every op is deterministic: `main` calls
`device.deterministic_algorithms` before any CUDA work
(`torch.use_deterministic_algorithms(True)`, `CUBLAS_WORKSPACE_CONFIG=:4096:8`;
without them the card's atomics make two runs from one seed differ from the
first epoch), and `run` on CUDA refuses to start without them.
`python -m graphecho_torch.rehearsal_report` compares the two curves.

Appends one JSON line an epoch to `--out`: {"recipe", "bf16", "step",
"total_loss", "seg_loss", "dice", "step_seconds"}, each float rounded to 6
digits. Runs on CUDA unless `--device` names another device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
from typing import Dict, Iterator, Optional

import torch

from graphecho_torch.config import ExperimentConfig
from graphecho_torch.data.synthetic import SyntheticEchoData
from graphecho_torch.device import deterministic_algorithms, resolve_device
from graphecho_torch.profile_step import RECIPES
from graphecho_torch.train.trainer import Trainer

REHEARSAL_RECIPES = ("cardiac", "camus_temporal", "cardiac_full")


def recipe_config(recipe: str, bf16: bool) -> ExperimentConfig:
    """The recipe's config, its FPN and TGCN computing in bf16 or f32."""
    cfg = RECIPES[recipe]()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, compute_dtype="bfloat16" if bf16 else "float32"))


def run(cfg: ExperimentConfig, *, recipe: str, bf16: bool, epochs: int, steps_per_epoch: int,
        ckpt: str, out: str, sigterm_at_step: Optional[int] = None, eval_samples: int = 16,
        data_seed: int = 7, device=None) -> Trainer:
    """Train `cfg` to `epochs` epochs of `steps_per_epoch` steps in all,
    resuming from the latest checkpoint in `ckpt`; appends the epoch rows to
    `out` and returns the trainer. On CUDA, deterministic algorithms must be
    on (`device.deterministic_algorithms`), or the curve would not repeat."""
    device = resolve_device(device)
    if device.type == "cuda" and not torch.are_deterministic_algorithms_enabled():
        raise RuntimeError(
            "train_rehearsal.run on CUDA needs deterministic algorithms: call "
            "graphecho_torch.device.deterministic_algorithms(device) before any CUDA work")
    trainer = Trainer(cfg, device=device, checkpoint_dir=ckpt)
    trainer.init_state()  # restores the latest checkpoint if there is one
    spe = steps_per_epoch

    def batches() -> Iterator[Dict]:
        # from the live global step: after a stop mid-epoch, the rest of it
        s0 = trainer.state.step
        for s in range(s0, (s0 // spe + 1) * spe):
            yield SyntheticEchoData(cfg, seed=data_seed + 1000 + s).train_batch()
            if sigterm_at_step is not None and s + 1 == sigterm_at_step:
                print(f"[rehearsal] raising SIGTERM at global step {s + 1}", flush=True)
                os.kill(os.getpid(), signal.SIGTERM)

    def eval_batches():
        # the same eval set every epoch
        return SyntheticEchoData(cfg, seed=data_seed + 99).eval_batches(eval_samples)

    with open(out, "a") as f:
        def record(epoch: int, means: Dict[str, float], dices: Dict[str, float]) -> None:
            row = {"recipe": recipe, "bf16": bf16, "step": trainer.state.step,
                   "total_loss": means.get("total_loss", float("nan")),
                   "seg_loss": means.get("seg_loss", float("nan")),
                   "dice": dices.get("synth", float("nan")),
                   "step_seconds": means.get("step_seconds", 0.0)}
            f.write(json.dumps({k: round(v, 6) if isinstance(v, float) else v
                                for k, v in row.items()}) + "\n")
            f.flush()

        done = trainer.state.step // spe
        remaining = max(epochs - done, 0)
        if trainer.state.step:
            print(f"[rehearsal] resumed at step {trainer.state.step} (epoch {done}); "
                  f"{remaining} epochs remain", flush=True)
        if remaining:
            trainer.train(batches, num_epochs=remaining, eval_fns={"synth": eval_batches},
                          on_epoch_end=record)
    print(f"[rehearsal] done at step {trainer.state.step}", flush=True)
    return trainer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--recipe", default="camus_temporal", choices=REHEARSAL_RECIPES)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--epochs", type=int, default=10,
                   help="epochs in all (a resumed run runs the rest)")
    p.add_argument("--steps-per-epoch", type=int, default=30)
    p.add_argument("--ckpt", required=True, help="checkpoint directory")
    p.add_argument("--out", required=True, help="JSONL curve, appended to")
    p.add_argument("--sigterm-at-step", type=int, default=None,
                   help="SIGTERM this process once this global step is done")
    p.add_argument("--eval-samples", type=int, default=16)
    p.add_argument("--data-seed", type=int, default=7)
    p.add_argument("--device", default=None, help="torch device to run on (default: cuda)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    deterministic_algorithms(device)  # before the Trainer's first CUDA call
    run(recipe_config(args.recipe, args.bf16), recipe=args.recipe, bf16=args.bf16,
        epochs=args.epochs, steps_per_epoch=args.steps_per_epoch, ckpt=args.ckpt, out=args.out,
        sigterm_at_step=args.sigterm_at_step, eval_samples=args.eval_samples,
        data_seed=args.data_seed, device=device)


if __name__ == "__main__":
    main()
