"""LR schedules and per-component optimizers, port of
`graphecho_tpu/train/schedule.py`.

`warmup_multistep_factor` is the reference `WarmupMultiStepLR`
(`utils/lr_scheduler.py:9-51`): a constant or linear warmup for
`warmup_iters` steps at `warmup_factor`, then a factor `gamma` at each
milestone. The reference steps its schedulers once per EPOCH
(`train_camus_echo.py:312-316`), so the LR of an update is the schedule at
`update_count // steps_per_epoch`.

`build_optimizer` maps the per-component configs (`train_camus_echo.py:425-435`)
to `torch.optim.Adam`/`SGD`, whose `weight_decay` is added to the gradient
(coupled L2, not AdamW): what the JAX package's optax chain
(`add_decayed_weights` before `scale_by_adam`/`trace`) reproduces.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Tuple

import torch

from graphecho_torch.config import ComponentConfig, ScheduleConfig


def warmup_multistep_factor(count: int, cfg: ScheduleConfig) -> float:
    """LR multiplier after `count` scheduler steps."""
    if count < cfg.warmup_iters:
        if cfg.warmup_method == "constant":
            warmup = cfg.warmup_factor
        else:  # linear
            alpha = min(count / max(cfg.warmup_iters, 1), 1.0)
            warmup = cfg.warmup_factor * (1 - alpha) + alpha
    else:
        warmup = 1.0
    decay_pow = sum(count >= m for m in cfg.steps)
    return warmup * cfg.gamma ** decay_pow


def build_optimizer(cfg: ComponentConfig, params: Iterable[torch.nn.Parameter],
                    steps_per_epoch: int = 1
                    ) -> Tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """(optimizer, lr_at) for one component; `lr_at(n)` is the LR of the
    n-th update (0-based), constant within an epoch."""
    if steps_per_epoch < 1:
        # a dataset smaller than the batch is the usual way to arrive here;
        # flooring by 0 would train at a garbage LR
        raise ValueError(f"steps_per_epoch must be >= 1, got {steps_per_epoch}")
    opt = cfg.opt
    if opt.opt_name == "Adam":
        optimizer = torch.optim.Adam(params, lr=opt.lr, betas=tuple(opt.betas), eps=1e-8,
                                     weight_decay=opt.weight_decay)
    elif opt.opt_name == "SGD":
        optimizer = torch.optim.SGD(params, lr=opt.lr, momentum=opt.momentum,
                                    weight_decay=opt.weight_decay)
    else:
        raise ValueError(f"unknown optimizer {opt.opt_name!r}")

    def lr_at(count: int) -> float:
        return opt.lr * warmup_multistep_factor(count // steps_per_epoch, cfg.sch)

    return optimizer, lr_at


def cosine_lr(base_lr: float, epoch: int, total_epochs: int) -> float:
    """Cosine decay of the reference's (unused) `adjust_learning_rate`
    (`train_camus_echo.py:419-423`)."""
    return base_lr * 0.5 * (1.0 + math.cos(math.pi * epoch / total_epochs))
