"""Train state, port of `graphecho_tpu/train/state.py`.

One object holds everything a step reads and writes: the modules (their
parameters and BatchNorm buffers), the per-component optimizers and their LR
schedules, the seed banks, the generator the step draws its noise from, and
the step and epoch counters. Weights are drawn on the CPU from a generator
seeded with `cfg.train.seed`, so a run starts from the same weights on any
device, and then moved to the state's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional

import torch
from torch import nn

from graphecho_torch.config import ExperimentConfig
from graphecho_torch.models.initializers import initialize
from graphecho_torch.train.schedule import build_optimizer

DIS_LEVELS = ("p2", "p3", "p4", "p5")


@dataclasses.dataclass
class Component:
    """A trained component: its module, optimizer and LR schedule."""

    module: nn.Module
    opt: torch.optim.Optimizer
    lr_at: Callable[[int], float]

    def apply_gradients(self, update_count: int) -> None:
        """One optimizer step at the LR of update `update_count`. A parameter
        that got no gradient steps with a zero one, as optax's update of the
        whole tree does (weight decay and momentum still act on it)."""
        for p in self.module.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        lr = self.lr_at(update_count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()


@dataclasses.dataclass
class TrainState:
    step: int
    epoch: int
    generator: torch.Generator
    device: torch.device
    net: Component
    gmn: Optional[Component] = None
    sr_seed: Optional[torch.Tensor] = None
    tg_seed: Optional[torch.Tensor] = None
    dis: Optional[Component] = None  # module: ModuleDict level -> Discriminator

    def components(self):
        return [c for c in (self.net, self.gmn, self.dis) if c is not None]

    def load_converted(self, converted: Mapping[str, Any]) -> None:
        """Load the output of `graphecho_torch.convert.from_flax`."""
        if "fpn" in converted:
            self.net.module.load_state_dict(converted["fpn"])
        if "gmodule" in converted:
            self.gmn.module.load_state_dict(converted["gmodule"])
        if "dis" in converted:
            for lvl, sd in converted["dis"].items():
                self.dis.module[lvl].load_state_dict(sd)
        for seed in ("sr_seed", "tg_seed"):
            if seed in converted:
                setattr(self, seed, converted[seed].to(self.device))


def create_train_state(cfg: ExperimentConfig, models: Dict[str, nn.Module],
                       device: torch.device, steps_per_epoch: int = 1,
                       seed: Optional[int] = None) -> TrainState:
    """Initialize every module and optimizer of `models` (from `build_models`)."""
    t = cfg.train
    gen = torch.Generator().manual_seed(t.seed if seed is None else seed)

    def component(module: nn.Module, comp_cfg) -> Component:
        initialize(module, gen)
        module.to(device)
        opt, lr_at = build_optimizer(comp_cfg, module.parameters(), steps_per_epoch)
        return Component(module, opt, lr_at)

    kwargs: Dict[str, Any] = dict(net=component(models["fpn"], t.net))
    if "gmodule" in models:
        kwargs["gmn"] = component(models["gmodule"], t.gmn)
        shape = (cfg.gmodule.num_classes, cfg.gmodule.in_channels)
        kwargs["sr_seed"] = torch.randn(shape, generator=gen).to(device)
        kwargs["tg_seed"] = torch.randn(shape, generator=gen).to(device)
    if "discriminator" in models:
        kwargs["dis"] = component(models["discriminator"], t.dis)
    step_gen = torch.Generator(device=device)
    step_gen.manual_seed(int(torch.randint(2 ** 62, (1,), generator=gen)))
    return TrainState(step=0, epoch=0, generator=step_gen, device=device, **kwargs)
