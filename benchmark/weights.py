"""Weights and initial state made on the device from the seed, handed to
the system under test and to the plain reference alike.

Every leaf of every component's state dict gets a value by a rule on its
name and the class of the module that owns it: a norm layer's scale and
running variance 1, its shift and running mean 0; a convolution's or a
linear layer's weight He-normal, sqrt(2 / fan_in), and for a classifier
(fewer than 8 outputs) centred over each output's fan-in, so that logits
over positive features take both signs and a mask has edges to check;
everything else (biases,
the affinity MLP's raw matrices, the TGCN's position embedding) normal with
std 0.01. The normal draws are one `torch.randn` over all leaves, in the
order of the sorted leaf names, from a generator seeded with the seed, so
two module trees with the same names and shapes get the same values.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import torch
from torch import nn

Spec = Tuple[str, str, Tuple[int, ...], str, float]  # component, leaf, shape, kind, std


def leaf_specs(modules: Mapping[str, nn.Module]) -> List[Spec]:
    specs: List[Spec] = []
    for comp in sorted(modules):
        module = modules[comp]
        owners = dict(module.named_modules())
        for name, t in sorted(module.state_dict(keep_vars=True).items()):
            owner_name, _, leaf = name.rpartition(".")
            cls = type(owners[owner_name]).__name__
            shape = tuple(t.shape)
            if leaf == "num_batches_tracked":
                continue
            if "Norm" in cls:
                kind, std = ("one" if leaf in ("weight", "running_var") else "zero"), 0.0
            elif leaf == "weight" and t.dim() >= 2 and ("Conv" in cls or cls == "Linear"):
                kind = "centred" if shape[0] < 8 else "normal"
                std = math.sqrt(2.0 / (t.numel() // shape[0]))
            else:
                kind, std = "normal", 0.01
            specs.append((comp, name, shape, kind, std))
    return specs


def make(modules: Mapping[str, nn.Module], seed: int, device: torch.device
         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{component: state dict} for `modules`, on `device`, from `seed`."""
    specs = leaf_specs(modules)
    total = sum(math.prod(s[2]) for s in specs if s[3] in ("normal", "centred"))
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    at = 0
    for comp, name, shape, kind, std in specs:
        n = math.prod(shape)
        if kind in ("normal", "centred"):
            value = flat[at:at + n].view(shape) * std
            at += n
            if kind == "centred" and n > shape[0]:
                rows = value.reshape(shape[0], -1)
                value = (rows - rows.mean(dim=1, keepdim=True)).view(shape)
        else:
            value = torch.full(shape, 1.0 if kind == "one" else 0.0, device=device)
        out.setdefault(comp, {})[name] = value
    return out


def step_state(seed: int, device: torch.device, cfg) -> Dict[str, object]:
    """The step's state besides the weights, for the experiment `cfg`: the
    two seed banks (normal), with the temporal branch the two momentum
    queues (normal, unit columns), and the seed of the step's generator,
    from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    banks = (cfg.gmodule.num_classes, cfg.gmodule.in_channels)
    state: Dict[str, object] = {"sr_seed": torch.randn(banks, generator=gen, device=device),
                                "tg_seed": torch.randn(banks, generator=gen, device=device)}
    if cfg.train.temporal_graph:
        for name in ("queue_source", "queue_target"):
            q = torch.randn((cfg.tgcn.hidden_dim, cfg.tgcn.queue_size), generator=gen,
                            device=device)
            state[name] = q / torch.linalg.vector_norm(q, dim=0, keepdim=True)
    state["generator_seed"] = (seed * 2654435761 + 97) % (2 ** 62)
    return state
