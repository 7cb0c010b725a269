"""Parameter initialisation from an explicit `torch.Generator`.

The port draws its random weights the way the flax modules of the JAX
package declare them (`lecun_normal` by default, `he_normal` in the
backbones, `normal(0.01)` in the graph head), so a run from random weights
starts at the same scales. The numbers differ from JAX's: parity tests carry
the JAX weights across with `graphecho_torch.convert.from_flax` instead.

A layer names its scheme in an `init_scheme` attribute; `initialize` walks a
model in module order and fills every such layer from one generator, and calls
the `init_parameters(gen)` of a module that holds raw parameters.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# flax's truncated-normal variance scaling divides by the std of a standard
# normal truncated to [-2, 2] so that the variance is the one asked for
_TRUNC_STD = 0.87962566103423978


def _fan_in(w: torch.Tensor) -> int:
    # conv OIHW and linear (out, in) both keep fan-in in every dim but the first
    return w[0].numel() if w.dim() > 1 else w.numel()


def _variance_scaling_(w: torch.Tensor, scale: float, fan_in: int,
                       gen: torch.Generator) -> None:
    std = math.sqrt(scale / max(fan_in, 1)) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def set_init(layer: nn.Module, scheme) -> nn.Module:
    """Tag `layer` with its scheme: "lecun", "he" or ("normal", std)."""
    layer.init_scheme = scheme
    return layer


@torch.no_grad()
def initialize(model: nn.Module, gen: torch.Generator) -> nn.Module:
    for mod in model.modules():
        if hasattr(mod, "init_parameters"):  # raw parameters (the Affinity's)
            mod.init_parameters(gen)
        scheme = getattr(mod, "init_scheme", None)
        if scheme is None:
            continue
        w = mod.weight
        if scheme == "lecun":
            _variance_scaling_(w, 1.0, _fan_in(w), gen)
        elif scheme == "he":
            _variance_scaling_(w, 2.0, _fan_in(w), gen)
        else:
            _, std = scheme
            w.copy_(torch.randn(w.shape, generator=gen) * std)
        if getattr(mod, "bias", None) is not None:
            mod.bias.zero_()
    return model
