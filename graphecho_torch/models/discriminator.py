"""Per-level patch discriminator with gradient reversal, port of
`graphecho_tpu/models/discriminator.py`.

Reference `Discriminator` (`models/fpnseg.py:447-511`): a 4x (conv3x3 +
GroupNorm(32) + ReLU) tower, a 1-channel conv head, GRL applied to both
domains (or the target only), BCE-with-logits against source=1 / target=0;
returns loss_s + loss_t. Both domains go through the tower as one batch (conv
and GroupNorm are per-sample, so the math is that of two passes). The
GroupNorms use eps 1e-6, flax's default that the JAX package leaves in place
(torch and the reference use 1e-5).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from graphecho_torch.models.backbones import conv2d
from graphecho_torch.models.fpn import FLAX_GN_EPS
from graphecho_torch.ops.grl import gradient_reversal
from graphecho_torch.train.losses import bce_with_logits


class Discriminator(nn.Module):
    def __init__(self, num_convs: int = 4, in_channels: int = 256,
                 grad_reverse_lambda: float = 0.02, grl_applied_domain: str = "both"):
        super().__init__()
        self.num_convs = num_convs
        self.grad_reverse_lambda = grad_reverse_lambda
        self.grl_applied_domain = grl_applied_domain
        for i in range(num_convs):
            setattr(self, f"dis_tower_{i}", conv2d(in_channels, in_channels, 3, padding=1,
                                                   init=("normal", 0.01)))
            setattr(self, f"gn_{i}", nn.GroupNorm(32, in_channels, eps=FLAX_GN_EPS))
        self.cls_logits = conv2d(in_channels, 1, 3, padding=1, init=("normal", 0.01))

    def forward(self, features_s: torch.Tensor, features_t: torch.Tensor) -> torch.Tensor:
        """NCHW source and target maps -> scalar adversarial loss."""
        if self.grl_applied_domain == "both":
            features_s = gradient_reversal(features_s, self.grad_reverse_lambda)
        features_t = gradient_reversal(features_t, self.grad_reverse_lambda)
        x = torch.cat([features_s, features_t], dim=0)
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"gn_{i}")(getattr(self, f"dis_tower_{i}")(x)))
        x = self.cls_logits(x)
        bs = features_s.shape[0]
        x_s, x_t = x[:bs], x[bs:]
        return (bce_with_logits(x_s, torch.ones_like(x_s))
                + bce_with_logits(x_t, torch.zeros_like(x_t)))
