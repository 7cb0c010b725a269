"""Gradient reversal, port of `graphecho_tpu/ops/grl.py`.

Forward identity; backward multiplies the cotangent by -lambda (reference
`models/gradient_reversal.py:6-33`).
"""

from __future__ import annotations

import torch


class GradientReversal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, lambda_: float) -> torch.Tensor:
        ctx.lambda_ = lambda_
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return -ctx.lambda_ * g, None


def gradient_reversal(x: torch.Tensor, lambda_: float = 1.0) -> torch.Tensor:
    return GradientReversal.apply(x, lambda_)
