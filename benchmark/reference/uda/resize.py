"""Image resizes of the FPN (NCHW) in plain PyTorch: align-corners
bilinear, nearest, and the adaptive average pool."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    if x.shape[-2:] == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=True)


def upsample_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Upsample `x` to `y`'s size (bilinear, align-corners) and add."""
    return resize_bilinear_align_corners(x, y.shape[-2], y.shape[-1]) + y


def adaptive_avg_pool2d(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    if x.shape[-2:] == (out_h, out_w):
        return x
    return F.adaptive_avg_pool2d(x, (out_h, out_w))
