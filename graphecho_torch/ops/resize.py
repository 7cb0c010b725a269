"""Image resizes of the FPN (NCHW), port of `graphecho_tpu/ops/resize.py`.

The JAX package writes align-corners bilinear as two interpolation-matrix
products at `Precision.HIGHEST` because a gather is slow on the TPU;
`F.interpolate(mode="bilinear", align_corners=True)` computes the same
function (the reference's own call, `fpnseg.py:358-359,371-388`). Each
resize runs in its input's dtype: bf16 in a bf16 FPN, as the JAX package's
do (it also rounds its interpolation weights to bf16 there; these stay
exact).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear align-corners resize of an NCHW tensor (torch parity)."""
    if x.shape[-2:] == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=True)


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest-neighbour resize of an NCHW tensor: src = floor(i * in/out)."""
    if x.shape[-2:] == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="nearest")


def upsample_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Upsample `x` to `y`'s spatial size (bilinear, align-corners) and add —
    the FPN top-down merge (`fpnseg.py:371-388`)."""
    return resize_bilinear_align_corners(x, y.shape[-2], y.shape[-1]) + y


def adaptive_avg_pool2d(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """torch's adaptive average pool of an NCHW tensor, which the JAX package
    writes as two bucket-matrix products (`adaptive_avg_pool2d`): bucket g
    covers [floor(g*in/out), ceil((g+1)*in/out)), also where the output is
    larger than the input (the camus 4x4 level pooled up to an 8x8 grid)."""
    if x.shape[-2:] == (out_h, out_w):
        return x
    return F.adaptive_avg_pool2d(x, (out_h, out_w))
