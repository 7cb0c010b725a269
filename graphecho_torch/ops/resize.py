"""Image resizes of the FPN (NCHW), port of `graphecho_tpu/ops/resize.py`.

The JAX package writes align-corners bilinear as two interpolation-matrix
products at `Precision.HIGHEST` because a gather is slow on the TPU;
`F.interpolate(mode="bilinear", align_corners=True)` computes the same
function (the reference's own call, `fpnseg.py:358-359,371-388`). Each
resize runs in its input's dtype: bf16 in a bf16 FPN, as the JAX package's
do (it also rounds its interpolation weights to bf16 there; these stay
exact).

On a CUDA tensor that needs a gradient, the align-corners resize and the
adaptive pool keep their forward but take their backward from the matrices
the JAX package writes them with: the gradient is Aᵀ g B for the resize or
pool A x Bᵀ. PyTorch's own CUDA backwards of both add with atomics, so two
runs of a train step differ in their last bits and drift apart over steps
(and `torch.use_deterministic_algorithms` has no deterministic version of
either to offer); two matrix products give the same bits every run. On the
CPU PyTorch's backwards are deterministic and stay as they are.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def bilinear_align_corners_matrix(out_n: int, in_n: int, device=None) -> torch.Tensor:
    """(out_n, in_n) f32 weights of a 1-D align-corners linear resize: row i
    takes source position i * (in_n - 1) / (out_n - 1). Made once per shape
    and device (a copy to the card each call would wait for the card)."""
    m = torch.zeros(out_n, in_n, dtype=torch.float32)
    if in_n == 1 or out_n == 1:
        m[:, 0] = 1.0
        return m.to(device)
    pos = torch.arange(out_n, dtype=torch.float64) * ((in_n - 1) / (out_n - 1))
    lo = pos.floor().long().clamp(0, in_n - 1)
    hi = (lo + 1).clamp(max=in_n - 1)
    frac = (pos - lo).float()
    rows = torch.arange(out_n)
    m.index_put_((rows, lo), 1.0 - frac, accumulate=True)
    m.index_put_((rows, hi), frac, accumulate=True)
    return m.to(device)


@functools.lru_cache(maxsize=None)
def adaptive_pool_matrix(out_n: int, in_n: int, device=None) -> torch.Tensor:
    """(out_n, in_n) f32 weights of a 1-D adaptive average pool: row g
    averages [floor(g*in/out), ceil((g+1)*in/out))."""
    m = torch.zeros(out_n, in_n, dtype=torch.float32)
    for g in range(out_n):
        lo, hi = (g * in_n) // out_n, -(-((g + 1) * in_n) // out_n)
        m[g, lo:hi] = 1.0 / (hi - lo)
    return m.to(device)


class _SeparableMap(torch.autograd.Function):
    """y = forward(x), an NCHW map A x Bᵀ over the last two dims; its
    gradient Aᵀ g B as two matrix products in f32."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, forward: Callable[[torch.Tensor], torch.Tensor],
                rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(rows, cols)
        ctx.dtype = x.dtype
        ctx.channels_last = x.is_contiguous(memory_format=torch.channels_last)
        return forward(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        rows, cols = ctx.saved_tensors
        grad = rows.t() @ (g.float() @ cols)
        if ctx.channels_last:
            grad = grad.contiguous(memory_format=torch.channels_last)
        return grad.to(ctx.dtype), None, None, None


def _deterministic_backward(x: torch.Tensor) -> bool:
    return x.is_cuda and x.requires_grad and torch.is_grad_enabled()


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear align-corners resize of an NCHW tensor (torch parity)."""
    if x.shape[-2:] == (out_h, out_w):
        return x

    def forward(t: torch.Tensor) -> torch.Tensor:
        return F.interpolate(t, size=(out_h, out_w), mode="bilinear", align_corners=True)

    if _deterministic_backward(x):
        h, w = x.shape[-2:]
        return _SeparableMap.apply(x, forward, bilinear_align_corners_matrix(out_h, h, x.device),
                                   bilinear_align_corners_matrix(out_w, w, x.device))
    return forward(x)


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
    if _deterministic_backward(x):
        h, w = x.shape[-2:]
        return _SeparableMap.apply(x, lambda t: F.adaptive_avg_pool2d(t, (out_h, out_w)),
                                   adaptive_pool_matrix(out_h, h, x.device),
                                   adaptive_pool_matrix(out_w, w, x.device))
    return F.adaptive_avg_pool2d(x, (out_h, out_w))
