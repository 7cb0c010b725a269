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

On a CUDA tensor the align-corners resize's forward is the hand-written
kernel of `csrc/resize.cu`, and `upsample_add`'s add is fused into it: one
launch a call, no host synchronisation, the bits of `F.interpolate` (and of
`F.interpolate(...) + y`), in f32 or bf16, NCHW or channels-last, the
output in the input's memory format as `F.interpolate`'s is. PyTorch's NCHW
kernel gives each thread one output pixel and every (frame, channel) pair,
which leaves the card nearly empty at the FPN's small maps. The CPU and a
graph being traced for `torch.export` keep `F.interpolate`. The backward is
the same matrices either way.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch._prims_common import suggest_memory_format

from graphecho_torch.ops import cuda_build

# launches of the kernel entry point since the last `reset_launch_counts()`
LAUNCHES: Dict[str, int] = {"resize": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    """y = forward(x), an NCHW map A x Bᵀ over the last two dims, or
    y = forward(x, addend) = A x Bᵀ + addend; the gradient Aᵀ g B as two
    matrix products in f32, and g itself for the addend."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, forward: Callable[..., torch.Tensor],
                rows: torch.Tensor, cols: torch.Tensor,
                addend: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx.save_for_backward(rows, cols)
        ctx.dtype = x.dtype
        ctx.channels_last = x.is_contiguous(memory_format=torch.channels_last)
        ctx.with_addend = addend is not None
        return forward(x) if addend is None else forward(x, addend)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        grad = None
        if ctx.needs_input_grad[0]:
            rows, cols = ctx.saved_tensors
            grad = rows.t() @ (g.float() @ cols)
            if ctx.channels_last:
                grad = grad.contiguous(memory_format=torch.channels_last)
            grad = grad.to(ctx.dtype)
        return grad, None, None, None, g if ctx.with_addend else None


def _deterministic_backward(x: torch.Tensor) -> bool:
    return x.is_cuda and x.requires_grad and torch.is_grad_enabled()


# ------------------------------------------------------------------ the kernel
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("resize")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.resize_bilinear.argtypes = [p, p, p, ctypes.c_longlong, i, i, i, i, i, i, i, i, p]
    lib.resize_bilinear.restype = ctypes.c_int
    return lib


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _kernel_takes(x: torch.Tensor) -> bool:
    """Whether the resize of `x` runs the kernel: a CUDA tensor, outside a
    graph being traced (`torch.export` sees `F.interpolate`)."""
    return x.is_cuda and type(x) is torch.Tensor and not torch.compiler.is_compiling()


def _channels_last(x: torch.Tensor) -> bool:
    """Whether `F.interpolate` gives x's resize the channels-last layout:
    x's `suggest_memory_format`, read from the quicker flags where x is
    dense in one layout and not the other."""
    channels_last = x.is_contiguous(memory_format=torch.channels_last)
    if x.is_contiguous() != channels_last:
        return channels_last
    return suggest_memory_format(x) == torch.channels_last


def _launch(x: torch.Tensor, out_h: int, out_w: int,
            addend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel: `x` (N, C, H, W) on the card resized to (out_h, out_w),
    plus `addend` (N, C, out_h, out_w) of x's dtype where given, in one launch
    on the current stream with no synchronisation. The output takes x's
    memory format; x and the addend are brought to it (no copy where they
    have it). Raises on a dtype the kernel lacks."""
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the resize kernel takes float32 or bfloat16, not {x.dtype}")
    channels_last = _channels_last(x)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x = x.contiguous(memory_format=fmt)
    n, c, h, w = x.shape
    out = (x.new_empty((n, out_h, out_w, c)).permute(0, 3, 1, 2) if channels_last
           else x.new_empty((n, c, out_h, out_w)))
    if out.numel() and x.numel():
        if addend is not None:
            addend = addend.contiguous(memory_format=fmt)
        dev = x.get_device()
        err = _lib().resize_bilinear(x.data_ptr(), None if addend is None else addend.data_ptr(),
                                     out.data_ptr(), n, c, h, w, out_h, out_w,
                                     int(x.dtype == torch.bfloat16),
                                     int(channels_last), dev,
                                     torch._C._cuda_getCurrentRawStream(dev))
        cuda_build.check(err, "resize_bilinear")
        LAUNCHES["resize"] += 1
    return out


def _library(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=True)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear align-corners resize of an NCHW tensor (torch parity)."""
    if x.shape[-2:] == (out_h, out_w):
        return x
    if _kernel_takes(x):
        def forward(t):
            return _launch(t, out_h, out_w, None)
    else:
        def forward(t):
            return _library(t, out_h, out_w)
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
    the FPN top-down merge (`fpnseg.py:371-388`). On the card one launch
    computes the sum where `y` is a plain tensor of the output's shape and
    x's dtype and device."""
    out_h, out_w = y.shape[-2:]
    if (x.shape[-2:] == (out_h, out_w) or not _kernel_takes(x) or type(y) is not torch.Tensor
            or y.dtype != x.dtype or y.device != x.device
            or y.shape != (*x.shape[:2], out_h, out_w)):
        return resize_bilinear_align_corners(x, out_h, out_w) + y
    if torch.is_grad_enabled() and (x.requires_grad or y.requires_grad):
        h, w = x.shape[-2:]
        return _SeparableMap.apply(x, lambda t, addend: _launch(t, out_h, out_w, addend),
                                   bilinear_align_corners_matrix(out_h, h, x.device),
                                   bilinear_align_corners_matrix(out_w, w, x.device), y)
    return _launch(x, out_h, out_w, y)


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
