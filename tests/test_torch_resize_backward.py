"""The deterministic backwards of `graphecho_torch/ops/resize.py`: on a CUDA
tensor the align-corners resize and the adaptive pool take their gradient
from the matrices the JAX package writes them with (Aᵀ g B) instead of
PyTorch's atomic CUDA backwards.

  * the matrices equal the JAX package's `_interp_matrix` and
    `_adaptive_pool_matrix` (cast to f32);
  * forced on the CPU, the matrix backward equals PyTorch's own gradient
    and the float64 one within f32 rounding (in bf16 the float64 one within
    a bf16 ulp), keeps channels-last, and the forward is PyTorch's own, bit
    for bit;
  * on the CPU the ops keep PyTorch's own backward;
  * on the card (marked `cuda`, skipped here): the ops route through the
    matrix backward and two backwards give the same bits.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from graphecho_torch.ops import resize


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of a thread per core oversubscribes the machine
    (tens of times slower under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (in, out) sizes of one axis: the FPN's merges and head, the TGCN's pools
# (the camus 4x4 level pooled up to the 8x8 grid among them), edges
SIZES = [(8, 16), (16, 32), (28, 112), (64, 256), (7, 13), (13, 7), (1, 5), (5, 1), (4, 8),
         (32, 8), (9, 4)]


@pytest.mark.parametrize("n_in,n_out", SIZES)
def test_the_matrices_equal_the_jax_package(n_in, n_out):
    from graphecho_tpu.ops.resize import _adaptive_pool_matrix, _interp_matrix

    np.testing.assert_array_equal(resize.bilinear_align_corners_matrix(n_out, n_in).numpy(),
                                  _interp_matrix(n_out, n_in).astype(np.float32))
    np.testing.assert_array_equal(resize.adaptive_pool_matrix(n_out, n_in).numpy(),
                                  _adaptive_pool_matrix(n_in, n_out).T.astype(np.float32))


def _forced(op, x, out_hw):
    """The op through its matrix backward, on any device."""
    h, w = x.shape[-2:]
    if op == "resize":
        return resize._SeparableMap.apply(
            x, lambda t: F.interpolate(t, size=out_hw, mode="bilinear", align_corners=True),
            resize.bilinear_align_corners_matrix(out_hw[0], h, x.device),
            resize.bilinear_align_corners_matrix(out_hw[1], w, x.device))
    return resize._SeparableMap.apply(
        x, lambda t: F.adaptive_avg_pool2d(t, out_hw),
        resize.adaptive_pool_matrix(out_hw[0], h, x.device),
        resize.adaptive_pool_matrix(out_hw[1], w, x.device))


def _torch_op(op, x, out_hw):
    if op == "resize":
        return F.interpolate(x, size=out_hw, mode="bilinear", align_corners=True)
    return F.adaptive_avg_pool2d(x, out_hw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("op", ["resize", "pool"])
@pytest.mark.parametrize("shape,out_hw", [((2, 3, 8, 8), (16, 16)), ((1, 4, 16, 12), (64, 48)),
                                          ((3, 2, 7, 13), (13, 7)), ((2, 5, 4, 4), (8, 8)),
                                          ((2, 3, 9, 9), (1, 4))])
def test_the_matrix_backward_equals_torch_on_the_cpu(op, shape, out_hw, channels_last, dtype):
    gen = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    g = torch.randn(*shape[:2], *out_hw, generator=gen).to(dtype)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya, yb = _forced(op, xa, out_hw), _torch_op(op, xb, out_hw)
    assert torch.equal(ya, yb)
    ya.backward(g)
    yb.backward(g)
    assert xa.grad.dtype == dtype
    assert xa.grad.is_contiguous(memory_format=torch.channels_last) == channels_last
    # the exact gradient of the same inputs, in float64
    x64 = x.double().requires_grad_()
    _torch_op(op, x64, out_hw).backward(g.double())
    if dtype == torch.float32:
        torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(xa.grad.double(), x64.grad, rtol=1e-5, atol=1e-6)
    else:  # f32 sums rounded once to bf16: within one bf16 ulp of the exact gradient
        torch.testing.assert_close(xa.grad.double(), x64.grad, rtol=2 ** -8, atol=1e-6)


def test_on_the_cpu_the_ops_keep_torch_backward():
    x = torch.randn(1, 2, 4, 4, requires_grad=True)
    assert "Upsample" in type(resize.resize_bilinear_align_corners(x, 8, 8).grad_fn).__name__
    assert "AdaptiveAvgPool" in type(resize.adaptive_avg_pool2d(x, 8, 8).grad_fn).__name__


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
@pytest.mark.parametrize("op", ["resize", "pool"])
def test_on_the_card_the_backward_is_the_matrices_and_repeats_bit_for_bit(op):
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(8, 256, 32, 32, device="cuda", generator=gen)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    fn = resize.resize_bilinear_align_corners if op == "resize" else resize.adaptive_avg_pool2d
    out_hw = (64, 64) if op == "resize" else (8, 8)
    y = fn(x, *out_hw)
    assert type(y.grad_fn).__name__ == "_SeparableMapBackward"
    assert torch.equal(y, _torch_op(op, x.detach(), out_hw))
    g = torch.randn(y.shape, device="cuda", generator=gen)
    grads = [torch.autograd.grad(fn(x, *out_hw), x, g)[0] for _ in range(3)]
    assert all(torch.equal(grads[0], other) for other in grads[1:])
    want = torch.autograd.grad(_torch_op(op, x, out_hw), x, g)[0]
    torch.testing.assert_close(grads[0], want, rtol=1e-5, atol=1e-5)
