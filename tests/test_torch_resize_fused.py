"""The resize's dispatch in `graphecho_torch/ops/resize.py` on the CPU, where
the kernel of `csrc/resize.cu` never runs (its card tests are
`tests/test_torch_resize_card.py`):

  * the CPU path is PyTorch's: `F.interpolate` and its own backward, and
    `upsample_add` is that resize followed by `+`, building, loading and
    launching nothing;
  * the fused `upsample_add` Function (`_SeparableMap` with an addend),
    forced on the CPU with a plain forward, gives resize-then-add's bits,
    hands g to the addend and gives x the matrix backward's bits, in f32 and
    bf16;
  * the output's memory format is the one `F.interpolate` gives, for NCHW,
    channels-last, strided and ambiguous (one channel, 1 x 1) inputs;
  * the kernel's wrapper refuses a dtype the kernel lacks.
"""

import pytest
import torch
import torch.nn.functional as F
from torch._prims_common import suggest_memory_format

from graphecho_torch.ops import cuda_build, resize


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def no_build(monkeypatch):
    """Any build or load of a CUDA source fails the test."""
    def refuse(name, *args, **kwargs):
        raise AssertionError(f"csrc/{name}.cu built or loaded for a CPU tensor")

    monkeypatch.setattr(cuda_build, "build", refuse)
    monkeypatch.setattr(cuda_build, "load", refuse)


# the FPN's merge ratios at small widths, an odd pair, a downsizing
SHAPES = [((2, 3, 4, 4), (7, 7)), ((2, 3, 8, 8), (16, 16)), ((1, 4, 7, 13), (13, 7)),
          ((3, 2, 9, 9), (4, 5))]
DTYPES = [pytest.param(torch.float32, id="f32"), pytest.param(torch.bfloat16, id="bf16")]


def _inputs(shape, out_hw, dtype):
    gen = torch.Generator().manual_seed(sum(shape) + sum(out_hw))
    x = torch.randn(shape, generator=gen).to(dtype)
    y = torch.randn(*shape[:2], *out_hw, generator=gen).to(dtype)
    g = torch.randn(*shape[:2], *out_hw, generator=gen).to(dtype)
    return x, y, g


def _plain(t, out_hw, addend=None):
    out = F.interpolate(t, size=out_hw, mode="bilinear", align_corners=True)
    return out if addend is None else out + addend


def _matrices(x, out_hw):
    h, w = x.shape[-2:]
    return (resize.bilinear_align_corners_matrix(out_hw[0], h),
            resize.bilinear_align_corners_matrix(out_hw[1], w))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,out_hw", SHAPES)
def test_on_the_cpu_the_resize_and_its_add_are_pytorchs(shape, out_hw, dtype, no_build):
    x, y, g = _inputs(shape, out_hw, dtype)
    resize.reset_launch_counts()
    xa, ya = x.clone().requires_grad_(), y.clone().requires_grad_()
    xb, yb = x.clone().requires_grad_(), y.clone().requires_grad_()
    out = resize.upsample_add(xa, ya)
    assert type(out.grad_fn).__name__ == "AddBackward0"
    assert "Upsample" in type(resize.resize_bilinear_align_corners(xa, *out_hw).grad_fn).__name__
    want = _plain(xb, out_hw, yb)
    assert torch.equal(out, want)
    assert torch.equal(resize.resize_bilinear_align_corners(x, *out_hw), _plain(x, out_hw))
    out.backward(g)
    want.backward(g)
    assert torch.equal(xa.grad, xb.grad) and torch.equal(ya.grad, yb.grad)
    assert resize.LAUNCHES["resize"] == 0
    assert not resize._kernel_takes(x)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,out_hw", SHAPES)
def test_the_fused_function_gives_resize_then_add_and_both_gradients(shape, out_hw, dtype):
    x, y, g = _inputs(shape, out_hw, dtype)
    rows, cols = _matrices(x, out_hw)
    xa, ya = x.clone().requires_grad_(), y.clone().requires_grad_()
    fused = resize._SeparableMap.apply(xa, lambda t, a: _plain(t, out_hw, a), rows, cols, ya)
    assert type(fused.grad_fn).__name__ == "_SeparableMapBackward"
    assert torch.equal(fused, _plain(x, out_hw, y))
    fused.backward(g)
    # the addend's gradient is g itself, as `+` gives it
    assert ya.grad.dtype == dtype and torch.equal(ya.grad, g)
    # x's is the resize's matrix backward, bit for bit
    xb = x.clone().requires_grad_()
    resize._SeparableMap.apply(xb, lambda t: _plain(t, out_hw), rows, cols).backward(g)
    assert xa.grad.dtype == dtype and torch.equal(xa.grad, xb.grad)
    # and PyTorch's own gradient of resize-then-add within f32 rounding
    xc = x.float().requires_grad_()
    _plain(xc, out_hw, y.float()).backward(g.float())
    rtol = 1e-5 if dtype == torch.float32 else 2 ** -8  # f32 sums rounded once to bf16
    torch.testing.assert_close(xa.grad.float(), xc.grad, rtol=rtol, atol=1e-6)


def test_the_fused_function_gives_no_gradient_to_an_input_that_needs_none():
    x, y, g = _inputs((2, 3, 4, 4), (7, 7), torch.float32)
    rows, cols = _matrices(x, (7, 7))
    ya = y.clone().requires_grad_()
    fused = resize._SeparableMap.apply(x, lambda t, a: _plain(t, (7, 7), a), rows, cols, ya)
    fused.backward(g)
    assert x.grad is None and torch.equal(ya.grad, g)


CL = torch.channels_last
# (a name, the input) of each kind of layout
LAYOUT_INPUTS = [
    ("nchw", lambda: torch.randn(2, 8, 4, 4)),
    ("channels_last", lambda: torch.randn(2, 8, 4, 4).contiguous(memory_format=CL)),
    ("strided_nchw", lambda: torch.randn(2, 16, 4, 4)[:, ::2]),
    ("strided_channels_last", lambda: torch.randn(2, 16, 4, 4).contiguous(memory_format=CL)[:, ::2]),
    ("one_channel_channels_last", lambda: torch.empty_strided((2, 1, 4, 4), (16, 1, 4, 1)).normal_()),
    ("one_by_one_channels_last", lambda: torch.empty_strided((2, 8, 1, 1), (8, 1, 8, 8)).normal_()),
]


@pytest.mark.parametrize("make", [pytest.param(m, id=name) for name, m in LAYOUT_INPUTS])
def test_the_output_takes_the_memory_format_f_interpolate_gives(make):
    x = make()
    want = suggest_memory_format(_plain(x, (7, 7)))
    assert resize._channels_last(x) == (want == torch.channels_last)


def test_the_kernels_wrapper_refuses_what_the_kernel_does_not_take(no_build):
    x, y, _ = _inputs((2, 3, 4, 4), (7, 7), torch.float32)
    for t in (x.half(), x.double()):
        with pytest.raises(TypeError, match=f"float32 or bfloat16, not {t.dtype}"):
            resize._launch(t, 7, 7, y)
    assert resize.LAUNCHES["resize"] == 0
