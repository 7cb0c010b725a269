"""The CUDA align-corners bilinear resize (`csrc/resize.cu`) against
`F.interpolate` on a GPU; every test skips without one. This file imports no
JAX, so it runs on a card where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_resize_card.py

  * bit for bit equal to `F.interpolate(..., align_corners=True)` and, with
    the addend, to `F.interpolate(...) + y`, in f32 and bf16, NCHW and
    channels-last, at every resize of the FPN's head in the camus (112²) and
    cardiac (256²) cells at 8, 64 and 168 frames, at edge sizes (1 -> n,
    n -> 1, odd, one axis kept, downsizing) and past 2^30 output elements
    (64-bit indexing);
  * the output in the memory format `F.interpolate` (and its add) gives it,
    also for an addend in the other layout and a strided input;
  * two launches give the same bits, each call is one launch, kept sizes
    launch nothing, and float16 and float64 tensors are refused;
  * through autograd, the resize keeps the matrix backward
    (`_SeparableMapBackward`) with its bits, and the fused add hands g to
    its addend;
  * a graph traced by `torch.export` keeps `F.interpolate` and launches
    nothing;
  * a small FPN forward, NCHW and channels-last, gives the same bits with
    and without the kernel, in 7 launches.
"""

import pytest
import torch
import torch.nn.functional as F

from graphecho_torch.ops import resize

pytestmark = pytest.mark.cuda

# (input side, output side, channels, with the addend) of every resize an
# FPN call makes: the three top-down merges (256 channels, fused add), the
# head's p5 and p4 paths (256), its p3 path onto s2 (128, fused add) and the
# 4x logits (the recipe's classes)
CAMUS = [(4, 7, 256, True), (7, 14, 256, True), (14, 28, 256, True), (4, 28, 256, False),
         (7, 28, 256, False), (14, 28, 128, True), (28, 112, 1, False)]
CARDIAC = [(8, 16, 256, True), (16, 32, 256, True), (32, 64, 256, True), (8, 64, 256, False),
           (16, 64, 256, False), (32, 64, 128, True), (64, 256, 5, False)]
HEAD = [pytest.param(*case, id=f"{cell}-{case[0]}to{case[1]}x{case[2]}{'+y' if case[3] else ''}")
        for cell, cases in (("camus", CAMUS), ("cardiac", CARDIAC)) for case in cases]
DTYPES = [pytest.param(torch.float32, id="f32"), pytest.param(torch.bfloat16, id="bf16")]
LAYOUTS = [pytest.param(torch.contiguous_format, id="nchw"),
           pytest.param(torch.channels_last, id="channels_last")]
# (in (h, w), out (h, w)) at the edges of the index rules
EDGES = [((1, 1), (5, 7)), ((5, 7), (1, 1)), ((1, 6), (4, 1)), ((7, 13), (13, 7)),
         ((3, 5), (3, 11)), ((6, 4), (17, 4)), ((32, 32), (8, 8)), ((2, 2), (255, 129))]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the resize kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(card, shape, out_hw, dtype, seed, layout=torch.contiguous_format):
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn(shape, device=card, generator=gen).to(dtype)
    y = torch.randn(*shape[:2], *out_hw, device=card, generator=gen).to(dtype)
    return x.contiguous(memory_format=layout), y.contiguous(memory_format=layout)


def _library(x, out_hw, y=None):
    out = F.interpolate(x, size=out_hw, mode="bilinear", align_corners=True)
    return out if y is None else out + y


def _kernel(x, out_hw, y=None):
    """The port's resize (plus `y`) with no autograd: the kernel alone."""
    with torch.no_grad():
        if y is None:
            return resize.resize_bilinear_align_corners(x, *out_hw)
        return resize.upsample_add(x, y)


def _strides(t):
    """The strides of the dims longer than 1: the layout in memory."""
    return [s for s, n in zip(t.stride(), t.shape) if n > 1]


def _assert_bits(got, want):
    """Equal values, dtype, shape and layout in memory."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _strides(got) == _strides(want), f"strides {got.stride()}, want {want.stride()}"
    diff = (got.float() - want.float()).abs()
    assert torch.equal(got, want), f"{int((diff > 0).sum())} elements differ, largest {diff.max()}"


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("frames", [8, 64, 168])
@pytest.mark.parametrize("n_in,n_out,channels,add", HEAD)
def test_the_head_resizes_equal_f_interpolate_bit_for_bit(card, n_in, n_out, channels, add,
                                                        frames, dtype, layout):
    x, y = _inputs(card, (frames, channels, n_in, n_in), (n_out, n_out), dtype,
                   n_in * 1000 + n_out + frames, layout)
    addend = y if add else None
    resize.reset_launch_counts()
    got = _kernel(x, (n_out, n_out), addend)
    assert resize.LAUNCHES["resize"] == 1
    _assert_bits(got, _library(x, (n_out, n_out), addend))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("add", [False, True], ids=["resize", "resize+y"])
@pytest.mark.parametrize("in_hw,out_hw", EDGES, ids=[f"{a}to{b}" for a, b in EDGES])
def test_edge_sizes_equal_f_interpolate_bit_for_bit(card, in_hw, out_hw, add, dtype, layout):
    x, y = _inputs(card, (3, 20, *in_hw), out_hw, dtype, sum(in_hw) * 100 + sum(out_hw), layout)
    addend = y if add else None
    resize.reset_launch_counts()
    _assert_bits(_kernel(x, out_hw, addend), _library(x, out_hw, addend))
    assert resize.LAUNCHES["resize"] == 1


def test_past_two_to_the_thirty_elements_the_index_is_64_bit(card):
    x, _ = _inputs(card, (64, 1, 6, 5), (1, 1), torch.bfloat16, 7)
    out_hw = (4100, 4097)  # 64 x 4100 x 4097 > 2^30 outputs
    _assert_bits(_kernel(x, out_hw), _library(x, out_hw))


@pytest.mark.parametrize("dtype", DTYPES)
def test_two_launches_give_the_same_bits(card, dtype):
    x, y = _inputs(card, (64, 256, 32, 32), (64, 64), dtype, 11)
    for layout in (torch.contiguous_format, torch.channels_last):
        xl, yl = x.contiguous(memory_format=layout), y.contiguous(memory_format=layout)
        for addend in (None, yl):
            first = _kernel(xl, (64, 64), addend)
            assert torch.equal(first, _kernel(xl, (64, 64), addend))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_each_call_is_one_launch(card, grad, dtype):
    x, y = _inputs(card, (8, 256, 16, 16), (32, 32), dtype, 12)
    x.requires_grad_(grad)
    resize.reset_launch_counts()
    out = resize.resize_bilinear_align_corners(x, 32, 32)
    assert resize.LAUNCHES["resize"] == 1
    _assert_bits(out.detach(), _library(x.detach(), (32, 32)))
    summed = resize.upsample_add(x, y)
    assert resize.LAUNCHES["resize"] == 2
    _assert_bits(summed.detach(), _library(x.detach(), (32, 32), y))
    # kept sizes launch nothing
    assert resize.resize_bilinear_align_corners(x, 16, 16) is x
    assert resize.LAUNCHES["resize"] == 2


def _forced(x, out_hw):
    """The resize through the matrix backward with PyTorch's forward."""
    h, w = x.shape[-2:]
    return resize._SeparableMap.apply(
        x, lambda t: F.interpolate(t, size=out_hw, mode="bilinear", align_corners=True),
        resize.bilinear_align_corners_matrix(out_hw[0], h, x.device),
        resize.bilinear_align_corners_matrix(out_hw[1], w, x.device))


@pytest.mark.parametrize("dtype", DTYPES)
def test_the_gradients_are_the_matrix_backward(card, dtype):
    x, y = _inputs(card, (8, 256, 16, 16), (32, 32), dtype, 13)
    g = torch.randn(8, 256, 32, 32, device=card).to(dtype)
    x.requires_grad_()
    want_x = torch.autograd.grad(_forced(x, (32, 32)), x, g)[0]

    out = resize.resize_bilinear_align_corners(x, 32, 32)
    assert type(out.grad_fn).__name__ == "_SeparableMapBackward"
    _assert_bits(torch.autograd.grad(out, x, g)[0], want_x)

    y.requires_grad_()
    summed = resize.upsample_add(x, y)
    assert type(summed.grad_fn).__name__ == "_SeparableMapBackward"
    grad_x, grad_y = torch.autograd.grad(summed, (x, y), g)
    _assert_bits(grad_x, want_x)
    _assert_bits(grad_y, g)
    # only the addend needs a gradient: x gets none, the addend still g
    summed = resize.upsample_add(x.detach(), y)
    _assert_bits(torch.autograd.grad(summed, y, g)[0], g)


MIXED = [pytest.param(torch.channels_last, torch.contiguous_format, id="x_cl-y_nchw"),
         pytest.param(torch.contiguous_format, torch.channels_last, id="x_nchw-y_cl")]


@pytest.mark.parametrize("x_layout,y_layout", MIXED)
def test_an_addend_in_the_other_layout_gives_the_adds_bits_and_layout(card, x_layout, y_layout):
    x, y = _inputs(card, (8, 256, 16, 16), (32, 32), torch.float32, 14)
    x, y = x.contiguous(memory_format=x_layout), y.contiguous(memory_format=y_layout)
    resize.reset_launch_counts()
    _assert_bits(_kernel(x, (32, 32), y), _library(x, (32, 32), y))
    assert resize.LAUNCHES["resize"] == 1


@pytest.mark.parametrize("layout", LAYOUTS)
def test_a_strided_input_gives_f_interpolates_bits_and_layout(card, layout):
    x, y = _inputs(card, (8, 64, 16, 16), (32, 32), torch.float32, 16, layout)
    x, y = x[:, ::2], y[:, :32]  # every other channel: dense in neither layout
    assert not x.is_contiguous() and not x.is_contiguous(memory_format=torch.channels_last)
    for addend in (None, y):
        _assert_bits(_kernel(x, (32, 32), addend), _library(x, (32, 32), addend))


def test_a_channels_last_input_keeps_the_matrix_backward(card):
    x, _ = _inputs(card, (8, 256, 32, 32), (64, 64), torch.float32, 17, torch.channels_last)
    x.requires_grad_()
    resize.reset_launch_counts()
    out = resize.resize_bilinear_align_corners(x, 64, 64)
    assert resize.LAUNCHES["resize"] == 1
    assert type(out.grad_fn).__name__ == "_SeparableMapBackward"
    _assert_bits(out.detach(), _library(x.detach(), (64, 64)))
    g = torch.randn(out.shape, device=card).contiguous(memory_format=torch.channels_last)
    want = torch.autograd.grad(_forced(x, (64, 64)), x, g)[0]
    _assert_bits(torch.autograd.grad(out, x, g)[0], want)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64], ids=["f16", "f64"])
def test_other_dtypes_on_the_card_are_refused(card, dtype):
    x, y = _inputs(card, (2, 4, 8, 8), (16, 16), dtype, 18)
    resize.reset_launch_counts()
    with pytest.raises(TypeError, match=f"float32 or bfloat16, not {dtype}"):
        resize.resize_bilinear_align_corners(x, 16, 16)
    with pytest.raises(TypeError, match=f"not {dtype}"):
        resize.upsample_add(x, y)
    assert resize.LAUNCHES["resize"] == 0


class _Merge(torch.nn.Module):
    def forward(self, x, y):
        return resize.resize_bilinear_align_corners(resize.upsample_add(x, y), 64, 64)


def test_a_graph_traced_for_export_keeps_f_interpolate(card):
    x, y = _inputs(card, (2, 8, 8, 8), (16, 16), torch.float32, 15)
    resize.reset_launch_counts()
    with torch.no_grad():
        program = torch.export.export(_Merge(), (x, y))
    assert resize.LAUNCHES["resize"] == 0
    assert "upsample_bilinear2d" in str(program.graph)
    with torch.no_grad():
        _assert_bits(program.module()(x, y), _Merge()(x, y))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_an_fpn_forward_gives_the_same_bits_with_and_without_the_kernel(card, dtype, layout,
                                                                        monkeypatch):
    from graphecho_torch.models.fpn import FPN

    torch.manual_seed(0)
    fpn = FPN(num_classes=5, back_bone="VGG16", fpn_channels=32, semantic_channels=16,
              vgg_spec=((8, 1), (16, 1), (16, 1), (32, 1), (32, 1)),
              dtype=None if dtype == torch.float32 else dtype).to(card).eval()
    fpn = fpn.to(memory_format=layout)
    x = torch.randn(4, 1, 64, 64, device=card).contiguous(memory_format=layout)
    with torch.no_grad():
        resize.reset_launch_counts()
        logits, feats = fpn(x)
        assert resize.LAUNCHES["resize"] == 7  # 3 merges, 3 head resizes, the logits
        monkeypatch.setattr(resize, "_kernel_takes", lambda *args: False)
        want_logits, want_feats = fpn(x)
    assert resize.LAUNCHES["resize"] == 7
    _assert_bits(logits, want_logits)
    for got, want in zip(feats, want_feats):
        _assert_bits(got, want)
