"""int8 PTQ of the port (`graphecho_torch/quant/ptq.py`) against the JAX
package's (`graphecho_tpu/quant/ptq.py`), on the CPU.

The flax FPN's variables are shaped with `jax.eval_shape`, filled from a
numpy seed and given BatchNorm statistics off their defaults (as
`tests/test_quant.py::_trained_ish_fpn` perturbs them); the port FPN loads
the same weights through `convert.from_flax`. Sizes: a VGG16 with the
paper's conv counts (2,2,3,3,3) at widths 8-32 and 64², and the ResNet50
quirk at full width at 32², batch 2, with 32-channel heads.

  * On the JAX package's own int8 weights and scales, carried over by
    `convert.qparams_from_flax`: the first layer's int32 accumulators equal
    `lax.conv_general_dilated(..., preferred_element_type=int32)` bit for
    bit, the five feature levels are within a relative mean error of 1e-3
    of JAX's `qb(x)`, and the masks equal `make_quantized_infer`'s on at
    least 99.9% of pixels.
  * With the port's own calibration on the same weights and batches: each
    `in_scale` within rtol 1e-5 of JAX's, the int8 weights equal but for
    +-1 at rounding ties in under 0.01% of entries, the BN fold equal to
    `fold_bn`'s bit for bit, and the int8 masks agree with the float FPN's
    on more than 98% of pixels (`tests/test_quant.py`'s bar).
  * The plain int8 conv (float64) equals `torch._int_mm`'s route bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphecho_tpu.models.fpn import FPN as JaxFPN
from graphecho_tpu.quant import quantize_fpn_backbone as jax_quantize
from graphecho_tpu.quant.ptq import _DN
from graphecho_tpu.quant.ptq import _q as jax_q
from graphecho_tpu.quant.ptq import fold_bn as jax_fold_bn
from graphecho_tpu.quant.ptq import make_quantized_infer as jax_make_infer

from test_torch_pairwise_mlp import report_parity

from graphecho_torch.convert import from_flax, qparams_from_flax
from graphecho_torch.models.fpn import FPN
from graphecho_torch.quant import fold_bn, make_quantized_infer, quantize_fpn_backbone
from graphecho_torch.quant.ptq import QuantizedBackbone, int8_conv_mm, int8_conv_plain

FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
VGG_SPEC = ((8, 2), (16, 2), (16, 3), (32, 3), (32, 3))
BACKBONES = {
    "vgg": (dict(back_bone="VGG16", num_classes=5, fpn_channels=32, semantic_channels=16,
                 vgg_spec=VGG_SPEC), 64),
    "resnet": (dict(back_bone="resnet", num_classes=1, fpn_channels=32,
                    semantic_channels=16), 32),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of a thread per core oversubscribes the machine
    (tens of times slower under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def flax_fpn_variables(kw, hw, seed=0):
    """The JAX FPN of `kw` and variables for it: the tree shaped with
    `jax.eval_shape` (no `init`), kernels He-normal and norm affines near 1
    and 0 from a numpy seed, BatchNorm stats moved off 0 and 1. Residual
    branches are damped (bn3 scale 0.2, as a zero-init-residual scheme does):
    a random ResNet50 grows its activations a hundredfold otherwise."""
    jm = JaxFPN(**kw)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, hw, hw, 1))))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.randn(*s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            x = 1 + 0.1 * np.abs(rng.randn(*s.shape))
            if name == "scale" and path[-2].key == "bn3":
                x *= 0.2
            return x.astype(np.float32)
        return (0.05 * rng.randn(*s.shape)).astype(np.float32)  # bias, mean

    return jm, jax.tree_util.tree_map_with_path(fill, shapes)


def port_fpn(kw, variables, dtype=None):
    model = FPN(**kw, dtype=dtype)
    model.load_state_dict(from_flax({"net_params": variables["params"],
                                     "net_batch_stats": variables["batch_stats"]})["fpn"])
    return model.eval()


def frames(n, hw, seed):
    return np.random.RandomState(seed).rand(n, hw, hw, 1).astype(np.float32)


def nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def built():
    """Each backbone's JAX model, variables, calibration batches, JAX int8
    backbone and port FPN, built once for the file."""
    cache = {}

    def get(name):
        if name not in cache:
            kw, hw = BACKBONES[name]
            jm, variables = flax_fpn_variables(kw, hw)
            calib = [frames(2, hw, 10 + i) for i in range(2)]
            jqb = jax_quantize(kw["back_bone"], variables, calib)
            cache[name] = kw, hw, jm, variables, calib, jqb, port_fpn(kw, variables)
        return cache[name]

    return get


@pytest.fixture(params=sorted(BACKBONES))
def setup(request, built):
    return built(request.param)


def _rel_mean_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).mean() / (np.abs(want).mean() + 1e-12)


def _port_qb_on_jax_qparams(model, jqb):
    qb = QuantizedBackbone(model.back_bone)
    qb.load_qparams(qparams_from_flax(jax.tree_util.tree_map(np.asarray, jqb.qparams())))
    return qb


def test_int8_accumulators_and_levels_on_the_jax_qparams(setup):
    kw, hw, _, _, _, jqb, model = setup
    x = frames(2, hw, 3)
    qb = _port_qb_on_jax_qparams(model, jqb)
    first = "block1_conv1" if kw["back_bone"] == "VGG16" else "conv1"
    lyr = jqb.layers[first]
    want = jax.lax.conv_general_dilated(jax_q(x, lyr.in_scale), lyr.wq, lyr.strides,
                                        lyr.padding, dimension_numbers=_DN,
                                        preferred_element_type=jnp.int32)
    accs = {}
    with torch.no_grad():
        feats = qb(nchw(x), tap=lambda name, x8, acc: accs.setdefault(name, acc))
    got = accs[qb.names[0]]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i, (ft, fj) in enumerate(zip(feats, jqb(x))):
        err = _rel_mean_err(ft.permute(0, 2, 3, 1).numpy(), fj)
        print(f"PARITY int8 {kw['back_bone']} level {i + 1} rel_mean_err={err:.3g}")
        assert err < 1e-3, (i, err)


def test_int8_masks_on_the_jax_qparams(built):
    """The VGG16 case (the ResNet50 runs in the tests above only, to keep
    the file's compile time down)."""
    kw, hw, jm, variables, _, jqb, model = built("vgg")
    x = frames(2, hw, 3)
    # called as returned, op by op: under jit XLA fuses the quantisation and
    # the dequantisation, which moves int8 values at rounding ties, so the
    # jitted function can differ from its own eager run
    want = np.asarray(jax_make_infer(jm, jqb)({"params": variables["params"]},
                                              jqb.qparams(), x))
    with torch.no_grad():
        got = make_quantized_infer(model, _port_qb_on_jax_qparams(model, jqb))(
            torch.from_numpy(x)).numpy()
    agree = (got == want).mean()
    print(f"PARITY int8 {kw['back_bone']} masks agreement={agree:.6f}")
    assert got.dtype == np.int8 and got.shape == want.shape
    assert agree >= 0.999, agree


def test_port_calibration_matches_jax(setup):
    kw, hw, jm, variables, calib, jqb, model = setup
    qb = quantize_fpn_backbone(model, [nchw(b) for b in calib])
    jq = qparams_from_flax(jax.tree_util.tree_map(np.asarray, jqb.qparams()))
    assert set(qb.names) == set(jq)
    tie, total, worst = 0, 0, 0.0
    for name, p in qb.qparams().items():
        np.testing.assert_allclose(p["in_scale"].item(), jq[name]["in_scale"].item(),
                                   rtol=1e-5, err_msg=name)
        worst = max(worst, abs(p["in_scale"].item() / jq[name]["in_scale"].item() - 1))
        d = (p["wq"].int() - jq[name]["wq"].int()).abs()
        assert d.max() <= 1, name
        tie, total = tie + int((d > 0).sum()), total + d.numel()
        np.testing.assert_array_equal(p["w_scale"].numpy(), jq[name]["w_scale"].numpy())
        np.testing.assert_array_equal(p["bias"].numpy(), jq[name]["bias"].numpy())
    print(f"PARITY int8 {kw['back_bone']} in_scale max_rel_err={worst:.3g} "
          f"wq_off_by_one={tie}/{total}")
    assert tie / total < 1e-4

    x = frames(2, hw, 4)
    with torch.no_grad():
        masks_q = make_quantized_infer(model, qb)(torch.from_numpy(x)).numpy()
        logits, _ = model(nchw(x))
    masks_f = (torch.sigmoid(logits) > 0.5).to(torch.int8).permute(0, 2, 3, 1).numpy()
    agree = (masks_q == masks_f).mean()
    print(f"PARITY int8 {kw['back_bone']} port-calibrated vs float agreement={agree:.6f}")
    assert agree > 0.98, agree


def test_bn_fold_equals_jax():
    rng = np.random.RandomState(5)
    o, i = 24, 8
    kernel = rng.randn(3, 3, i, o).astype(np.float32)
    bias = rng.randn(o).astype(np.float32)
    gamma, beta, mean = (rng.randn(o).astype(np.float32) for _ in range(3))
    var = (0.5 + rng.rand(o)).astype(np.float32)
    for b in (bias, None):
        wj, bj = jax_fold_bn(kernel, b, gamma, beta, mean, var)
        wt, bt = fold_bn(torch.from_numpy(kernel.transpose(3, 2, 0, 1)),
                         None if b is None else torch.from_numpy(b),
                         *map(torch.from_numpy, (gamma, beta, mean, var)))
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))


@pytest.mark.parametrize("b,h,c,o,k,stride,pad", [
    (2, 9, 5, 16, 3, 1, 1),   # K = 45: padded to 48
    (2, 9, 5, 16, 3, 2, 1),   # the Bottleneck's strided conv2
    (1, 7, 8, 12, 1, 2, 0),   # conv_down; N = 12 padded to 16; M = 16 rows
    (1, 16, 1, 8, 7, 2, 3),   # the ResNet stem, K = 49
    (3, 6, 24, 40, 3, 1, 1),  # a multiple of 8 everywhere
], ids=["k45", "stride2", "conv_down", "stem", "aligned"])
def test_plain_int8_conv_equals_int_mm(b, h, c, o, k, stride, pad):
    gen = torch.Generator().manual_seed(b * 100 + h)
    x8 = torch.randint(-127, 128, (b, h, h + 1, c), dtype=torch.int8, generator=gen)
    wq = torch.randint(-127, 128, (o, c, k, k), dtype=torch.int8, generator=gen)
    plain = int8_conv_plain(x8, wq, (stride, stride), (pad, pad))
    mm = int8_conv_mm(x8, wq, (stride, stride), (pad, pad))
    assert plain.dtype == mm.dtype == torch.int32
    assert torch.equal(plain, mm)
    # the int32 accumulators of the extreme values stay exact in float64
    full = torch.full_like(x8, -127)
    assert torch.equal(int8_conv_plain(full, wq.clamp(min=-127), (1, 1), (0, 0)),
                       int8_conv_mm(full, wq.clamp(min=-127), (1, 1), (0, 0)))
