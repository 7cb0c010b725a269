"""FPN segmenter of the port against the JAX package, on the CPU.

The port's FPN is initialized from a seed, its state dict goes through the
JAX package's own importer (`graphecho_tpu/utils/torch_import.py`) into flax
variables, and `graphecho_torch.convert.from_flax` brings those back: the
round trip must return the original state dict bit for bit. The flax
variables then drive the JAX FPN and, converted, a fresh port FPN: logits and
the four pre-smooth taps agree within 1e-3 (the bound the JAX suite holds its
own torch re-runs to) in eval and in train mode, and one train-mode forward
leaves the same BatchNorm running statistics (flax folds in the BIASED batch
variance, momentum 0.9).
"""

import jax
import numpy as np
import pytest
import torch

from graphecho_tpu.models.fpn import FPN as JaxFPN
from graphecho_tpu.utils.torch_import import fpn_params_from_torch

from test_torch_pairwise_mlp import report_parity

from graphecho_torch.convert import from_flax
from graphecho_torch.models.backbones import BatchNorm2d, Bottleneck
from graphecho_torch.models.fpn import FPN
from graphecho_torch.models.initializers import initialize


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of a thread per core oversubscribes the machine
    (tens of times slower under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TINY_VGG = ((8, 1), (16, 2), (16, 1), (32, 1), (32, 1))
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
BACKBONES = {
    "resnet": dict(back_bone="resnet", num_classes=1, fpn_channels=32, semantic_channels=16),
    "vgg": dict(back_bone="VGG16", num_classes=3, fpn_channels=32, semantic_channels=16,
                vgg_spec=TINY_VGG),
}


def _port_fpn(kw, x, seed=0):
    """A port FPN from a seed, with its norms moved off their defaults so that
    every converted leaf matters. Residual branches are damped (bn3 scale
    ~0.2, as a zero-init-residual scheme does) and the BatchNorm running
    stats are calibrated on a batch like `x`: a ResNet50 of raw random
    weights grows its activations a hundredfold, and f32 noise with them."""
    model = FPN(**kw)
    gen = torch.Generator().manual_seed(seed)
    initialize(model, gen)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (BatchNorm2d, torch.nn.GroupNorm)):
                mod.weight.copy_(1 + 0.1 * torch.randn(mod.weight.shape, generator=gen))
                mod.bias.copy_(0.1 * torch.randn(mod.bias.shape, generator=gen))
        for mod in model.modules():
            if isinstance(mod, Bottleneck):
                mod.bn3.weight.mul_(0.2)
        for bn in bns:
            bn.momentum = 1.0
        calib = torch.rand((x.shape[0], 1) + x.shape[1:3], generator=gen)
        model.train()(calib)
        for bn in bns:
            bn.momentum = 0.1
            bn.running_var.mul_(1 + 0.2 * torch.rand(bn.running_var.shape, generator=gen))
    return model


def _flax_variables(kw, model, x):
    """The port model's weights as flax variables, via the JAX importer."""
    jm = JaxFPN(**kw)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    params, stats, skipped = fpn_params_from_torch(sd, zeros["params"], zeros["batch_stats"])
    assert not skipped, skipped[:5]
    return jm, {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module", params=sorted(BACKBONES))
def setup(request):
    kw = BACKBONES[request.param]
    x = np.random.RandomState(3).rand(2, 64, 64, 1).astype(np.float32)
    model = _port_fpn(kw, x)
    jm, variables = _flax_variables(kw, model, x)
    return kw, x, model, jm, variables


def test_converter_round_trip(setup):
    kw, _, model, _, variables = setup
    back = from_flax({"net_params": variables["params"],
                      "net_batch_stats": variables["batch_stats"]})["fpn"]
    want = model.state_dict()
    assert set(back) == set(want)
    for k, v in want.items():
        assert torch.equal(back[k], v), k


def _port_from_flax(kw, variables):
    model = FPN(**kw)
    model.load_state_dict(from_flax({"net_params": variables["params"],
                                     "net_batch_stats": variables["batch_stats"]})["fpn"])
    return model


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_and_taps_match_jax(setup, train):
    kw, x, _, jm, variables = setup

    def apply(v, x):
        if train:
            return jm.apply(v, x, train=True, mutable=["batch_stats"])
        return jm.apply(v, x, train=False), None

    (logits_j, feats_j), mut = jax.jit(apply, compiler_options=FAST_COMPILE)(variables, x)
    model = _port_from_flax(kw, variables).train(train)
    with torch.no_grad():
        logits_t, feats_t = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    mode = f"FPN {kw['back_bone']} {'train' if train else 'eval'}"
    report_parity(f"{mode} logits", logits_t.permute(0, 2, 3, 1).numpy(), logits_j)
    for i, (ft, fj) in enumerate(zip(feats_t, feats_j)):
        report_parity(f"{mode} tap p{i + 2}", ft.permute(0, 2, 3, 1).numpy(), fj)
    np.testing.assert_allclose(logits_t.permute(0, 2, 3, 1).numpy(), np.asarray(logits_j),
                               atol=1e-3)
    for ft, fj in zip(feats_t, feats_j):
        np.testing.assert_allclose(ft.permute(0, 2, 3, 1).numpy(), np.asarray(fj), atol=1e-3)
    if train:
        # running stats after one train forward: mean and BIASED variance
        got = from_flax({"net_params": variables["params"],
                         "net_batch_stats": mut["batch_stats"]})["fpn"]
        for k, v in model.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                report_parity(f"{mode} BN {k}", v.numpy(), got[k].numpy())
                np.testing.assert_allclose(v.numpy(), got[k].numpy(), rtol=1e-4, atol=1e-5,
                                           err_msg=k)
