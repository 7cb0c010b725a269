"""ViG/DeepGCN of the port against the JAX package, on the CPU.

The flax variables are shaped with `jax.eval_shape` (never `init`), filled
from a numpy seed, and carried into the port by
`graphecho_torch.convert.vig_state_dict`. Both packages then run in f32 on
the same inputs: the graph convs within atol 1e-5, the Grapher's
relative-position buffer (bicubic `F.interpolate` here, the JAX package's
torch-exact resize matrices there) within atol 1e-5, and a tiny DeepGCN that
reaches dilation 2 at its last Grapher within rtol 1e-4 / atol 1e-5 for
eval and train logits and the updated BatchNorm statistics, and rtol 1e-3 /
atol 1e-5 for the gradient of the summed train-mode logits with respect to
every parameter (compared in float64, see that test). Full-width pvig_s is
checked without running it: the port has the JAX package's 27,251,912
parameters under the converted names.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from graphecho_tpu.models import tgcn_cells as jcells
from graphecho_tpu.models import vig as jvig
from graphecho_tpu.ops.knn import dense_knn as jax_dense_knn

from test_torch_pairwise_mlp import report_parity

from graphecho_torch.convert import from_flax, module_state_dict, vig_state_dict
from graphecho_torch.models import tgcn_cells as tcells
from graphecho_torch.models import vig as tvig


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of a thread per core oversubscribes the machine
    (tens of times slower under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
TINY = dict(blocks=(1, 1, 2, 1), channels=(8, 16, 24, 32), k=2, n_classes=10, img_size=64)
PVIG_S_PARAMS = 27_251_912
KEY = jax.random.PRNGKey(0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _fill(shapes, seed):
    """Numpy leaves for a flax shape tree: kernels N(0, 1/fan_in), BatchNorm
    scales near 1 and variances in [0.5, 1.5], everything else small."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            out = rng.randn(*s.shape) / math.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            out = 1 + 0.1 * rng.randn(*s.shape)
        elif name == "var":
            out = 0.5 + rng.rand(*s.shape)
        else:
            out = 0.1 * rng.randn(*s.shape)
        return np.asarray(out, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _flax_variables(module, *args, seed=0):
    shapes = jax.eval_shape(lambda: module.init(KEY, *args))
    return {"params": _fill(shapes["params"], seed),
            "batch_stats": _fill(shapes.get("batch_stats", {}), seed + 1)}


# ----------------------------------------------------------- embeddings
@pytest.mark.parametrize("channels,n,n_reduced", [(16, 64, 16), (24, 16, 16), (80, 196, 49)])
def test_relative_pos_buffer_matches_jax(channels, n, n_reduced):
    np.testing.assert_array_equal(tvig.get_2d_sincos_pos_embed(channels, 4),
                                  jvig.get_2d_sincos_pos_embed(channels, 4))
    got = tvig.relative_pos_buffer(channels, n, n_reduced, torch.device("cpu"))
    want = jvig._relative_pos_const(channels, n, n_reduced)
    assert got.shape == (1, n, n_reduced)
    report_parity(f"relative_pos ({channels}, {n}, {n_reduced})", got[0].numpy(), want)
    np.testing.assert_allclose(got[0].numpy(), want, atol=1e-5)


# ----------------------------------------------------------- graph convs
@pytest.mark.parametrize("with_y", [False, True], ids=["self", "xy"])
@pytest.mark.parametrize("conv", ["mr", "edge", "sage", "gin"])
def test_graph_convs_match_jax(conv, with_y):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 10, 8).astype(np.float32)
    y = rng.randn(2, 6, 8).astype(np.float32) if with_y else None
    idx = np.asarray(jax_dense_knn(jnp.asarray(x), None if y is None else jnp.asarray(y), 3))
    jm = jvig.GraphConv(12, conv, "gelu", "batch")
    variables = _flax_variables(jm, x, idx, y, seed=4)
    want = jm.apply(variables, x, idx, y)
    tm = tvig.GraphConv(8, 12, conv, "gelu", "batch")
    tm.load_state_dict(vig_state_dict(variables["params"], variables["batch_stats"]))
    with torch.no_grad():
        got = tm.eval()(_t(x), _t(idx), None if y is None else _t(y))
    assert got.shape == (2, 12, 10)
    report_parity(f"graph conv {conv} {'xy' if with_y else 'self'}",
                  got.transpose(1, 2).numpy(), want)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want), atol=1e-5)


def test_grouped_conv_kernel_converts_to_the_torch_layout():
    x = np.random.RandomState(5).randn(2, 7, 8).astype(np.float32)
    conv = fnn.Conv(12, (1,), feature_group_count=4)
    params = _flax_variables(conv, x, seed=6)["params"]
    want = conv.apply({"params": params}, x)
    sd = module_state_dict({"conv": params})
    assert params["kernel"].shape == (1, 2, 12) and sd["conv.weight"].shape == (12, 2, 1)
    c1 = torch.nn.Conv1d(8, 12, 1, groups=4)
    c1.load_state_dict({"weight": sd["conv.weight"], "bias": sd["conv.bias"]})
    c2 = torch.nn.Conv2d(8, 12, 1, groups=4)
    c2.load_state_dict({"weight": sd["conv.weight"][..., None], "bias": sd["conv.bias"]})
    with torch.no_grad():
        got1 = c1(_t(x).transpose(1, 2)).transpose(1, 2)
        got2 = c2(_t(x).transpose(1, 2)[..., None])[..., 0].transpose(1, 2)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want), atol=1e-6)


# ----------------------------------------------------------- the tiny model
@pytest.fixture(scope="module")
def tiny():
    jm = jvig.DeepGCN(**TINY)
    x = np.random.RandomState(7).rand(4, 64, 64, 3).astype(np.float32)
    variables = _flax_variables(jm, x, seed=8)
    return jm, x, variables


def _port_model(variables):
    model = tvig.DeepGCN(**TINY)
    model.load_state_dict(from_flax({"vig_params": variables["params"],
                                     "vig_batch_stats": variables["batch_stats"]})["vig"])
    return model


def _flax_leaf_from_torch(path, sd):
    """The flax leaf at `path` rebuilt from the port's state dict."""
    names = [p.key for p in path]
    prefix, name = ".".join(names[:-1]), names[-1]
    key = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
           "var": "running_var"}.get(name, name)
    value = sd[f"{prefix}.{key}" if prefix else key].numpy()
    if name == "kernel":
        value = value.transpose(2, 3, 1, 0) if value.ndim == 4 else value.transpose(2, 1, 0)
    elif name == "pos_embed":
        value = value.transpose(0, 2, 3, 1)
    return value


def test_tiny_converter_round_trips(tiny):
    _, _, variables = tiny
    model = _port_model(variables)
    sd = model.state_dict()
    for tree in (variables["params"], variables["batch_stats"]):
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        for path, leaf in leaves:
            np.testing.assert_array_equal(_flax_leaf_from_torch(path, sd), leaf,
                                          err_msg=jax.tree_util.keystr(path))
    n_leaves = sum(len(jax.tree_util.tree_leaves(t)) for t in variables.values())
    assert n_leaves == len(sd)


def test_tiny_deepgcn_eval_matches_jax(tiny):
    jm, x, variables = tiny
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False),
                   compiler_options=FAST_COMPILE)(variables, x)
    model = _port_model(variables).eval()
    with torch.no_grad():
        got = model(_t(x).permute(0, 3, 1, 2))
    assert got.shape == (4, 10)
    report_parity("DeepGCN tiny eval logits", got.numpy(), want)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def _train_apply(jm):
    def apply(params, stats, x):
        logits, mut = jm.apply({"params": params, "batch_stats": stats}, x, train=True,
                               mutable=["batch_stats"])
        return jnp.sum(logits), (logits, mut["batch_stats"])
    return apply


def test_tiny_deepgcn_train_forward_and_stats_match_jax(tiny):
    jm, x, variables = tiny
    _, (logits_j, stats_j) = jax.jit(_train_apply(jm), compiler_options=FAST_COMPILE)(
        variables["params"], variables["batch_stats"], x)
    model = _port_model(variables).train()
    with torch.no_grad():
        logits = model(_t(x).permute(0, 3, 1, 2))
    report_parity("DeepGCN tiny train logits", logits.numpy(), logits_j)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), rtol=1e-4, atol=1e-5)

    want_stats = vig_state_dict({}, jax.tree_util.tree_map(np.asarray, stats_j))
    got_stats = {k: v for k, v in model.state_dict().items() if k.endswith(("_mean", "_var"))}
    assert set(got_stats) == set(want_stats)
    worst = max(np.max(np.abs(got_stats[k].numpy() - want_stats[k].numpy())) for k in want_stats)
    print(f"PARITY DeepGCN tiny BN running stats max_abs_err={worst:.3g}")
    for k, want in want_stats.items():
        np.testing.assert_allclose(got_stats[k].numpy(), want.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_tiny_deepgcn_train_grads_match_jax(tiny):
    """d(sum of train-mode logits)/d(every parameter), both packages in
    float64. In float32 this gradient is ill-conditioned: it runs back through
    32 train-mode BatchNorms, the last over a batch of 4, whose backward
    subtracts nearly equal terms. Against a float64 run of the port, both
    packages' float32 gradients stray past the bound on a few entries (the
    JAX package more, as flax takes the batch variance as E[x^2] - E[x]^2):
    rounding, not a difference of algorithm. In float64 the two agree far
    inside the bound."""
    jm, x, variables = tiny
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        grads_j = jax.jit(jax.grad(_train_apply(jm), has_aux=True),
                          compiler_options=FAST_COMPILE)(
            v64["params"], v64["batch_stats"], x.astype(np.float64))[0]
        grads_j = jax.tree_util.tree_map(np.asarray, grads_j)
    model = _port_model(variables).double().train()
    model(torch.from_numpy(x.astype(np.float64)).permute(0, 3, 1, 2)).sum().backward()

    want_grads = vig_state_dict(grads_j, {})
    got_grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(got_grads) == set(want_grads)
    worst = max(np.max(np.abs(got_grads[k].numpy() - want_grads[k].numpy())) for k in want_grads)
    print(f"PARITY DeepGCN tiny grads (float64) max_abs_err={worst:.3g}")
    for k, want in want_grads.items():
        np.testing.assert_allclose(got_grads[k].numpy(), want.numpy(), rtol=1e-3, atol=1e-5,
                                   err_msg=k)


def test_tiny_deepgcn_reaches_dilation_two():
    model = tvig.DeepGCN(**TINY)
    dilations = [getattr(model, f"grapher_{i}").graph_conv.dilation for i in range(5)]
    assert dilations == [1, 1, 1, 1, 2]


# ----------------------------------------------------------- full width
def test_pvig_s_has_the_jax_parameters_under_the_converted_names():
    jm = jvig.pvig_s()
    shapes = jax.eval_shape(lambda: jm.init(KEY, jnp.zeros((1, 224, 224, 3))))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    converted = vig_state_dict(zeros["params"], zeros["batch_stats"])
    model = tvig.pvig_s(device="cpu")
    sd = model.state_dict()
    assert set(sd) == set(converted)
    for k, v in converted.items():
        assert sd[k].shape == v.shape, k
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert n_jax == PVIG_S_PARAMS
    assert sum(p.numel() for p in model.parameters()) == PVIG_S_PARAMS
    assert len(model.state_dict()) == len(converted)


def test_factories_resolve_the_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tvig.pvig_ti()


# ----------------------------------------------------------- TGCN cells
def test_tgcn_cells_match_jax():
    rng = np.random.RandomState(10)
    x = rng.rand(2, 6, 6).astype(np.float32)
    np.testing.assert_allclose(tcells.laplacian_with_self_loop(_t(x)).numpy(),
                               np.asarray(jcells.laplacian_with_self_loop(jnp.asarray(x))),
                               atol=1e-6)
    for normalize in (False, True):
        np.testing.assert_allclose(
            tcells.laplacian_without_self_loop(_t(x[0]), normalize).numpy(),
            np.asarray(jcells.laplacian_without_self_loop(jnp.asarray(x[0]), normalize)),
            atol=1e-6)

    inputs = rng.rand(2, 6, 6).astype(np.float32)
    hidden = rng.rand(2, 24).astype(np.float32)
    jm = jcells.TGCNCell(input_dim=6, hidden_dim=4)
    params = _flax_variables(jm, inputs, hidden, seed=11)["params"]
    want, _ = jm.apply({"params": params}, inputs, hidden)
    tm = tcells.TGCNCell(6, 4)
    tm.load_state_dict(module_state_dict(params))
    with torch.no_grad():
        got, got_h = tm(_t(inputs), _t(hidden))
    report_parity("TGCNCell", got.numpy(), want)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert torch.equal(got, got_h)
