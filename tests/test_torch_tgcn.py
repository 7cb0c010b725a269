"""The temporal slice's modules against the JAX package, on the CPU: the
adaptive pool, the Sinkhorn distance, the cycle loss, the TGCN, and the
backbones' remat.

Flax variables are shaped with `jax.eval_shape` (never `init`), filled from a
numpy seed and carried into the port by `graphecho_torch.convert.from_flax`.
Both packages run in f32 on the same inputs. Tolerances: the pool 1e-6
(absolute), `sinkhorn_distance` and `seg_cycle` rtol 1e-5 (the cycle loss
with JAX's start index given to the port), the TGCN's losses, new queues and
new BatchNorm statistics rtol 1e-4, its parameter gradients rtol 1e-3 against
`jax.grad` (both in float64, see that test). The TGCN's dropouts (rate 0.1, hard-coded upstream) draw from
different generators in the two packages, so the parity tests make both the
identity; `test_tgcn_dropout_keeps_nine_in_ten` holds the port's dropout on
its own. Remat is held to no remat: the same losses, gradients and running
statistics.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from graphecho_tpu.config import TGCNConfig as JTGCNConfig
from graphecho_tpu.models.tgcn import TGCN as JTGCN
from graphecho_tpu.ops.resize import adaptive_avg_pool2d as jax_pool
from graphecho_tpu.ops.sinkhorn import sinkhorn_distance as jax_sinkhorn_distance
from graphecho_tpu.train.cycle import seg_cycle as jax_seg_cycle

from test_torch_pairwise_mlp import report_parity
from test_torch_vig import _fill

from graphecho_torch import config as tconfig
from graphecho_torch.convert import from_flax
from graphecho_torch.models import attention
from graphecho_torch.models.fpn import FPN
from graphecho_torch.models.initializers import initialize
from graphecho_torch.models.tgcn import TGCN
from graphecho_torch.ops.resize import adaptive_avg_pool2d
from graphecho_torch.ops.sinkhorn import sinkhorn_distance
from graphecho_torch.train import cycle


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of a thread per core oversubscribes the machine
    (tens of times slower under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LEVELS = (16, 8, 4, 2)  # pooled onto the 4x4 grid: down by 4 and 2, equal, up by 2
B, T, C, K_QUEUE = 4, 2, 32, 6
N_NODES = 10


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------------ small ops
@pytest.mark.parametrize("size", [16, 7, 4])
def test_adaptive_avg_pool_matches_jax(size):
    x = np.random.RandomState(size).randn(3, size, size, 5).astype(np.float32)
    want = np.asarray(jax_pool(jnp.asarray(x), (8, 8)))
    got = adaptive_avg_pool2d(_t(x).permute(0, 3, 1, 2), 8, 8).permute(0, 2, 3, 1).numpy()
    report_parity(f"adaptive_avg_pool2d {size}->8", got, want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("reduction", ["none", "mean"])
def test_sinkhorn_distance_matches_jax(reduction):
    rng = np.random.RandomState(3)
    x, y = rng.randn(2, 5, 4).astype(np.float32), rng.randn(2, 6, 4).astype(np.float32)
    want = jax_sinkhorn_distance(jnp.asarray(x), jnp.asarray(y), 0.1, 5, reduction)
    got = sinkhorn_distance(_t(x), _t(y), 0.1, 5, reduction)
    for name, g, w in zip(("cost", "pi", "C"), got, want):
        report_parity(f"sinkhorn_distance {reduction} {name}", g.numpy(), w)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seg_cycle_matches_jax_with_its_start(seed):
    feats = np.random.RandomState(seed).randn(64, 32).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    start = jax.random.randint(key, (), 0, cycle.n_starts())
    want = float(jax_seg_cycle(jnp.asarray(feats), key))
    got = float(cycle.seg_cycle(_t(feats), torch.tensor(int(start))))
    report_parity(f"seg_cycle seed {seed}", got, want)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    with pytest.raises(AssertionError, match="clip_length"):
        cycle.seg_cycle(_t(feats[:21]), torch.tensor(0))


def test_draw_starts_covers_every_start():
    gen = torch.Generator().manual_seed(0)
    starts = cycle.draw_starts(gen, 2000)
    assert starts.shape == (2000,) and set(starts.tolist()) == set(range(cycle.n_starts()))


# ----------------------------------------------------------------------- TGCN
def _identity_dropout(monkeypatch):
    """Both packages' dropouts become the identity (they cannot share a random
    stream), inside the calling test only."""
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(attention, "dropout", lambda x, *a, **k: x)


def _tgcn_inputs(seed=4):
    rng = np.random.RandomState(seed)
    clips = [rng.randn(B, T, s, s, C).astype(np.float32) for s in LEVELS]
    nodes = [rng.randn(N_NODES, C).astype(np.float32) for _ in range(2)]
    valid = [np.array([True] * 8 + [False] * 2), np.ones(N_NODES, bool)]
    queues = [rng.randn(C, K_QUEUE).astype(np.float32) for _ in range(2)]
    queues = [q / np.linalg.norm(q, axis=0, keepdims=True) for q in queues]
    # a repeated label in each domain: two EMA steps on one column
    idx = (np.array([3, 3], np.int32), np.array([1, 4], np.int32))
    return clips, nodes, valid, queues, idx


def _jax_args(clips, nodes, valid, queues, idx):
    j = jnp.asarray
    return ([j(c) for c in clips], j(nodes[0]), j(valid[0]), j(nodes[1]), j(valid[1]),
            (j(queues[0]), j(queues[1])), (j(idx[0]), j(idx[1])))


def _port_args(clips, nodes, valid, queues, idx):
    return ([_t(c).permute(0, 1, 4, 2, 3) for c in clips], _t(nodes[0]), _t(valid[0]),
            _t(nodes[1]), _t(valid[1]), (_t(queues[0]), _t(queues[1])),
            (_t(idx[0]), _t(idx[1])))


def _tgcn_cfg(cluster, transport):
    return JTGCNConfig(input_dim=C, hidden_dim=C, clip_shape=(T, 4, 4), knn_k=3,
                       cluster_method=cluster, transport_method=transport,
                       queue_size=K_QUEUE, pool_ratios=(4, 2, 1, 1),
                       source_class=5, target_class=5)


def _close(what, got, want, rtol, scale_atol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    report_parity(what, got, want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=scale_atol * float(np.abs(want).max()), err_msg=what)


def _port_tgcn(jcfg, params, stats):
    port = TGCN(dataclasses.replace(tconfig.TGCNConfig(), **dataclasses.asdict(jcfg)))
    port.load_state_dict(from_flax({"tgcn_params": params, "tgcn_batch_stats": stats})["tgcn"])
    return port


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype == np.float32 else a, tree)


@pytest.mark.parametrize("transport", ["node_discriminate", "sinkhorn_distance"])
@pytest.mark.parametrize("cluster", [None, "momentum_queue", "linear_clustering"])
def test_tgcn_matches_jax(cluster, transport, monkeypatch):
    """Train mode. In float32: losses, new queues (a repeated label composes
    two EMA steps) and new BatchNorm statistics within rtol 1e-4. Every
    parameter gradient within rtol 1e-3 of `jax.grad`, both packages in
    float64: in float32 the Sinkhorn transport (eps 0.1) amplifies rounding
    past 1e-3 at small entries, in the port and in JAX alike. A conv bias in
    front of a train-mode BatchNorm has a gradient of 0 up to rounding: the
    atol is 1e-5 of the module's largest gradient entry."""
    _identity_dropout(monkeypatch)
    jcfg = _tgcn_cfg(cluster, transport)
    jm = JTGCN(jcfg)
    inputs = _tgcn_inputs()
    jargs = _jax_args(*inputs)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                             "dropout": jax.random.PRNGKey(1)}, *jargs))
    params = _fill(shapes["params"], 7)
    stats = _fill(shapes["batch_stats"], 8)

    (jlosses, jqueues), mut = jm.apply({"params": params, "batch_stats": stats}, *jargs,
                                       train=True, mutable=["batch_stats"])
    port = _port_tgcn(jcfg, params, stats).train()
    with torch.no_grad():
        losses, queues = port(*_port_args(*inputs))
    assert set(losses) == set(jlosses)
    for k, v in losses.items():
        _close(f"tgcn {cluster}/{transport} {k}", v.item(), float(jlosses[k]), 1e-4)
    for name, q, jq, q0 in zip(("source", "target"), queues, jqueues, inputs[3]):
        _close(f"tgcn {cluster} queue_{name}", q.numpy(), jq, 1e-4, 1e-6)
        moved = np.abs(q.numpy() - q0).max(axis=0) > 0
        want_moved = np.isin(np.arange(K_QUEUE), inputs[4][name == "target"])
        assert (moved == want_moved).all() if cluster == "momentum_queue" else not moved.any()
    want = from_flax({"tgcn_params": params, "tgcn_batch_stats": mut["batch_stats"]})["tgcn"]
    got = port.state_dict()
    for k in ("mlp_bn.running_mean", "mlp_bn.running_var", "pred_bn.running_mean",
              "pred_bn.running_var"):
        _close(f"tgcn {k}", got[k].numpy(), want[k].numpy(), 1e-4, 1e-6)

    with jax.enable_x64(True):
        stats64, jargs64 = _f64(stats), _jax_args(*_f64(inputs))

        def loss_fn(p):
            (out, _), _ = jm.apply({"params": p, "batch_stats": stats64}, *jargs64,
                                   train=True, mutable=["batch_stats"])
            return sum(out.values())

        grads = jax.tree_util.tree_map(np.asarray, jax.grad(loss_fn)(_f64(params)))
    want_grads = from_flax({"tgcn_params": grads, "tgcn_batch_stats": stats})["tgcn"]
    port = _port_tgcn(jcfg, params, stats).double().train()
    args = _port_args(*_f64(inputs))
    sum(port(*args)[0].values()).backward()
    named = dict(port.named_parameters())
    assert set(named) == {k for k in want_grads if "running" not in k}
    atol = 1e-5 * max(float(want_grads[k].abs().max()) for k in named)
    for k, p in named.items():
        what = f"tgcn {cluster}/{transport} grad {k} (float64)"
        # no loss reads the head without clustering: no gradient here, zeros in JAX
        got = (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
        report_parity(what, got, want_grads[k].numpy())
        np.testing.assert_allclose(got, want_grads[k].numpy(), rtol=1e-3, atol=atol,
                                   err_msg=what)


def test_tgcn_camus_grid_pools_4_up_to_8(monkeypatch):
    """The camus 112^2 pyramid (28/14/7/4) onto the 8x8 grid, eval mode."""
    _identity_dropout(monkeypatch)
    jcfg = dataclasses.replace(_tgcn_cfg(None, "node_discriminate"), clip_shape=(2, 8, 8))
    rng = np.random.RandomState(9)
    clips = [rng.randn(2, 2, s, s, C).astype(np.float32) for s in (28, 14, 7, 4)]
    nodes = [rng.randn(N_NODES, C).astype(np.float32) for _ in range(2)]
    inputs = (clips, nodes, [np.ones(N_NODES, bool)] * 2,
              [np.zeros((C, K_QUEUE), np.float32)] * 2,
              (np.array([0], np.int32), np.array([1], np.int32)))
    jm = JTGCN(jcfg)
    jargs = _jax_args(*inputs)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                             "dropout": jax.random.PRNGKey(1)}, *jargs))
    params, stats = _fill(shapes["params"], 3), _fill(shapes["batch_stats"], 4)
    (jlosses, _), _ = jm.apply({"params": params, "batch_stats": stats}, *jargs, train=False,
                               mutable=["batch_stats"])
    with torch.no_grad():
        losses, _ = _port_tgcn(jcfg, params, stats).eval()(*_port_args(*inputs))
    _close("tgcn camus grid node_dis_loss", float(losses["node_dis_loss"]),
           float(jlosses["node_dis_loss"]), 1e-4)


def test_tgcn_dropout_keeps_nine_in_ten(monkeypatch):
    """Every dropout of the TGCN runs at rate 0.1 in train mode from the
    generator it is given: about 9 in 10 entries kept, each scaled by 1/0.9,
    and the same generator seed gives the same losses; none runs in eval mode."""
    calls = []
    real = attention.dropout

    def spy(x, p, train, generator=None):
        out = real(x, p, train, generator)
        calls.append((p, train, x.detach(), out.detach()))
        return out

    monkeypatch.setattr(attention, "dropout", spy)
    cfg = dataclasses.replace(tconfig.TGCNConfig(), **dataclasses.asdict(
        _tgcn_cfg(None, "node_discriminate")))
    port = initialize(TGCN(cfg), torch.Generator().manual_seed(0)).train()
    args = _port_args(*_tgcn_inputs())
    losses = [port(*args, generator=torch.Generator().manual_seed(s))[0]["node_dis_loss"]
              for s in (5, 5)]
    assert losses[0].item() == losses[1].item()
    # per forward: T mlp dropouts, the head's, and the attention's two
    assert len(calls) == 2 * (T + 3)
    kept = total = 0
    for p, train, x, out in calls:
        assert p == 0.1 and train
        keep = out != 0
        torch.testing.assert_close(out[keep], x[keep] / 0.9, rtol=1e-6, atol=0)
        # masked attention weights are 0 before the dropout: count the others
        kept, total = kept + int(keep.sum()), total + int((x != 0).sum())
    assert abs(kept / total - 0.9) < 0.01, kept / total
    calls.clear()
    port.eval()(*args)
    assert calls and all(not train for _, train, _, _ in calls)


# ---------------------------------------------------------------------- remat
@pytest.mark.parametrize("backbone", ["VGG16", "resnet"])
def test_remat_changes_nothing(backbone):
    """The FPN with and without per-block checkpointing from one set of
    weights: equal losses, gradients and running statistics (which move once
    per forward, not again in the recompute)."""
    kw = dict(num_classes=2, back_bone=backbone, fpn_channels=16, semantic_channels=8,
              vgg_spec=((8, 1), (16, 1), (16, 1), (32, 1), (32, 1)))
    x = torch.from_numpy(np.random.RandomState(2).rand(2, 1, 64, 64).astype(np.float32))
    runs = []
    for remat in (False, True):
        fpn = FPN(**kw, remat=remat)
        initialize(fpn, torch.Generator().manual_seed(1))
        fpn.train()
        logits, feats = fpn(x)
        loss = logits.square().mean() + sum(f.mean() for f in feats)
        loss.backward()
        runs.append((loss.item(), {k: p.grad.clone() for k, p in fpn.named_parameters()},
                     {k: v.clone() for k, v in fpn.state_dict().items() if "running" in k}))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert l0 == l1
    assert g0.keys() == g1.keys() and s0.keys() == s1.keys()
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-8, msg=k)
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], rtol=0, atol=0, msg=k)
    # the stats did move (from zeros and ones), once: one forward's momentum
    fresh = FPN(**kw).state_dict()
    assert all(s0[k].ne(fresh[k]).any() for k in s0)
