"""Graph head of the port against the JAX package, on the CPU.

Losses, metrics, gradient reversal, FCOS node sampling (slot for slot),
attention, affinity, Sinkhorn, the spectral seed clustering and the whole
GModule run on the same numpy inputs through `graphecho_tpu` and
`graphecho_torch`, with the flax parameters carried over by
`graphecho_torch.convert`. Tolerances: 1e-5 for the elementwise losses, 1e-4
for single modules, 1e-3 for the GModule losses and seed banks (a 20-round
Sinkhorn and two attention blocks in f32), exact for node slots, labels and
validity masks.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphecho_tpu.config import GModuleConfig, NodeSamplerConfig
from graphecho_tpu.models import GModule as JaxGModule
from graphecho_tpu.models.affinity import Affinity as JaxAffinity
from graphecho_tpu.models.attention import CrossGraph as JaxCrossGraph
from graphecho_tpu.models.attention import MultiHeadAttention as JaxMHA
from graphecho_tpu.ops import grl as jgrl
from graphecho_tpu.ops import sampling as jsampling
from graphecho_tpu.ops import sinkhorn as jsinkhorn
from graphecho_tpu.ops import spectral as jspectral
from graphecho_tpu.train import losses as jlosses
from graphecho_tpu.train import metrics as jmetrics

from test_torch_pairwise_mlp import report_parity

from graphecho_torch import config as tconfig
from graphecho_torch.convert import module_state_dict
from graphecho_torch.models.affinity import Affinity
from graphecho_torch.models.attention import CrossGraph, MultiHeadAttention
from graphecho_torch.models.graph_matching import GModule
from graphecho_torch.ops import grl as tgrl
from graphecho_torch.ops import sampling as tsampling
from graphecho_torch.ops import sinkhorn as tsinkhorn
from graphecho_torch.ops import spectral as tspectral
from graphecho_torch.train import losses as tlosses
from graphecho_torch.train import metrics as tmetrics

# cheap XLA:CPU compiles: the JAX side runs each reference function as one
# program instead of op by op
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _jit(fn, **static):
    return jax.jit(functools.partial(fn, **static), compiler_options=FAST_COMPILE)


def _t(x):
    return torch.from_numpy(np.array(x))


def _nchw(x):
    return _t(x).permute(0, 3, 1, 2)


def _random_params(shapes, seed, scale=0.2):
    """Random numpy leaves for a tree of jax.ShapeDtypeStructs."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: np.asarray(rng.randn(*s.shape) * scale, np.float32), shapes)


def _port_cfg(cfg):
    """A graphecho_tpu config dataclass -> its graphecho_torch twin."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, GModuleConfig):
        fields["sampler"] = _port_cfg(cfg.sampler)
        return tconfig.GModuleConfig(**fields)
    return tconfig.NodeSamplerConfig(**fields)


# ------------------------------------------------------------------ losses
def test_losses_and_metrics_match_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 8, 8, 3).astype(np.float32) * 2
    target = (rng.rand(2, 8, 8, 3) > 0.5).astype(np.float32)
    weight = rng.rand(2, 8, 8, 3).astype(np.float32)
    p = rng.rand(40).astype(np.float32)
    pt = (rng.rand(40) > 0.5).astype(np.float32)
    mask = rng.rand(40) > 0.3
    ce_logits = rng.randn(40, 4).astype(np.float32)
    labels = rng.randint(0, 5, 40).astype(np.int32)  # 4 is out of range
    cases = [
        (jlosses.dice_loss(logits, target), tlosses.dice_loss(_nchw(logits), _nchw(target))),
        (jlosses.binary_dice_loss(p.reshape(4, 10), pt.reshape(4, 10)),
         tlosses.binary_dice_loss(_t(p).reshape(4, 10), _t(pt).reshape(4, 10))),
        (jlosses.bce_with_logits(logits, target), tlosses.bce_with_logits(_t(logits), _t(target))),
        (jlosses.bce_with_logits(logits, target, weight=weight),
         tlosses.bce_with_logits(_t(logits), _t(target), weight=_t(weight))),
        (jlosses.bce_focal_loss_probs(p, pt, mask=mask),
         tlosses.bce_focal_loss_probs(_t(p), _t(pt), mask=_t(mask))),
        (jlosses.focal_loss_logits(logits, target),
         tlosses.focal_loss_logits(_t(logits), _t(target))),
        (jlosses.cross_entropy(ce_logits, labels, weight=p, mask=mask),
         tlosses.cross_entropy(_t(ce_logits), _t(labels), weight=_t(p), mask=_t(mask))),
    ]
    for i, (want, got) in enumerate(cases):
        report_parity(f"loss case {i}", float(got), float(want))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6, err_msg=i)
    pred = jmetrics.binarize_logits(logits)
    np.testing.assert_array_equal(tmetrics.binarize_logits(_t(logits)).numpy(), np.asarray(pred))
    want = jmetrics.calculate_overlap_metrics(target, pred)
    got = tmetrics.calculate_overlap_metrics(_t(target), _t(pred))
    np.testing.assert_allclose([float(x) for x in got], [float(x) for x in want], rtol=1e-6)


def test_gradient_reversal_matches_jax():
    x = np.random.RandomState(1).randn(5, 3).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jgrl.gradient_reversal(v, 0.02) * jax.lax.stop_gradient(v)))(x)
    tx = _t(x).requires_grad_()
    (tgrl.gradient_reversal(tx, 0.02) * tx.detach()).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_array_equal(tgrl.gradient_reversal(_t(x), 0.5).detach().numpy(), x)


# ---------------------------------------------------------------- sampling
def test_masks_to_boxes_and_fcos_labels_match_jax():
    rng = np.random.RandomState(2)
    masks = np.zeros((3, 40, 48, 3), np.float32)
    masks[0, 5:20, 7:30, 0] = 1
    masks[1, 10:38, 2:11, 1] = 1
    masks[2] = rng.rand(40, 48, 3) > 0.97  # scattered; channel sets may be empty
    masks[2, ..., 2] = 0  # an empty channel -> the full-image box
    want = np.asarray(jsampling.masks_to_boxes(masks))
    got = tsampling.masks_to_boxes(_nchw(masks))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[2, 2] == [0, 0, 48, 40]).all()

    locs_j = jsampling.compute_locations([(10, 12), (5, 6)], [8, 16])
    locs_t = tsampling.compute_locations([(10, 12), (5, 6)], [8, 16])
    for lj, lt in zip(locs_j, locs_t):
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    for soi in ((-1.0, 64.0), (64.0, 128.0)):
        np.testing.assert_array_equal(
            tsampling.fcos_labels(locs_t[0], _t(want), soi).numpy(),
            np.asarray(jsampling.fcos_labels(locs_j[0], want, soi)))


@pytest.mark.parametrize("pos_budget", [16, 100])
def test_sample_nodes_slot_for_slot(pos_budget):
    rng = np.random.RandomState(4)
    cfg = NodeSamplerConfig(pos_budget_per_level=pos_budget)
    feats = [rng.randn(2, s, s, 8).astype(np.float32) for s in (16, 8, 4, 2)]
    masks = np.zeros((2, 64, 64, 3), np.float32)
    masks[:, 10:50, 10:50, 0] = 1
    masks[:, 20:40, 20:30, 1] = 1
    masks[1, 30:60, 4:60, 2] = 1
    boxes = np.asarray(jsampling.masks_to_boxes(masks))
    want = _jit(jsampling.sample_nodes, cfg=cfg)(feats, boxes)
    got = tsampling.sample_nodes([_nchw(f) for f in feats], _t(boxes), _port_cfg(cfg))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))
    np.testing.assert_array_equal(got.weights.numpy(), np.asarray(want.weights))
    assert np.asarray(want.valid).sum() > 10


# ------------------------------------------------------ attention/affinity
def _init_shapes(module, *args, **kwargs):
    return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))["params"]


@pytest.mark.parametrize("heads", [1, 2])
def test_attention_matches_jax(heads):
    rng = np.random.RandomState(5)
    k, q = rng.randn(12, 16).astype(np.float32), rng.randn(9, 16).astype(np.float32)
    key_mask = np.arange(12) < 10
    jm = JaxMHA(16, heads)
    params = _random_params(_init_shapes(jm, k, k, q, key_mask=key_mask), seed=heads)
    out_j, attn_j = jm.apply({"params": params}, k, k, q, key_mask=key_mask)
    tm = MultiHeadAttention(16, heads)
    tm.load_state_dict(module_state_dict(params))
    out_t, attn_t = tm(_t(k), _t(k), _t(q), key_mask=_t(key_mask))
    report_parity(f"MultiHeadAttention heads={heads}", out_t.detach().numpy(), out_j)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=1e-4)
    np.testing.assert_allclose(attn_t.detach().numpy(), np.asarray(attn_j), atol=1e-5)

    jc = JaxCrossGraph(16)
    cparams = _random_params(_init_shapes(jc, k, q), seed=7)
    want = jc.apply({"params": cparams}, k, q)
    tc = CrossGraph(16)
    tc.load_state_dict(module_state_dict(cparams))
    for g, w in zip(tc(_t(k), _t(q)), want):
        report_parity("CrossGraph", g.detach().numpy(), w)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-4)


def test_affinity_matches_jax():
    rng = np.random.RandomState(6)
    x, y = rng.randn(20, 16).astype(np.float32), rng.randn(13, 16).astype(np.float32)
    ja = JaxAffinity(16)
    params = _random_params(_init_shapes(ja, x, y), seed=8)
    want = ja.apply({"params": params}, x, y)
    ta = Affinity(16)
    ta.load_state_dict(module_state_dict(params))
    report_parity("Affinity", ta(_t(x), _t(y)).detach().numpy(), want)
    np.testing.assert_allclose(ta(_t(x), _t(y)).detach().numpy(), np.asarray(want), atol=1e-4)


def test_sinkhorn_rpm_matches_jax():
    rng = np.random.RandomState(7)
    la = rng.randn(2, 9, 7).astype(np.float32)
    rm, cm = rng.rand(2, 9) > 0.2, rng.rand(2, 7) > 0.2
    for kw in ({"slack": True}, {"slack": False},
               {"slack": True, "row_mask": rm, "col_mask": cm}):
        want = jsinkhorn.sinkhorn_rpm(la, n_iters=20, **kw)
        got = tsinkhorn.sinkhorn_rpm(_t(la), n_iters=20,
                                     **{k: (_t(v) if k.endswith("mask") else v)
                                        for k, v in kw.items()})
        report_parity(f"sinkhorn_rpm {sorted(kw)}", got.numpy(), want)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# ---------------------------------------------------------------- spectral
def _same_partition(a, b, valid):
    m = (a[valid] == b[valid]).mean()
    return max(m, 1 - m) == 1.0 and (a[~valid] == b[~valid]).all()


@pytest.mark.parametrize("solver", ["eigh", "lanczos"])
def test_spectral_bipartition_and_quality_match_jax(solver):
    rng = np.random.RandomState(11)
    bipartition = _jit(jspectral.spectral_bipartition, solver=solver, with_quality=True)
    seed_mean = _jit(jspectral.seed_consistent_mean, solver=solver)
    for trial in range(3):
        n_valid = rng.randint(24, 90)
        half = n_valid // 2
        pts = np.zeros((96, 16), np.float32)
        pts[:half] = rng.randn(half, 16) * 0.3
        pts[half:n_valid] = rng.randn(n_valid - half, 16) * 0.3 + (3.0 if trial else 0.5)
        pts[n_valid:] = rng.randn(96 - n_valid, 16) * 10
        valid = np.arange(96) < n_valid
        aj, okj = bipartition(pts, valid)
        at, okt = tspectral.spectral_bipartition(_t(pts), _t(valid), solver=solver,
                                                 with_quality=True)
        assert bool(okt) == bool(okj), trial
        assert _same_partition(at.numpy(), np.asarray(aj), valid), trial

        seed = pts[0] + 0.01
        mj, okj = seed_mean(seed, pts, valid)
        mt, okt = tspectral.seed_consistent_mean(_t(seed), _t(pts), _t(valid), solver=solver)
        assert bool(okt) == bool(okj), trial
        report_parity(f"seed_consistent_mean {solver}", mt.numpy(), mj)
        np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-5)


def test_spectral_starved_lanczos_is_flagged_like_jax():
    """A path-like sparse graph with a starved step budget: the Paige residual
    flags the solve in both packages."""
    rng = np.random.RandomState(3)
    line = np.concatenate([np.linspace(0, 1, 100)[:, None], 0.01 * rng.randn(100, 15)],
                          axis=1).astype(np.float32)
    valid = np.ones(100, bool)
    for steps in (4, 24):
        _, okj = _jit(jspectral.spectral_bipartition, with_quality=True,
                      lanczos_steps=steps)(line, valid, k=jnp.asarray(2))
        _, okt = tspectral.spectral_bipartition(_t(line), _t(valid), k=2,
                                                with_quality=True, lanczos_steps=steps)
        assert bool(okt) == bool(okj), steps


# ----------------------------------------------------------------- GModule
def _nodesets(num_classes, n=64, d=32, n_valid=(50, 44), seed=1):
    """Source and target node sets with every class present in both."""
    out = []
    for dom, nv in enumerate(n_valid):
        r = np.random.RandomState(seed + dom)
        valid = np.arange(n) < nv
        pts = (r.randn(n, d) * valid[:, None]).astype(np.float32)
        labels = (np.arange(n) % num_classes).astype(np.int32)
        out.append((pts, labels, valid.astype(np.float32), valid))
    return out


GMODULE_CASES = [
    dict(num_classes=1),
    dict(num_classes=2, spectral_solver="eigh"),
    dict(num_classes=2, matching_cfg="m2m", matching_loss_type="MSE",
         node_dis_place="intra", with_global_graph=True),
    dict(num_classes=2, matching_loss_type="L1", node_dis_place="inter",
         with_score_weight=True, with_cluster_update=False),
]


@pytest.mark.parametrize("case", GMODULE_CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_gmodule_losses_and_seed_banks_match_jax(case):
    cfg = GModuleConfig(in_channels=32, nodes_per_class=32, dropout=0.0, **case)
    sets = _nodesets(cfg.num_classes)
    jsets = [jsampling.NodeSet(*(jnp.asarray(x) for x in s)) for s in sets]
    rng = np.random.RandomState(3)
    seeds = tuple(rng.randn(cfg.num_classes, 32).astype(np.float32) for _ in range(2))
    gm = JaxGModule(cfg)
    rngs = {"params": jax.random.PRNGKey(0), "gmodule": jax.random.PRNGKey(1),
            "dropout": jax.random.PRNGKey(2)}
    shapes = jax.eval_shape(lambda: gm.init(rngs, *jsets, seeds))["params"]
    params = _random_params(shapes, seed=9, scale=0.1)

    def run(p, s, t, sd):
        return gm.apply({"params": p}, s, t, sd, train=True,
                        rngs={"gmodule": jax.random.PRNGKey(3)})

    jlosses_, jseeds, (jg1, jg2) = _jit(run)(params, *jsets, seeds)

    tg = GModule(_port_cfg(cfg))
    tg.load_state_dict(module_state_dict(params))
    tsets = [tsampling.NodeSet(_t(p), _t(l).long(), _t(w), _t(v)) for p, l, w, v in sets]
    tl, tseeds, (tg1, tg2) = tg(*tsets, tuple(_t(s) for s in seeds), train=True,
                                generator=torch.Generator().manual_seed(0))
    assert set(tl) == set(jlosses_)
    for k, v in tl.items():
        report_parity(f"GModule {case} {k}", v.item(), float(jlosses_[k]))
        np.testing.assert_allclose(v.item(), float(jlosses_[k]), rtol=1e-3, atol=1e-5,
                                   err_msg=k)
    for got, want in zip(tseeds, jseeds):
        report_parity(f"GModule {case} seed bank", got.numpy(), want)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)
    for got, want in ((tg1, jg1), (tg2, jg2)):
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        np.testing.assert_allclose(got.nodes.detach().numpy(), np.asarray(want.nodes),
                                   atol=1e-3)
