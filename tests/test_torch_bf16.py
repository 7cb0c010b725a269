"""bf16 compute in the port against the JAX package's `dtype=jnp.bfloat16`,
on the CPU: the kNN distance, the TGCN, the ViG/DeepGCN and one train step
with every branch.

bf16 cannot be held to the JAX package to f32 tolerances: XLA:CPU keeps
excess precision inside its fusions where torch rounds every op to bf16, so
the two packages' bf16 results differ by bf16 rounding, and a kNN pick that
rounding can move moves. The bars:

  * the distance: f32 for bf16 input, the inner product accumulated in f32
    on the inputs' exact values, as `graphecho_tpu/ops/knn.py:33`; equal to
    JAX's within 1e-5 of the largest distance;
  * the kNN: where the port's neighbours differ from the JAX dense path's,
    the float64 distances of the two picks differ by at most `KNN_GAP`, a
    bf16-scale tie (the neighbour sets are not a test: hundreds of rows move
    at bf16 in both packages);
  * the TGCN and a small DeepGCN with the neighbour indices injected into
    both (no kNN in the comparison). The TGCN's losses, queues and
    BatchNorm statistics within `BF16_RTOL` (one bf16 ulp) of the largest
    entry. Through the DeepGCN's twenty-odd bf16 layers the JAX package's
    own bf16 logits stand 1-5% from its f32 ones; the port's bf16 logits
    must stand no farther from the JAX f32 logits than that, and within
    twice that of the JAX bf16 logits (largest error over largest entry);
    the same for the running statistics in train mode. End to end (each
    package builds its own graphs), the port's bf16 result stands within
    `END_TO_END` (3) times the JAX package's own bf16-vs-f32 distance of the
    JAX bf16 result, or 1%: a bf16 tie that moves a pick moves the result
    by about that distance, and the two packages break different ties
    (XLA:CPU normalises with excess precision, the port in bf16);
  * the step with every branch, with the TGCN's neighbours injected into
    both packages (the picks are held by the kNN test above): each loss
    within max(2 x the JAX package's bf16-vs-f32 difference of that loss,
    1% relative); the GModule and the pairwise MLP see f32; every post-step
    delta with rel 0.2 and cos 0.98 (`tests/test_train_step.py:183-193`;
    0.98 is the cosine of two equal norms 0.2 apart), or, where the JAX
    package's own bf16 delta stands a distance d > 0.1 from its f32 one,
    with rel 2d and cos 1 - (2d)^2 / 2. d must stay under `FLOOR_CAP`, so
    the bar stays under 0.9 and a flipped (rel 2) or unrelated (rel 1.4)
    delta fails. Every component steps with SGD, whose update is linear in
    the gradient (Adam's first step is sign(g), whose small entries bf16
    flips), and the batch holds two clips a domain: with one, the TGCN's
    train-mode BatchNorm normalises two clips, the clustering gradient into
    its trunk is the ~2% that its backward leaves of the gradient it is
    given, and bf16 rounding decides that residual in both packages (their
    own bf16 and f32 trunk deltas stand 0.99 apart).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from graphecho_tpu.models import tgcn as jtgcn_mod
from graphecho_tpu.models import vig as jvig
from graphecho_tpu.models.tgcn import TGCN as JTGCN
from graphecho_tpu.ops import knn as jknn
from graphecho_tpu.train.state import Optimizers, create_train_state as jax_create_state
from graphecho_tpu.train.steps import build_models as jax_build_models
from graphecho_tpu.train.steps import make_train_step as jax_make_train_step
from graphecho_tpu.utils.torch_import import fpn_params_from_torch

from test_torch_pairwise_mlp import report_parity
from test_torch_tgcn import _identity_dropout, _jax_args, _port_args, _tgcn_cfg, _tgcn_inputs
from test_torch_train_step import (FAST_COMPILE, GMN_KEYS, NET_KEYS, _delta_close, _fill,
                                   _port_snapshot, _to_port)
from test_torch_train_step_temporal import HW, T, TGCN_KEYS, _batch, _cfg, _jax_cycle_starts
from test_torch_vig import TINY, _flax_variables

from graphecho_torch import config as tconfig
from graphecho_torch.convert import from_flax
from graphecho_torch.models import graph_matching, tgcn as ttgcn_mod
from graphecho_torch.models import vig as tvig
from graphecho_torch.models.tgcn import TGCN
from graphecho_torch.ops import knn as tknn
from graphecho_torch.ops import pairwise_mlp as pm
from graphecho_torch.train import cycle
from graphecho_torch.train.state import create_train_state
from graphecho_torch.train.steps import build_models, make_train_step


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of a thread per core oversubscribes the machine
    (tens of times slower under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


BF16 = jnp.bfloat16
KNN_GAP = 4 * 2.0 ** -7  # four bf16 ulps of 1, the squared norm of a normalised node
BF16_RTOL = 2.0 ** -7    # one bf16 ulp of the largest entry
END_TO_END = 3           # x the JAX package's own bf16-vs-f32 distance
DELTA_REL = 0.2          # a step delta's rel error; cos 1 - rel^2 / 2 = 0.98
FLOOR_CAP = 0.45         # the largest JAX bf16-vs-f32 delta distance compared


def _bf16_np(x):
    """f32 numpy of bf16-rounded values: the same numbers in both packages."""
    return np.array(jnp.asarray(x, BF16).astype(jnp.float32))


def _tb(x):
    return torch.from_numpy(np.array(x)).to(torch.bfloat16)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------------------- distance
@pytest.mark.parametrize("self_graph", [True, False], ids=["self", "xy"])
def test_distance_is_f32_with_an_f32_inner_product(self_graph):
    rng = np.random.RandomState(0)
    x = _bf16_np(rng.randn(2, 9, 16))
    y = None if self_graph else _bf16_np(rng.randn(2, 7, 16))
    got = tknn.pairwise_sq_distance(_tb(x), None if y is None else _tb(y))
    want = jknn.pairwise_sq_distance(jnp.asarray(x, BF16),
                                     None if y is None else jnp.asarray(y, BF16))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    report_parity(f"bf16 pairwise_sq_distance {'self' if self_graph else 'xy'}", got.numpy(),
                  np.asarray(want))
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5 * scale)
    # the squared norms are bf16; the inner product is the float64 one of the
    # bf16 values up to f32 rounding (a bf16 product would be ~1e-2 off)
    xt, yt = _tb(x), _tb(x if y is None else y)
    x_sq = torch.sum(xt * xt, -1).float()
    y_sq = torch.sum(yt * yt, -1).float()
    inner = (x_sq[:, :, None] + y_sq[:, None, :] - got) / 2
    want_inner = np.einsum("bnc,bmc->bnm", xt.double().numpy(), yt.double().numpy())
    np.testing.assert_allclose(inner.numpy(), want_inner, rtol=0, atol=1e-5 * scale)


# ------------------------------------------------------------------------ kNN
@pytest.mark.parametrize("shape", [(8, 64, 64, 256, 9, False), (2, 196, 49, 80, 9, True)],
                         ids=["tgcn", "grapher"])
def test_bf16_knn_matches_jax_up_to_bf16_ties(shape):
    b, n, m, c, k, with_rel = shape
    rng = np.random.RandomState(0)
    x, y = _bf16_np(rng.randn(b, n, c)), _bf16_np(rng.randn(b, m, c))
    rel = tvig.relative_pos_buffer(c, n, m, torch.device("cpu")) if with_rel else None
    got = tknn.knn_reference(_tb(x), _tb(y), k, True, rel)
    jx, jy = jnp.asarray(x, BF16), jnp.asarray(y, BF16)
    want = jknn.dense_knn(jknn.l2_normalize(jx), jknn.l2_normalize(jy), k,
                          None if rel is None else jnp.asarray(rel.numpy()))
    want = torch.from_numpy(np.array(want))
    rows, gap = tknn.knn_tie_gap(torch.from_numpy(x), torch.from_numpy(y), rel, True, got, want)
    print(f"PARITY bf16 knn {shape}: {rows} of {b * n} rows differ, largest float64 gap {gap:.3g}")
    assert gap <= KNN_GAP


# ----------------------------------------------------------------------- TGCN
def _inject_knn(monkeypatch, seed):
    """Both packages' graph builders return the same random neighbours for a
    graph of the same shape (the JAX TGCN traces its frame cell once, the
    port runs it per frame), so no kNN pick enters the comparison."""
    calls = {"jax": 0, "torch": 0}

    def idx(pkg, x, y, k, dilation=1, *a, **kw):
        b, n = x.shape[:2]
        m = (x if y is None else y).shape[1]
        calls[pkg] += 1
        rng = np.random.RandomState([seed, b, n, m, k])
        return rng.randint(0, m, (b, n, k)).astype(np.int32)

    monkeypatch.setattr(jtgcn_mod, "dilated_knn_graph",
                        lambda *a, **kw: jnp.asarray(idx("jax", *a, **kw)))
    monkeypatch.setattr(jvig, "dilated_knn_graph",
                        lambda *a, **kw: jnp.asarray(idx("jax", *a, **kw)))
    monkeypatch.setattr(ttgcn_mod, "dilated_knn_graph",
                        lambda *a, **kw: torch.from_numpy(idx("torch", *a, **kw)))
    monkeypatch.setattr(tvig, "dilated_knn_graph",
                        lambda *a, **kw: torch.from_numpy(idx("torch", *a, **kw)))
    return calls


def _bf16_inputs():
    clips, nodes, valid, queues, idx = _tgcn_inputs()
    return [_bf16_np(c) for c in clips], nodes, valid, queues, idx


def _run_tgcn(jcfg, params, stats, inputs, dtype):
    jm = JTGCN(jcfg, dtype=dtype)
    args = _jax_args(*inputs)
    if dtype is not None:
        args = ([a.astype(dtype) for a in args[0]],) + args[1:]
    (losses, queues), mut = jax.jit(
        lambda v, *a: jm.apply(v, *a, train=True, mutable=["batch_stats"]),
        compiler_options=FAST_COMPILE)({"params": params, "batch_stats": stats}, *args)
    return ({k: float(v) for k, v in losses.items()}, [np.asarray(q) for q in queues],
            from_flax({"tgcn_params": params, "tgcn_batch_stats": mut["batch_stats"]})["tgcn"])


def _run_port_tgcn(jcfg, params, stats, inputs):
    port = TGCN(dataclasses.replace(tconfig.TGCNConfig(), **dataclasses.asdict(jcfg)),
                dtype=torch.bfloat16)
    port.load_state_dict(from_flax({"tgcn_params": params, "tgcn_batch_stats": stats})["tgcn"])
    args = _port_args(*inputs)
    args = ([c.to(torch.bfloat16) for c in args[0]],) + args[1:]
    with torch.no_grad():
        losses, queues = port.train()(*args)
    return ({k: float(v) for k, v in losses.items()}, [q.numpy() for q in queues],
            port.state_dict())


@pytest.mark.parametrize("injected", [True, False], ids=["injected_knn", "end_to_end"])
def test_bf16_tgcn_matches_flax_bf16(injected, monkeypatch):
    _identity_dropout(monkeypatch)
    if injected:
        _inject_knn(monkeypatch, 40)
    jcfg = _tgcn_cfg("momentum_queue", "node_discriminate")
    inputs = _bf16_inputs()
    shapes = jax.eval_shape(lambda: JTGCN(jcfg).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        *_jax_args(*inputs)))
    params = _fill(shapes["params"], 7)
    stats = jax.tree_util.tree_map(lambda s: np.ones(s.shape, np.float32), shapes["batch_stats"])
    jl, jq, jstats = _run_tgcn(jcfg, params, stats, inputs, BF16)
    tl, tq, tstats = _run_port_tgcn(jcfg, params, stats, inputs)
    assert set(tl) == set(jl)
    if injected:
        for k in jl:
            report_parity(f"bf16 tgcn injected {k}", tl[k], jl[k])
            np.testing.assert_allclose(tl[k], jl[k], rtol=BF16_RTOL, err_msg=k)
        for name, got, want in zip(("queue_source", "queue_target"), tq, jq):
            report_parity(f"bf16 tgcn injected {name}", got, want)
            assert _rel(got, want) <= BF16_RTOL, name
        for key in ("mlp_bn.running_mean", "mlp_bn.running_var", "pred_bn.running_mean",
                    "pred_bn.running_var"):
            report_parity(f"bf16 tgcn injected {key}", tstats[key].numpy(), jstats[key].numpy())
            assert _rel(tstats[key].numpy(), jstats[key].numpy()) <= BF16_RTOL, key
        return
    jl32, _, _ = _run_tgcn(jcfg, params, stats, inputs, None)
    for k in jl:
        bar = max(END_TO_END * abs(jl[k] - jl32[k]), 0.01 * abs(jl[k]))
        print(f"PARITY bf16 tgcn end to end {k}: port {tl[k]:.6g} jax bf16 {jl[k]:.6g} "
              f"jax f32 {jl32[k]:.6g} (bar {bar:.3g})")
        assert abs(tl[k] - jl[k]) <= bar, k


# ------------------------------------------------------------------- DeepGCN
@pytest.fixture(scope="module")
def tiny_vig():
    jm = jvig.DeepGCN(**TINY)
    x = np.random.RandomState(7).rand(4, 64, 64, 3).astype(np.float32)
    variables = _flax_variables(jm, x, seed=8)
    return x, variables


def _jax_vig(variables, x, dtype, train):
    jm = jvig.DeepGCN(**TINY, dtype=dtype)

    def apply(v, x):
        if not train:
            return jm.apply(v, x, train=False).astype(jnp.float32), None
        logits, mut = jm.apply(v, x, train=True, mutable=["batch_stats"])
        return logits.astype(jnp.float32), mut["batch_stats"]

    logits, stats = jax.jit(apply, compiler_options=FAST_COMPILE)(variables, x)
    return np.asarray(logits), stats


def _port_vig(variables, x, train):
    model = tvig.DeepGCN(**TINY, dtype=torch.bfloat16)
    model.load_state_dict(from_flax({"vig_params": variables["params"],
                                     "vig_batch_stats": variables["batch_stats"]})["vig"])
    model.train(train)
    with torch.no_grad():
        logits = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert logits.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    return logits.float().numpy(), model.state_dict()


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("injected", [True, False], ids=["injected_knn", "end_to_end"])
def test_bf16_deepgcn_matches_flax_bf16(tiny_vig, injected, train, monkeypatch):
    x, variables = tiny_vig
    if injected:
        calls = _inject_knn(monkeypatch, 70)
    want, jstats = _jax_vig(variables, x, BF16, train)
    want32, jstats32 = _jax_vig(variables, x, None, train)
    got, sd = _port_vig(variables, x, train)
    what = f"bf16 DeepGCN tiny {'train' if train else 'eval'}"
    if injected:
        assert calls["jax"] == 2 * calls["torch"] == 2 * sum(TINY["blocks"])
        pairs = [("logits", got, want, want32)]
        if train:
            want_sd, want_sd32 = (from_flax({"vig_params": variables["params"],
                                             "vig_batch_stats": st})["vig"]
                                  for st in (jstats, jstats32))
            pairs += [(key, sd[key].numpy(), want_sd[key].numpy(), want_sd32[key].numpy())
                      for key in ("stem.bn1.running_mean", "grapher_0.bn2.running_var",
                                  "ffn_4.bn2.running_mean", "pred_bn.running_var")]
        for key, g, w, w32 in pairs:
            jax_err = _rel(w, w32)
            print(f"PARITY {what} injected {key}: port vs jax bf16 {_rel(g, w):.3g}, "
                  f"port vs jax f32 {_rel(g, w32):.3g}, jax bf16 vs f32 {jax_err:.3g}")
            assert _rel(g, w32) <= max(jax_err, BF16_RTOL), key
            assert _rel(g, w) <= 2 * max(jax_err, BF16_RTOL), key
        return
    n = np.linalg.norm
    bar = max(END_TO_END * n(want - want32), 0.01 * n(want))
    print(f"PARITY {what} end to end logits: port vs jax bf16 {n(got - want):.3g}, "
          f"port vs jax f32 {n(got - want32):.3g}, jax bf16 vs f32 {n(want - want32):.3g}")
    assert n(got - want) <= bar


# ----------------------------------------------------------------- the step
def _step_batch():
    """The temporal test's batch with two clips a domain (the recipe batches
    `real_training.TEMPORAL_BATCH`, four) and a 24-frame cycle clip."""
    batch = _batch()
    rng = np.random.RandomState(13)
    clips = lambda: (rng.rand(2, T, HW, HW, 1) * 0.6).astype(np.float32)  # noqa: E731
    batch.update(temp_imgs_source=clips(), temp_imgs_target=clips(),
                 temp_masks=np.repeat(batch["temp_masks"], 2, axis=0),
                 update_idx_source=np.array([2, 4], np.int32),
                 update_idx_target=np.array([5, 1], np.int32),
                 cyc_imgs=batch["cyc_imgs"][:24])
    return batch


def _step_run(monkeypatch):
    """One step of the temporal test's every-branch configuration
    (`test_torch_train_step_temporal`) with `compute_dtype="bfloat16"`, SGD
    for every component and `_step_batch`: the port's bf16 step, and the JAX
    package's bf16 and f32 steps, from one set of weights. Returns (JAX state before, JAX bf16
    state and metrics after, JAX f32 state and metrics after, port metrics,
    port snapshots before and after, what the GModule and the pairwise MLP
    were given)."""
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    from graphecho_torch.models import attention
    monkeypatch.setattr(attention, "dropout", lambda x, *a, **k: x)
    calls = _inject_knn(monkeypatch, 90)
    batch = _step_batch()
    j32 = _cfg()
    sgd = dataclasses.replace(j32.train.net, opt=dataclasses.replace(
        j32.train.net.opt, opt_name="SGD", lr=2.5e-3))
    j32 = dataclasses.replace(j32, train=dataclasses.replace(j32.train, net=sgd),
                              cycle=dataclasses.replace(j32.cycle, clip_length=24))
    jcfg = dataclasses.replace(j32, model=dataclasses.replace(j32.model,
                                                              compute_dtype="bfloat16"))
    tcfg = _to_port(jcfg)
    tstate = create_train_state(tcfg, build_models(tcfg), torch.device("cpu"))
    assert tstate.net.module.dtype == tstate.tgcn.module.dtype == torch.bfloat16

    models, opts = jax_build_models(jcfg), Optimizers(jcfg)
    shapes = jax.eval_shape(lambda r, b: jax_create_state(jcfg, models, opts, r, b),
                            jax.random.PRNGKey(0), batch)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = {k: v.numpy().copy() for k, v in tstate.net.module.state_dict().items()}
    net_params, net_stats, skipped = fpn_params_from_torch(
        sd, zeros.net_params, zeros.net_batch_stats)
    assert not skipped
    rng = np.random.RandomState(5)
    queues = [rng.randn(32, 6).astype(np.float32) for _ in range(2)]
    jstate = zeros.replace(
        net_params=net_params, net_batch_stats=net_stats,
        gmn_params=_fill(shapes.gmn_params, 6), dis_params=_fill(shapes.dis_params, 7),
        tgcn_params=_fill(shapes.tgcn_params, 8),
        tgcn_batch_stats=jax.tree_util.tree_map(lambda s: np.ones(s.shape, np.float32),
                                                shapes.tgcn_batch_stats),
        sr_seed=rng.randn(*shapes.sr_seed.shape).astype(np.float32),
        tg_seed=rng.randn(*shapes.tg_seed.shape).astype(np.float32),
        queue_source=queues[0] / np.linalg.norm(queues[0], axis=0),
        queue_target=queues[1] / np.linalg.norm(queues[1], axis=0))
    jstate.net_params["conv3"]["bias"] = np.asarray([-8.0, 8.0], np.float32)
    fields = ("net_params", "net_batch_stats", "gmn_params", "dis_params", "tgcn_params",
              "tgcn_batch_stats", "sr_seed", "tg_seed", "queue_source", "queue_target")
    tstate.load_converted(from_flax({f: getattr(jstate, f) for f in fields}))
    starts = _jax_cycle_starts(jstate.rng, 1, cycle.n_starts())
    monkeypatch.setattr(cycle, "draw_starts", lambda *a, **k: starts)

    seen = []
    gm_forward = graph_matching.GModule.forward
    plain = pm.pairwise_mlp_auto

    def spy_gm(self, src, tgt, *a, **k):
        seen.append(("gmodule", src.points.dtype, tgt.points.dtype))
        return gm_forward(self, src, tgt, *a, **k)

    def spy_pm(a, b, w2, b2):
        seen.append(("pairwise", a.dtype, b.dtype))
        return plain(a, b, w2, b2)

    from graphecho_torch.models import affinity
    monkeypatch.setattr(graph_matching.GModule, "forward", spy_gm)
    monkeypatch.setattr(affinity, "pairwise_mlp_auto", spy_pm)

    jsteps = {}
    for name, cfg in (("bf16", jcfg), ("f32", j32)):
        m = jax_build_models(cfg)
        step = jax.jit(jax_make_train_step(cfg, m, Optimizers(cfg)),
                       compiler_options=FAST_COMPILE)
        out, metrics = step(jstate, batch)
        jsteps[name] = (from_flax({f: getattr(out, f) for f in (
            "net_params", "net_batch_stats", "gmn_params", "dis_params", "tgcn_params",
            "tgcn_batch_stats")}), {k: float(v) for k, v in metrics.items()})
    j0 = from_flax({f: getattr(jstate, f) for f in fields[:6]})
    t0 = _port_snapshot(tstate)
    t0["tgcn"] = {k: v.clone() for k, v in tstate.tgcn.module.state_dict().items()}
    tm = {k: float(v) for k, v in make_train_step(tcfg)(tstate, batch).items()}
    assert calls["torch"] == T and calls["jax"] > 0  # one kNN a frame
    t1 = _port_snapshot(tstate)
    t1["tgcn"] = {k: v.clone() for k, v in tstate.tgcn.module.state_dict().items()}
    return j0, jsteps, tm, t0, t1, seen


DELTA_KEYS = ([("fpn", k) for k in NET_KEYS + ("back_bone.block_5.0.weight",)]
              + [("gmodule", k) for k in GMN_KEYS] + [("tgcn", k) for k in TGCN_KEYS])


def test_bf16_step_with_every_branch_matches_the_jax_bf16_step(monkeypatch):
    j0, jsteps, tm, t0, t1, seen = _step_run(monkeypatch)
    assert {s[0] for s in seen} == {"gmodule", "pairwise"}
    assert all(d == torch.float32 for s in seen for d in s[1:]), seen
    (j1, jm), (j1_32, jm32) = jsteps["bf16"], jsteps["f32"]
    assert set(tm) == set(jm)
    for k in jm:
        bar = max(2 * abs(jm[k] - jm32[k]), 0.01 * abs(jm[k]))
        print(f"PARITY bf16 step {k}: port {tm[k]:.6g} jax bf16 {jm[k]:.6g} "
              f"jax f32 {jm32[k]:.6g} bar {bar:.3g}")
        assert abs(tm[k] - jm[k]) <= bar, k
    n = np.linalg.norm
    strict = []
    for comp, k in DELTA_KEYS:
        dj = (j1[comp][k] - j0[comp][k]).numpy().ravel()
        dj32 = (j1_32[comp][k] - j0[comp][k]).numpy().ravel()
        dt = (t1[comp][k] - t0[comp][k]).numpy().ravel()
        assert n(dt) > 0, f"{comp}.{k}: the port's parameter did not move"
        rel, cos = n(dt - dj) / n(dj), dt @ dj / (n(dt) * n(dj))
        floor = n(dj - dj32) / n(dj32)
        bar = max(DELTA_REL, 2 * floor)
        print(f"PARITY bf16 step delta {comp}.{k}: port vs jax bf16 rel {rel:.3g} cos {cos:.4f};"
              f" jax bf16 vs f32 {floor:.3g} (bar rel {bar:.3g} cos {1 - bar ** 2 / 2:.4f})")
        assert floor < FLOOR_CAP, f"{comp}.{k}: bf16 does not resolve this delta in JAX"
        assert rel < bar and cos > 1 - bar ** 2 / 2, f"{comp}.{k}: rel {rel:.3g} cos {cos:.4f}"
        strict.append(rel < DELTA_REL and cos > 1 - DELTA_REL ** 2 / 2)
    print(f"PARITY bf16 step deltas: {sum(strict)} of {len(strict)} within rel 0.2 / cos 0.98")


def test_bf16_step_keeps_remat_and_the_fused_forwards():
    """`remat` and `fused_fpn_forwards` under bf16: one step with every
    branch gives the same losses with and without remat (the recompute
    runs the same bf16 operations) and runs with the fused forwards."""
    from test_torch_parallel import _cfg as _every_cfg
    from test_torch_parallel import _global_batch

    base = _every_cfg("every")
    runs = {}
    for name, model in (("plain", {}), ("remat", {"remat": True}),
                        ("fused", {"fused_fpn_forwards": True})):
        cfg = dataclasses.replace(base, model=dataclasses.replace(
            base.model, compute_dtype="bfloat16", **model))
        state = create_train_state(cfg, build_models(cfg), torch.device("cpu"), seed=0)
        assert state.net.module.dtype == torch.bfloat16
        metrics = make_train_step(cfg)(state, _global_batch("every"))
        runs[name] = {k: float(v) for k, v in metrics.items()}
    assert runs["remat"] == runs["plain"]
    assert all(np.isfinite(v) for v in runs["fused"].values())
    assert runs["fused"]["cyc_loss"] != 0 and runs["fused"]["temporal_graph_loss"] != 0
