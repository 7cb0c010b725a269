"""Whole train step of the port against the JAX package, on the CPU.

One step of `graphecho_torch.train.steps.make_train_step` and of
`graphecho_tpu.train.steps.make_train_step` run from the same weights on the
same NHWC batch: the FPN (weights from the port's initializer, carried into
flax by the JAX package's importer), the GModule and the four discriminators
(random flax parameters carried into the port by
`graphecho_torch.convert.from_flax`). Checked: every loss key within rtol
1e-3, and the post-step parameter deltas of net, gmn and dis by relative L2
error and cosine as `tests/test_train_step_parity.py:380-388` does (Adam's
first step is sign-like, so its tensors get rel 0.2; SGD deltas are linear in
the gradient and get rel 0.02, or 0.05 behind the discriminators' four
GroupNorms). This file runs the cardiac branch (tiny VGG16, two classes), one step and
then a 3-step trajectory across the end of the warmup and an LR milestone;
`test_torch_train_step_camus.py` runs the camus branch (ResNet50) on the same
helpers. Shapes are tiny: batch 2, 64², FPN and graph widths 32.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from graphecho_tpu import config as jconfig
from graphecho_tpu.train.state import Optimizers, create_train_state as jax_create_state
from graphecho_tpu.train.steps import build_models as jax_build_models
from graphecho_tpu.train.steps import make_train_step as jax_make_train_step
from graphecho_tpu.utils.torch_import import fpn_params_from_torch

from test_torch_pairwise_mlp import report_parity

from graphecho_torch import config as tconfig
from graphecho_torch import entrypoints
from graphecho_torch.convert import from_flax
from graphecho_torch.models.backbones import BatchNorm2d, Bottleneck
from graphecho_torch.ops import pairwise_mlp as pm
from graphecho_torch.train.state import create_train_state
from graphecho_torch.train.steps import build_models, make_train_step

FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
B, HW = 2, 64
# LR per update: warmup factor at update 0, full LR at 1, x0.1 from update 2
SCHEDULE = dict(steps=(2,), warmup_iters=1, gamma=0.1)


def _to_port(obj):
    """A graphecho_tpu config dataclass -> its graphecho_torch twin."""
    if dataclasses.is_dataclass(obj):
        return getattr(tconfig, type(obj).__name__)(
            **{f.name: _to_port(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    return obj


def _cfg(branch):
    C = jconfig
    sch = C.ScheduleConfig(**SCHEDULE)
    comp = {name: C.ComponentConfig(opt=C.OptimizerConfig(opt, lr), sch=sch)
            for name, opt, lr in (("net", "Adam", 3e-4), ("gmn", "SGD", 2.5e-3),
                                  ("dis", "SGD", 2.5e-3))}
    if branch == "camus":
        model = C.ModelConfig(backbone="resnet", num_classes=1, fpn_channels=32,
                              semantic_channels=16)
        # one class: the FCOS labels are box indices, so no positive node
        # exists and the graph losses are gated to 0 in both packages; the
        # spectral update is left out of this program to keep its compile short
        gm = C.GModuleConfig(in_channels=32, num_classes=1, nodes_per_class=32,
                             dropout=0.0, with_cluster_update=False)
    else:
        model = C.ModelConfig(backbone="VGG16", num_classes=2, fpn_channels=32,
                              semantic_channels=16,
                              vgg_spec=((8, 1), (16, 1), (16, 1), (32, 1), (32, 1)))
        gm = C.GModuleConfig(in_channels=32, num_classes=2, nodes_per_class=64, dropout=0.0)
    return C.ExperimentConfig(
        train=C.TrainConfig(**comp),
        data=C.DataConfig(img_crop=(HW, HW), batch_size=B, target_batch_mult=1),
        model=model, gmodule=gm, dis=C.DiscriminatorConfig(in_channels=32))


def _batches(n_ch, n, seed=11):
    """Fresh images each step over one scene geometry: channel 1 one
    rectangle, channel 0 its complement (the cardiac BG channel)."""
    rng = np.random.RandomState(seed)
    masks = np.zeros((B, HW, HW, n_ch), np.float32)
    masks[:, 8:40, 8:40, -1] = 1.0
    if n_ch > 1:
        masks[..., 0] = 1.0 - masks[..., 1]
    return [{"imgs_source": (rng.rand(B, HW, HW, 1) * 0.6).astype(np.float32),
             "imgs_target": (rng.rand(B, HW, HW, 1) * 0.6).astype(np.float32),
             "masks": masks} for _ in range(n)]


def _condition(fpn, x, gen):
    """Damp the ResNet residual branches and calibrate BatchNorm running
    stats on `x`, so that f32 noise stays small through 50 layers."""
    bns = [m for m in fpn.modules() if isinstance(m, BatchNorm2d)]
    with torch.no_grad():
        for mod in fpn.modules():
            if isinstance(mod, Bottleneck):
                mod.bn3.weight.mul_(0.2)
        for bn in bns:
            bn.momentum = 1.0
        fpn.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
        for bn in bns:
            bn.momentum = 0.1
            bn.running_var.mul_(1 + 0.2 * torch.rand(bn.running_var.shape, generator=gen))


def _fill(shapes, seed):
    """Random flax leaves by name: scales near 1, small biases, fan-in-scaled
    kernels."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path[-1:])
        if "scale" in name:
            v = 1 + 0.1 * rng.randn(*s.shape)
        elif "bias" in name or "_b" in name:
            v = 0.05 * rng.randn(*s.shape)
        else:
            fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else s.shape[0]
            v = rng.randn(*s.shape) / np.sqrt(fan_in)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _shared_start(branch, batch):
    """(JAX config, JAX state, port config, port state) from one set of weights."""
    jcfg = _cfg(branch)
    tcfg = _to_port(jcfg)
    # the port's FPN from its own initializer, conditioned
    tstate = create_train_state(tcfg, build_models(tcfg), torch.device("cpu"))
    _condition(tstate.net.module, batch["imgs_source"], torch.Generator().manual_seed(1))

    models, opts = jax_build_models(jcfg), Optimizers(jcfg)
    shapes = jax.eval_shape(lambda r, b: jax_create_state(jcfg, models, opts, r, b),
                            jax.random.PRNGKey(0), batch)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = {k: v.numpy().copy() for k, v in tstate.net.module.state_dict().items()}
    net_params, net_stats, skipped = fpn_params_from_torch(
        sd, zeros.net_params, zeros.net_batch_stats)
    assert not skipped
    rng = np.random.RandomState(5)
    jstate = zeros.replace(
        net_params=net_params, net_batch_stats=net_stats,
        gmn_params=_fill(shapes.gmn_params, 6), dis_params=_fill(shapes.dis_params, 7),
        sr_seed=rng.randn(*shapes.sr_seed.shape).astype(np.float32),
        tg_seed=rng.randn(*shapes.tg_seed.shape).astype(np.float32))
    if branch == "cardiac":
        # bias the head so the target pseudo-labels threshold far from 0.5:
        # channel 0 never fires, channel 1 always does
        jstate.net_params["conv3"]["bias"] = np.asarray([-8.0, 8.0], np.float32)
    tstate.load_converted(from_flax({f: getattr(jstate, f) for f in (
        "net_params", "net_batch_stats", "gmn_params", "dis_params", "sr_seed", "tg_seed")}))
    step = jax.jit(jax_make_train_step(jcfg, models, opts), compiler_options=FAST_COMPILE)
    return jcfg, jstate, step, tcfg, tstate


def _delta_close(dj, dt, what, rel, cos_min=0.999):
    dj, dt = np.asarray(dj).ravel(), np.asarray(dt).ravel()
    nt = np.linalg.norm(dt)
    assert nt > 0, f"{what}: the port's parameter did not move"
    print(f"PARITY {what} delta rel_l2_err={np.linalg.norm(dj - dt) / nt:.3g}")
    assert np.linalg.norm(dj - dt) / nt < rel, f"{what}: delta rel L2 err"
    assert np.dot(dj, dt) / (np.linalg.norm(dj) * nt) > cos_min, f"{what}: delta cosine"


NET_KEYS = ("toplayer.weight", "latlayer1.weight", "smooth1.weight", "semantic_branch.weight",
            "conv3.weight", "conv3.bias")
GMN_KEYS = ("head_in_1.weight", "node_cls_2.weight", "node_dis_0.weight",
            "intra_domain_graph.linear_k.weight", "intra_domain_graph.layer_norm.weight",
            "cross_domain_graph.linear_q.weight", "node_affinity.project_sr.weight",
            "node_affinity.fc1_wx", "node_affinity.fc2_w")
DIS_KEYS = ("dis_tower_0.weight", "dis_tower_3.weight", "cls_logits.weight", "gn_1.weight")


def _check_deltas(branch, jstate0, jstate1, t0, t1, backbone_key):
    """Post-step deltas of JAX states 0 -> 1 against port snapshots t0 -> t1."""
    j0, j1 = (from_flax({f: getattr(s, f) for f in ("net_params", "net_batch_stats",
                                                     "gmn_params", "dis_params")})
              for s in (jstate0, jstate1))
    for k in NET_KEYS + (backbone_key,):
        _delta_close(j1["fpn"][k] - j0["fpn"][k], t1["fpn"][k] - t0["fpn"][k],
                     f"{branch} net.{k}", rel=0.2, cos_min=0.98)
    for k in GMN_KEYS:
        _delta_close(j1["gmodule"][k] - j0["gmodule"][k], t1["gmodule"][k] - t0["gmodule"][k],
                     f"{branch} gmn.{k}", rel=0.02)
    for lvl in ("p2", "p5"):
        for k in DIS_KEYS:
            _delta_close(j1["dis"][lvl][k] - j0["dis"][lvl][k],
                         t1["dis"][lvl][k] - t0["dis"][lvl][k], f"{branch} dis.{lvl}.{k}",
                         rel=0.05)


def _port_snapshot(tstate):
    clone = lambda sd: {k: v.detach().clone() for k, v in sd.items()}  # noqa: E731
    return {"fpn": clone(tstate.net.module.state_dict()),
            "gmodule": clone(tstate.gmn.module.state_dict()),
            "dis": {lvl: clone(d.state_dict()) for lvl, d in tstate.dis.module.items()}}


def _assert_losses(jmetrics, tmetrics, what):
    assert set(jmetrics) == set(tmetrics), what
    for k, v in tmetrics.items():
        report_parity(f"{what} {k}", float(v), float(jmetrics[k]))
        np.testing.assert_allclose(float(v), float(jmetrics[k]), rtol=1e-3, atol=1e-5,
                                   err_msg=f"{what}: {k}")


@pytest.fixture(scope="module")
def cardiac_run():
    """The cardiac branch, 3 steps on both sides from one start."""
    batches = _batches(2, 3)
    jcfg, jstate, step, tcfg, tstate = _shared_start("cardiac", batches[0])
    train_step = make_train_step(tcfg)
    jstates, jmets, tmets, snaps = [jstate], [], [], [_port_snapshot(tstate)]
    for batch in batches:
        jstate, m = step(jstate, batch)
        jstates.append(jax.tree_util.tree_map(np.asarray, jstate))
        jmets.append({k: float(v) for k, v in m.items()})
        tmets.append(train_step(tstate, batch))
        snaps.append(_port_snapshot(tstate))
    return jstates, jmets, tmets, snaps, tstate


def test_one_step_matches_jax(cardiac_run):
    jstates, jmets, tmets, snaps, _ = cardiac_run
    _assert_losses(jmets[0], tmets[0], "cardiac step 0")
    _check_deltas("cardiac", jstates[0], jstates[1], snaps[0], snaps[1],
                  "back_bone.block_5.0.weight")


def test_three_step_trajectory_across_schedule_boundary(cardiac_run):
    jstates, jmets, tmets, snaps, tstate = cardiac_run
    for i, (jm, tm) in enumerate(zip(jmets, tmets)):
        _assert_losses(jm, tm, f"step {i}")
    # the LR really moved: warmup factor, full LR, then the milestone decay
    lr = [tstate.gmn.lr_at(n) for n in range(3)]
    np.testing.assert_allclose(lr, [2.5e-3 / 3, 2.5e-3, 2.5e-4], rtol=1e-12)
    _check_deltas("cardiac 3 steps", jstates[0], jstates[3], snaps[0], snaps[3],
                  "back_bone.block_5.0.weight")
    # BatchNorm running stats and the seed banks after three steps
    want = from_flax({"net_params": jstates[3].net_params,
                      "net_batch_stats": jstates[3].net_batch_stats})["fpn"]
    for k, v in snaps[3]["fpn"].items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-3, atol=1e-4,
                                       err_msg=k)
    np.testing.assert_allclose(tstate.sr_seed.numpy(), jstates[3].sr_seed, atol=1e-3)
    np.testing.assert_allclose(tstate.tg_seed.numpy(), jstates[3].tg_seed, atol=1e-3)


def test_train_camus_echo_entry_point_runs_on_cpu():
    cfg = tconfig.camus_echo_config()
    cfg = dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, img_crop=(64, 64), batch_size=2, target_batch_mult=2),
        model=dataclasses.replace(cfg.model, fpn_channels=32, semantic_channels=16),
        gmodule=dataclasses.replace(cfg.gmodule, in_channels=32, nodes_per_class=32),
        dis=dataclasses.replace(cfg.dis, in_channels=32))
    pm.reset_launch_counts()
    trainer = entrypoints.train_camus_echo(num_epochs=1, steps_per_epoch=2, n_eval=2,
                                           device="cpu", cfg=cfg)
    means = trainer.last_epoch_metrics
    assert means["steps"] == 2 and trainer.state.step == 2
    for k in ("seg_loss", "dis_loss", "node_loss", "mat_loss_aff", "mat_loss_qu",
              "loss_adv_p2", "loss_adv_p3", "loss_adv_p4", "loss_adv_p5", "total_loss"):
        assert np.isfinite(means[k]), k
    imgs, masks = next(entrypoints.SyntheticEchoData(cfg, seed=1).eval_batches(1))
    assert np.isfinite(trainer.validation([(imgs, masks)], "check"))
    assert all(v == 0 for v in pm.LAUNCHES.values())  # CPU tensors: the plain version


@pytest.mark.parametrize("method", ["constant", "linear"])
def test_schedule_matches_jax(method):
    from graphecho_tpu.train.schedule import build_optimizer as jax_build_optimizer
    from graphecho_tpu.train.schedule import cosine_lr as jax_cosine_lr
    from graphecho_tpu.train.schedule import warmup_multistep_schedule

    from graphecho_torch.train.schedule import build_optimizer, cosine_lr

    sch = jconfig.ScheduleConfig(steps=(3, 5), gamma=0.5, warmup_factor=0.25,
                                 warmup_iters=4, warmup_method=method)
    comp = jconfig.ComponentConfig(opt=jconfig.OptimizerConfig("SGD", 0.1), sch=sch)
    jax_lr = warmup_multistep_schedule(0.1, sch)
    _, lr_at = build_optimizer(_to_port(comp), [torch.zeros(1, requires_grad=True)],
                               steps_per_epoch=2)
    for count in range(14):
        # the LR steps once per epoch of 2 updates
        np.testing.assert_allclose(lr_at(count), float(jax_lr(count // 2)), rtol=1e-6)
    with pytest.raises(ValueError, match="steps_per_epoch"):
        build_optimizer(_to_port(comp), [torch.zeros(1, requires_grad=True)], 0)
    with pytest.raises(ValueError, match="steps_per_epoch"):
        jax_build_optimizer(comp, 0)
    np.testing.assert_allclose(cosine_lr(0.1, 3, 10), jax_cosine_lr(0.1, 3, 10))
