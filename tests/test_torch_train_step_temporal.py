"""The train step with every branch on (graph matching, discriminators, the
temporal TGCN branch, the 64-frame cycle loss and the fused FPN forwards;
the port's backbone also under remat) against the JAX package, on the CPU.

The cardiac start of `test_torch_train_step.py` (tiny VGG16, two classes,
batch 2, 64², widths 32) plus the TGCN: one source and one target clip of 2
frames on a 4x4 node grid, k 3, momentum-queue clustering, and one cycle
clip of 64 frames. The TGCN's weights and queues are random flax leaves
carried into the port. The two packages cannot share a random stream, so
inside the test the dropouts of both are the identity, and the port's cycle
start is the one the JAX step draws from its state's key. Checked after one
step: every loss key within rtol 1e-3, and the post-step deltas of net, gmn,
dis and tgcn as `test_torch_train_step.py` checks them, the BatchNorm
running statistics (the FPN's and the TGCN's), the seed banks and the queues.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from flax import linen as fnn

from graphecho_tpu import config as jconfig
from graphecho_tpu.train.state import Optimizers, create_train_state as jax_create_state
from graphecho_tpu.train.steps import build_models as jax_build_models
from graphecho_tpu.train.steps import make_train_step as jax_make_train_step
from graphecho_tpu.utils.torch_import import fpn_params_from_torch

from test_torch_train_step import (FAST_COMPILE, SCHEDULE, _assert_losses, _batches,
                                   _check_deltas, _delta_close, _fill, _port_snapshot,
                                   _to_port)
from test_torch_train_step import _cfg as _main_cfg

from graphecho_torch import config as tconfig
from graphecho_torch import entrypoints
from graphecho_torch.convert import from_flax
from graphecho_torch.models import attention
from graphecho_torch.ops import knn
from graphecho_torch.ops import pairwise_mlp as pm
from graphecho_torch.train import cycle
from graphecho_torch.train.state import create_train_state
from graphecho_torch.train.steps import build_models, check_supported, make_train_step


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of a thread per core oversubscribes the machine
    (tens of times slower under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


B, HW, T = 2, 64, 2
TGCN_KEYS = ("mlp_conv1.weight", "mlp_conv2.weight", "mr_conv.nn.conv_0.weight", "pos_embed",
             "graph_attention.linear_q.weight", "graph_attention.layer_norm.weight",
             "pred_conv.weight", "node_dis_0.weight", "node_dis_out.weight")


def _cfg():
    c = _main_cfg("cardiac")
    sch = jconfig.ScheduleConfig(**SCHEDULE)
    return dataclasses.replace(
        c,
        train=dataclasses.replace(
            c.train, temporal_graph=True, cyc_loss=True,
            tgcn=jconfig.ComponentConfig(opt=jconfig.OptimizerConfig("SGD", 2.5e-3), sch=sch)),
        model=dataclasses.replace(c.model, fused_fpn_forwards=True),
        tgcn=jconfig.TGCNConfig(input_dim=32, hidden_dim=32, clip_shape=(T, 4, 4), knn_k=3,
                                cluster_method="momentum_queue", queue_size=6,
                                source_class=6, target_class=6))


def _batch():
    """`_batches`'s frames plus one clip a domain of the same scene and one
    64-frame cycle clip."""
    batch = _batches(2, 1)[0]
    rng = np.random.RandomState(12)
    clip = lambda: (rng.rand(1, T, HW, HW, 1) * 0.6).astype(np.float32)  # noqa: E731
    batch.update(temp_imgs_source=clip(), temp_imgs_target=clip(),
                 temp_masks=np.repeat(batch["masks"][:1, None], T, axis=1),
                 update_idx_source=np.array([2], np.int32),
                 update_idx_target=np.array([5], np.int32),
                 cyc_imgs=(rng.rand(64, HW, HW, 1) * 0.6).astype(np.float32))
    return batch


def _jax_cycle_starts(rng, n_clips, n_starts):
    """The start indices the JAX step draws (`graphecho_tpu/train/steps.py`:
    the step key split 7 ways, the sixth split per clip)."""
    _, step_rng = jax.random.split(rng)
    k_cyc = jax.random.split(step_rng, 7)[5]
    return torch.tensor([int(jax.random.randint(k, (), 0, n_starts))
                         for k in jax.random.split(k_cyc, n_clips)])


def test_one_step_with_every_branch_matches_jax(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(attention, "dropout", lambda x, *a, **k: x)
    batch = _batch()
    jcfg = _cfg()
    # the port checkpoints its backbone blocks too (remat changes no number)
    tcfg = _to_port(jcfg)
    tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(tcfg.model, remat=True))
    tstate = create_train_state(tcfg, build_models(tcfg), torch.device("cpu"))

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
    tgcn_stats = jax.tree_util.tree_map(lambda s: np.ones(s.shape, np.float32),
                                        shapes.tgcn_batch_stats)
    jstate = zeros.replace(
        net_params=net_params, net_batch_stats=net_stats,
        gmn_params=_fill(shapes.gmn_params, 6), dis_params=_fill(shapes.dis_params, 7),
        tgcn_params=_fill(shapes.tgcn_params, 8), tgcn_batch_stats=tgcn_stats,
        sr_seed=rng.randn(*shapes.sr_seed.shape).astype(np.float32),
        tg_seed=rng.randn(*shapes.tg_seed.shape).astype(np.float32),
        queue_source=queues[0] / np.linalg.norm(queues[0], axis=0),
        queue_target=queues[1] / np.linalg.norm(queues[1], axis=0))
    # target pseudo-labels far from the 0.5 threshold: channel 0 never fires,
    # channel 1 always does
    jstate.net_params["conv3"]["bias"] = np.asarray([-8.0, 8.0], np.float32)
    fields = ("net_params", "net_batch_stats", "gmn_params", "dis_params", "tgcn_params",
              "tgcn_batch_stats", "sr_seed", "tg_seed", "queue_source", "queue_target")
    tstate.load_converted(from_flax({f: getattr(jstate, f) for f in fields}))

    starts = _jax_cycle_starts(jstate.rng, 1, cycle.n_starts())
    monkeypatch.setattr(cycle, "draw_starts", lambda *a, **k: starts)
    step = jax.jit(jax_make_train_step(jcfg, models, opts), compiler_options=FAST_COMPILE)
    t0 = _port_snapshot(tstate)
    t0["tgcn"] = {k: v.clone() for k, v in tstate.tgcn.module.state_dict().items()}
    j1, jm = step(jstate, batch)
    j1 = jax.tree_util.tree_map(np.asarray, j1)
    tm = make_train_step(tcfg)(tstate, batch)

    jm = {k: float(v) for k, v in jm.items()}
    for k in ("temporal_graph_loss", "cyc_loss", "tgcn_clustering_loss", "tgcn_node_dis_loss",
              "temp_node_loss", "temp_mat_loss_aff"):
        assert tm[k] != 0, k
    _assert_losses(jm, tm, "every branch, step 0")
    t1 = _port_snapshot(tstate)
    _check_deltas("every branch", jstate, j1, t0, t1, "back_bone.block_5.0.weight")
    tg0, tg1 = (from_flax({"tgcn_params": s.tgcn_params,
                           "tgcn_batch_stats": s.tgcn_batch_stats})["tgcn"] for s in (jstate, j1))
    tgcn_now = tstate.tgcn.module.state_dict()
    for k in TGCN_KEYS:
        _delta_close(tg1[k] - tg0[k], tgcn_now[k] - t0["tgcn"][k], f"every branch tgcn.{k}",
                     rel=0.02)
    # BatchNorm statistics: the FPN's (one fused forward and the cycle clip's)
    # and the TGCN's (T frames, then the head)
    want = from_flax({"net_params": j1.net_params, "net_batch_stats": j1.net_batch_stats})["fpn"]
    stats = [(k, v, want[k]) for k, v in t1["fpn"].items() if "running" in k]
    stats += [(k, tgcn_now[k], tg1[k]) for k in tgcn_now if "running" in k]
    for k, got, w in stats:
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-3, atol=1e-4, err_msg=k)
    for name in ("sr_seed", "tg_seed", "queue_source", "queue_target"):
        np.testing.assert_allclose(getattr(tstate, name).numpy(), getattr(j1, name),
                                   atol=1e-3, err_msg=name)
    moved = np.abs(tstate.queue_source.numpy() - jstate.queue_source).max(axis=0) > 0
    assert moved.tolist() == [i == 2 for i in range(6)]


def test_every_train_branch_is_ported():
    """The port refuses only the data-parallel mesh and bf16 compute; the
    temporal branch needs the graph-matching module, as in the JAX package."""
    cfg = tconfig.cardiac_uda_config(temporal_graph=True, cyc_loss=True)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, remat=True,
                                                             fused_fpn_forwards=True))
    check_supported(cfg)
    for model, train in (({"compute_dtype": "bfloat16"}, {}), ({}, {"mesh_data": 2})):
        bad = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model),
                                  train=dataclasses.replace(cfg.train, **train))
        with pytest.raises(NotImplementedError, match="not ported"):
            check_supported(bad)
    no_gm = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, graph_matching=False, discriminator=False))
    with pytest.raises(ValueError, match="requires graph_matching"):
        build_models(no_gm)


def test_entry_points_pass_the_branch_switches_to_the_step(monkeypatch):
    seen = []
    monkeypatch.setattr(entrypoints, "_run", lambda cfg, *args: seen.append(cfg))
    entrypoints.train_cardiac_uda(temporal_graph=True, cyc_loss=True)
    entrypoints.train_camus_echo(temporal_graph=True)
    assert (seen[0].train.temporal_graph, seen[0].train.cyc_loss) == (True, True)
    assert (seen[1].train.temporal_graph, seen[1].train.cyc_loss) == (True, False)
    assert seen[0].model.backbone == "VGG16" and seen[1].model.backbone == "resnet"


def test_train_cardiac_uda_with_every_branch_runs_on_cpu():
    """The entry point with the temporal branch and the cycle loss, shrunk
    (64², widths 32, clips 2 + 2 of 4 frames, a 24-frame cycle clip): two
    steps and validation, every loss finite, no kernel launched."""
    cfg = tconfig.cardiac_uda_config(temporal_graph=True, cyc_loss=True)
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, img_crop=(64, 64), batch_size=4),
        model=dataclasses.replace(cfg.model, fpn_channels=32, semantic_channels=16,
                                  vgg_spec=((8, 1), (16, 1), (16, 1), (32, 1), (32, 1))),
        gmodule=dataclasses.replace(cfg.gmodule, in_channels=32, nodes_per_class=16),
        dis=dataclasses.replace(cfg.dis, in_channels=32),
        tgcn=dataclasses.replace(cfg.tgcn, input_dim=32, hidden_dim=32, clip_shape=(4, 4, 4)),
        cycle=dataclasses.replace(cfg.cycle, clip_length=24))
    knn.reset_launch_counts()
    pm.reset_launch_counts()
    trainer = entrypoints.train_cardiac_uda(num_epochs=1, steps_per_epoch=2, n_eval=1,
                                            device="cpu", cfg=cfg)
    means = trainer.last_epoch_metrics
    assert means["steps"] == 2 and trainer.state.step == 2
    losses = [k for k in means if k.endswith("loss")]
    assert {"temporal_graph_loss", "cyc_loss", "tgcn_node_dis_loss", "temp_node_loss"} <= set(
        losses)
    for k in losses:
        assert np.isfinite(means[k]), k
    assert means["cyc_loss"] != 0 and means["temporal_graph_loss"] != 0
    assert all(np.isfinite(d) for d in trainer.last_dices.values())
    assert knn.LAUNCHES["knn"] == 0 and not any(pm.LAUNCHES.values())


@pytest.mark.parametrize("recipe", ["camus_temporal", "cardiac_full"])
def test_profile_recipes_are_the_jax_package_profile_recipes(recipe):
    """`python -m graphecho_torch.profile_step --recipe camus_temporal /
    cardiac_full` profiles the configs of `scripts/profile_train_step.py`."""
    import importlib.util
    from pathlib import Path

    from graphecho_torch.profile_step import RECIPES

    path = Path(__file__).resolve().parent.parent / "scripts" / "profile_train_step.py"
    spec = importlib.util.spec_from_file_location("profile_train_step", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert RECIPES[recipe]() == _to_port(script._cfg(False, recipe))
