"""Config-knob liveness on the port, the counterpart of
`tests/test_config_knobs.py`.

Every leaf and property of `graphecho_torch.config.ExperimentConfig` is either
LIVE, with a pointer to the module of `graphecho_torch/` that reads it (the
test checks that the module names the knob), or INFORMATIONAL, documented as
such where it is defined. The registry test fails when a knob lands in
neither. The spot checks show that the knobs the JAX package's review found
dead change real computation in the port too: `class_threshold`,
`SinkhornConfig`, `head_in_cfg` (GN trains, BN is refused), a discriminator
without graph matching is refused, and `grl_applied_domain` reaches the
discriminators.
"""

import dataclasses
import re
from pathlib import Path

import pytest
import torch

from test_config_knobs import _leaf_keys
from test_torch_convergence import port_config
from test_train_step import tiny_config

from graphecho_torch.config import ExperimentConfig, SinkhornConfig, TGCNConfig
from graphecho_torch.data.synthetic import SyntheticEchoData
from graphecho_torch.models.graph_matching import GModule
from graphecho_torch.models.initializers import initialize
from graphecho_torch.models.tgcn import TGCN
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


PACKAGE = Path(__file__).resolve().parent.parent / "graphecho_torch"

# `OwnerDataclass.field` -> the module of graphecho_torch/ that reads it
LIVE = {
    "OptimizerConfig.opt_name": "train/schedule.py::build_optimizer",
    "OptimizerConfig.lr": "train/schedule.py::build_optimizer",
    "OptimizerConfig.weight_decay": "train/schedule.py::build_optimizer",
    "OptimizerConfig.momentum": "train/schedule.py::build_optimizer",
    "OptimizerConfig.betas": "train/schedule.py::build_optimizer",
    "ScheduleConfig.steps": "train/schedule.py::warmup_multistep_factor",
    "ScheduleConfig.gamma": "train/schedule.py::warmup_multistep_factor",
    "ScheduleConfig.warmup_factor": "train/schedule.py::warmup_multistep_factor",
    "ScheduleConfig.warmup_iters": "train/schedule.py::warmup_multistep_factor",
    "ScheduleConfig.warmup_method": "train/schedule.py::warmup_multistep_factor",
    "ModelConfig.backbone": "train/steps.py::build_fpn",
    "ModelConfig.num_classes": "train/steps.py::build_fpn",
    "ModelConfig.fpn_channels": "train/steps.py::build_fpn",
    "ModelConfig.semantic_channels": "train/steps.py::build_fpn",
    "ModelConfig.compute_dtype": "train/steps.py::build_models",
    "ModelConfig.vgg_spec": "train/steps.py::build_fpn",
    "ModelConfig.remat": "train/steps.py::build_fpn",
    "ModelConfig.fused_fpn_forwards": "train/steps.py::make_train_step",
    "NodeSamplerConfig.pos_budget_per_level": "ops/sampling.py::sample_nodes",
    "NodeSamplerConfig.bg_ratio": "ops/sampling.py (bg_budget_per_level)",
    "NodeSamplerConfig.bg_budget_per_level": "ops/sampling.py::sample_nodes",
    "NodeSamplerConfig.class_threshold": "train/steps.py (target score maps)",
    "NodeSamplerConfig.fpn_strides": "ops/sampling.py::sample_nodes",
    "NodeSamplerConfig.sizes_of_interest": "ops/sampling.py::sample_nodes",
    "GModuleConfig.in_channels": "train/steps.py::build_fpn",
    "GModuleConfig.num_classes": "models/graph_matching.py::GModule",
    "GModuleConfig.matching_cfg": "models/graph_matching.py (matching loss)",
    "GModuleConfig.matching_loss_type": "models/graph_matching.py",
    "GModuleConfig.with_cluster_update": "models/graph_matching.py (seeds)",
    "GModuleConfig.with_semantic_completion": "models/graph_matching.py",
    "GModuleConfig.with_quadratic_matching": "models/graph_matching.py",
    "GModuleConfig.with_domain_interaction": "models/graph_matching.py",
    "GModuleConfig.with_complete_graph": "models/graph_matching.py",
    "GModuleConfig.with_node_dis": "models/graph_matching.py",
    "GModuleConfig.with_global_graph": "models/graph_matching.py",
    "GModuleConfig.node_dis_place": "models/graph_matching.py",
    "GModuleConfig.head_in_cfg": "models/graph_matching.py (LN head or GRAPHHead)",
    "GModuleConfig.with_score_weight": "models/graph_matching.py (node CE)",
    "GModuleConfig.weight_matching": "models/graph_matching.py",
    "GModuleConfig.weight_nodes": "models/graph_matching.py",
    "GModuleConfig.weight_dis": "models/graph_matching.py",
    "GModuleConfig.lambda_dis": "models/graph_matching.py (GRL)",
    "GModuleConfig.sinkhorn_iters": "models/graph_matching.py",
    "GModuleConfig.dropout": "models/graph_matching.py (attention)",
    "GModuleConfig.seed_cluster_min_nodes": "models/graph_matching.py",
    "GModuleConfig.spectral_solver": "models/graph_matching.py (ops/spectral.py)",
    "GModuleConfig.nodes_per_class": "models/graph_matching.py (slots)",
    "DiscriminatorConfig.num_convs": "train/steps.py::build_models",
    "DiscriminatorConfig.in_channels": "train/steps.py::build_models",
    "DiscriminatorConfig.grad_reverse_lambda": "train/steps.py::build_models",
    "DiscriminatorConfig.grl_applied_domain": "train/steps.py::build_models",
    "DiscriminatorConfig.loss_weight": "train/steps.py (loss_adv_*)",
    "TGCNConfig.input_dim": "models/tgcn.py::TGCN",
    "TGCNConfig.hidden_dim": "models/tgcn.py::TGCN",
    "TGCNConfig.clip_shape": "models/tgcn.py (grid + pos_embed)",
    "TGCNConfig.knn_k": "models/tgcn.py (recurrent kNN graph)",
    "TGCNConfig.cluster_method": "models/tgcn.py (clustering loss)",
    "TGCNConfig.transport_method": "models/tgcn.py (transport loss)",
    "TGCNConfig.queue_size": "train/state.py (the queues)",
    "TGCNConfig.queue_momentum": "models/tgcn.py::queue_update",
    "TGCNConfig.pool_ratios": "models/tgcn.py::TGCN (mlp_conv1 width)",
    "TGCNConfig.source_class": "models/tgcn.py (classifiers)",
    "TGCNConfig.target_class": "models/tgcn.py (classifiers)",
    "SinkhornConfig.eps": "models/tgcn.py (sinkhorn_distance transport)",
    "SinkhornConfig.max_iter": "models/tgcn.py (sinkhorn_distance transport)",
    "SinkhornConfig.reduction": "models/tgcn.py (sinkhorn_distance transport)",
    "CycleConfig.target_region": "train/cycle.py::seg_cycle",
    "CycleConfig.cyc_off": "train/cycle.py::seg_cycle",
    "CycleConfig.chunk_size": "train/cycle.py::seg_cycle",
    "CycleConfig.temperature": "train/cycle.py::seg_cycle",
    "CycleConfig.clip_length": "train/steps.py (cyc clip split)",
    "DataConfig.img_res": "real_training.py (loaders)",
    "DataConfig.img_crop": "real_training.py (loaders)",
    "DataConfig.clip_length": "real_training.py (temporal clips)",
    "DataConfig.total_length": "real_training.py (CardiacUDA clips)",
    "DataConfig.view_num": "real_training.py",
    "DataConfig.seg_parts": "real_training.py",
    "DataConfig.batch_size": "real_training.py (loaders)",
    "DataConfig.target_batch_mult": "data/synthetic.py + real_training.py",
    "DataConfig.num_workers": "real_training.py (loader threads)",
    "TrainConfig.num_epochs": "train/trainer.py::Trainer.train",
    "TrainConfig.cyc_loss": "train/steps.py (branch gate)",
    "TrainConfig.temporal_graph": "train/steps.py (branch gate)",
    "TrainConfig.graph_matching": "train/steps.py (branch gate)",
    "TrainConfig.discriminator": "train/steps.py (branch gate)",
    "TrainConfig.seg_parts": "train/trainer.py (per-part dice)",
    "TrainConfig.record_params": "train/trainer.py (parameter histograms)",
    "TrainConfig.save_dir": "real_training.py (checkpoints)",
    "TrainConfig.log_dir": "real_training.py (summary writer)",
    "TrainConfig.seed": "train/state.py::create_train_state",
    "TrainConfig.debug_nans": "train/trainer.py (anomaly detection)",
    "TrainConfig.mesh_data": "train/trainer.py::create_mesh",
}

# documented as informational where they are defined (`config.py`)
INFORMATIONAL = {
    "ModelConfig.in_channels": "the convs take their input width from the data",
    "NodeSamplerConfig.bg_threshold": "the reference's act-map sampler branch is dead "
                                      "upstream and left out (ops/sampling.py)",
}


def test_every_config_leaf_is_classified():
    keys = _leaf_keys(ExperimentConfig(), set())
    unclassified = keys - set(LIVE) - set(INFORMATIONAL)
    assert not unclassified, f"new config knobs lack a LIVE/INFORMATIONAL entry: {unclassified}"
    stale = (set(LIVE) | set(INFORMATIONAL)) - keys
    assert not stale, f"registry entries for removed knobs: {stale}"
    assert not set(LIVE) & set(INFORMATIONAL)


@pytest.mark.parametrize("knob", sorted(LIVE))
def test_each_live_knob_is_read_where_its_pointer_says(knob):
    field = knob.split(".")[1]
    module = LIVE[knob].split()[0].split("::")[0]
    text = (PACKAGE / module).read_text()
    assert re.search(rf"\b{field}\b", text), f"{knob}: {module} does not name {field}"


def test_informational_knobs_are_documented_and_bg_threshold_is_never_read():
    config = (PACKAGE / "config.py").read_text()
    for knob in INFORMATIONAL:
        field = knob.split(".")[1]
        assert re.search(rf"INFORMATIONAL[^\n]*\n(\s*#[^\n]*\n)*\s*{field}:", config), knob
    readers = [p.name for p in PACKAGE.rglob("*.py")
               if p.name != "config.py" and "bg_threshold" in p.read_text()]
    assert not readers, readers


def _with_sampler(cfg, **kw):
    return dataclasses.replace(cfg, gmodule=dataclasses.replace(
        cfg.gmodule, sampler=dataclasses.replace(cfg.gmodule.sampler, **kw)))


def _tiny(**train):
    return port_config(tiny_config(**train))


def _one_step(cfg, batch):
    state = create_train_state(cfg, build_models(cfg), torch.device("cpu"))
    before = {k: v.clone() for k, v in state.gmn.module.state_dict().items()} \
        if state.gmn is not None else {}
    metrics = make_train_step(cfg)(state, batch)
    return state, before, {k: v.item() for k, v in metrics.items()}


def test_class_threshold_changes_target_sampling():
    """An extreme pseudo-label threshold empties the target boxes and moves
    the graph losses."""
    cfg = _tiny(graph_matching=True, discriminator=False)
    batch = SyntheticEchoData(cfg, seed=0).train_batch()
    _, _, m_default = _one_step(cfg, batch)
    _, _, m_hi = _one_step(_with_sampler(cfg, class_threshold=1.0 - 1e-9), batch)
    assert any(m_default[k] != pytest.approx(m_hi[k])
               for k in ("node_loss", "mat_loss_aff", "dis_loss")), (m_default, m_hi)


def test_sinkhorn_config_changes_transport_loss():
    """SinkhornConfig reaches the TGCN's sinkhorn transport."""
    cfg = TGCNConfig(input_dim=16, hidden_dim=16, clip_shape=(2, 4, 4), knn_k=3,
                     cluster_method=None, transport_method="sinkhorn_distance",
                     pool_ratios=(4, 2, 1, 1))
    gen = torch.Generator().manual_seed(5)
    clips = [torch.randn(2, 2, 16, s, s, generator=gen) for s in (16, 8, 4, 4)]
    nodes, valid = torch.randn(10, 16, generator=gen), torch.ones(10, dtype=torch.bool)
    queues = (torch.zeros(16, 5), torch.zeros(16, 5))
    idx = (torch.tensor([0]), torch.tensor([1]))

    ref = TGCN(cfg, sinkhorn=SinkhornConfig(eps=0.1, max_iter=5))
    initialize(ref, torch.Generator().manual_seed(0))
    coarse = TGCN(cfg, sinkhorn=SinkhornConfig(eps=5.0, max_iter=1))
    coarse.load_state_dict(ref.state_dict())

    def run(model):
        losses, _ = model.train()(clips, nodes, valid, nodes, valid, queues, idx,
                                  generator=torch.Generator().manual_seed(2))
        return losses["sinkhorn_loss"].item()

    assert run(ref) != pytest.approx(run(coarse)), "SinkhornConfig had no effect"


def test_head_in_gn_path_trains():
    """head_in_cfg='GN' routes the nodes through the GRAPHHead conv tower on
    the maps (reference `graph_matching.py:274-276`): its parameters exist
    and move, and the LN node head is absent."""
    cfg = _tiny(graph_matching=True, discriminator=False)
    cfg = dataclasses.replace(cfg, gmodule=dataclasses.replace(cfg.gmodule, head_in_cfg="GN"))
    state, before, metrics = _one_step(cfg, SyntheticEchoData(cfg, seed=0).train_batch())
    after = state.gmn.module.state_dict()
    head = [k for k in before if k.startswith("graph_head.")]
    assert head and not any(k.startswith("head_in_1.") for k in before)
    assert torch.isfinite(torch.tensor(metrics["total_loss"]))
    assert any(not torch.equal(before[k], after[k]) for k in head), \
        "GRAPHHead parameters did not move: the tower is not in the gradient path"


def test_head_in_bn_rejected():
    cfg = dataclasses.replace(_tiny().gmodule, head_in_cfg="BN")
    with pytest.raises(ValueError, match="head_in_cfg"):
        GModule(cfg)


def test_discriminator_without_graph_matching_rejected():
    with pytest.raises(ValueError, match="graph_matching"):
        build_models(_tiny(graph_matching=False, discriminator=True))


def test_grl_applied_domain_reaches_discriminator():
    cfg = _tiny(graph_matching=True, discriminator=True)
    cfg = dataclasses.replace(cfg, dis=dataclasses.replace(cfg.dis, grl_applied_domain="target"))
    dis = build_models(cfg)["discriminator"]
    assert {d.grl_applied_domain for d in dis.values()} == {"target"}
