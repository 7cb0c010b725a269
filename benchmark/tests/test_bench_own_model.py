"""A configuration that brings its own model: a reference module that
exports `config`, `TrainReference` (a subclass with its own `build_fpn`)
and `kernel_call_shapes` is taken through the reference step,
the FLOP count and the kernel-call list, though the uda FPN cannot build
its backbone. And the two configurations that the benchmark has count
exactly what they counted before a configuration could bring its model."""

from __future__ import annotations

import sys
import types

import numpy as np
import pytest
import torch
from torch import nn

from benchmark import experiment, work
from benchmark.loops.train import CHECKED_STEPS, make_batch, reference_steps
from benchmark.reference.uda import config as uda_config, step
from benchmark.reference.uda.fpn import FPN

WIDTHS = (8, 16, 24, 32, 40)
CROP = 64


class Strided(nn.Module):
    """Five 3x3 convolutions of stride 2 with a relu: c1..c5 at strides 2
    to 32, a backbone that the uda FPN does not name."""

    out_channels = WIDTHS

    def __init__(self, in_channels: int):
        super().__init__()
        w = (in_channels, *WIDTHS)
        self.convs = nn.ModuleList(nn.Conv2d(a, b, 3, stride=2, padding=1)
                                   for a, b in zip(w, w[1:]))

    def forward(self, x):
        feats = []
        for conv in self.convs:
            x = torch.relu(conv(x))
            feats.append(x)
        return feats


def _build_fpn(cfg):
    m = cfg.model
    return FPN(num_classes=m.num_classes, back_bone=Strided(m.in_channels),
               fpn_channels=m.fpn_channels, semantic_channels=m.semantic_channels,
               in_channels=m.in_channels)


class _TrainReference(step.TrainReference):
    build_fpn = staticmethod(_build_fpn)


@pytest.fixture
def own(monkeypatch):
    """The stub configuration's reference module, found by name as the
    harness finds one, and its experiment at tiny widths with every branch."""
    mod = types.ModuleType("benchmark.reference.own_model_stub")
    # its graph head is the uda one, and so are its kernel calls
    mod.config, mod.TrainReference = uda_config, _TrainReference
    mod.kernel_call_shapes = step.kernel_call_shapes
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    conf = {"factory": "cardiac_uda_config",
            "factory_args": {"temporal_graph": True, "cyc_loss": True},
            "overrides": {"model": {"backbone": "strided", "fpn_channels": 32,
                                    "semantic_channels": 16}}}
    tiny = {"data": {"img_crop": [CROP, CROP], "batch_size": 2},
            "gmodule": {"in_channels": 32, "nodes_per_class": 16},
            "dis": {"in_channels": 32},
            "tgcn": {"input_dim": 32, "hidden_dim": 32, "clip_shape": [4, 4, 4]},
            "cycle": {"clip_length": 24}}
    ref_mod = experiment.reference("own_model_stub")
    return ref_mod, experiment.build(ref_mod.config, conf, {}, tiny)


def test_the_reference_step_builds_and_trains_the_configurations_own_fpn(own):
    ref_mod, cfg = own
    with pytest.raises(ValueError, match="unknown backbone"):
        step.build_fpn(cfg)
    ref = ref_mod.TrainReference(cfg, torch.device("cpu"))
    assert isinstance(ref.models["fpn"].back_bone, Strided)
    assert set(ref.models) == {"fpn", "gmodule", "discriminator", "tgcn"}
    rng = np.random.default_rng(3)
    pool = [make_batch(rng, cfg, True) for _ in range(CHECKED_STEPS)]
    cell = types.SimpleNamespace(seed=2 ** 31 + 5, device=torch.device("cpu"), look=None)
    out = reference_steps(cell, ref_mod, cfg, pool)
    assert len(out["losses"]) == CHECKED_STEPS
    assert {"seg_loss", "temporal_graph_loss", "cyc_loss"} <= set(out["losses"][0])
    assert all(np.isfinite(v) for losses in out["losses"] for v in losses.values())
    # every backbone convolution got a gradient and moved
    moved = out["deltas"]["fpn"]
    for i in range(len(WIDTHS)):
        assert out["grads"]["fpn"][f"back_bone.convs.{i}.weight"] > 0
        assert moved[f"back_bone.convs.{i}.weight"] > 0


def test_the_step_flops_are_counted_on_the_configurations_own_fpn(own):
    ref_mod, cfg = own
    with pytest.raises(ValueError, match="unknown backbone"):
        work.frame_flops(cfg, step)  # the uda FPN cannot build it
    f = work.frame_flops(cfg, ref_mod)
    # two FLOPs per multiply-add of each stride-2 3x3 convolution
    w, side, backbone = (cfg.model.in_channels, *WIDTHS), CROP, 0
    for cin, cout in zip(w, w[1:]):
        side //= 2
        backbone += 2 * cout * cin * 9 * side * side
    assert f["backbone"] == backbone
    assert f["fpn"] > f["backbone"] > 0 and f["discriminators"] > 0
    # 2 source + 2 target + 2 x 1 clips of 4 frames through the FPN, the
    # 24-frame cycle clip through the backbone, 4 frames through the
    # discriminators, times 3
    assert work.train_step_flops(cfg, ref_mod) == 3 * (12 * f["fpn"] + 24 * f["backbone"]
                                                       + 4 * f["discriminators"])


def test_the_kernel_calls_come_from_the_configuration(own):
    ref_mod, cfg = own
    calls = ref_mod.kernel_call_shapes(cfg)
    n = cfg.gmodule.num_classes * cfg.gmodule.nodes_per_class
    assert calls == {"pairwise_mlp_fwd": [(n, n, 64)] * 2, "pairwise_mlp_bwd": [(n, n, 64)] * 2,
                     "spectral": [(5, 17)] * 4, "knn": [(2, 16, 16, 32, 9)] * 4}


def test_traced_calls_sum_over_shapes_and_refuse_a_count_apart():
    """A model whose kNN calls come at several shapes (a ViG's Graphers): a
    reader gets each traced call's shape, and nothing where the list's count
    is not the wrapper's."""
    per_step = {"knn": [(2, 3136, 196, 48, 9, False, 3136 * 196), (2, 64, 64, 256, 9)]}
    s = {"kernel_call_shapes": per_step, "kernel_launches": {"knn": 6}, "units": 3}
    calls = work.traced_calls(s, "knn")
    assert calls == per_step["knn"] * 3
    least = sum(work.bound_s(*work.knn_work(*c)) for c in calls)
    assert least == pytest.approx(3 * (work.bound_s(*work.knn_work(*per_step["knn"][0]))
                                       + work.bound_s(*work.knn_work(*per_step["knn"][1]))))
    assert work.traced_calls(dict(s, kernel_launches={"knn": 5}), "knn") is None
    assert work.traced_calls(dict(s, kernel_launches={}), "knn") is None
    assert work.traced_calls(s, "pairwise_mlp_fwd") is None


# what the tree counted before a configuration could bring its own model
PINNED = {
    "camus": ("paper-f32",
              {"fpn": 5918240768, "backbone": 2003181568, "discriminators": 4935744000},
              5730903957504, {"pairwise_mlp": (112, 112, 512)}),
    "cardiac": ("full-f32",
                {"fpn": 59832795136, "backbone": 39938162688, "discriminators": 25694208000},
                23261320052736,
                {"pairwise_mlp": (560, 560, 512), "knn": (8, 64, 64, 256, 9)}),
}


@pytest.mark.parametrize("config_name", sorted(PINNED))
def test_the_existing_configurations_count_what_they_counted(config_name):
    traffic, frame, step_flops, shapes = PINNED[config_name]
    ref_mod = experiment.reference(config_name)
    cfg = experiment.build(ref_mod.config, experiment.load_json("configs", config_name),
                           experiment.load_json("traffic", traffic))
    assert work.frame_flops(cfg, ref_mod) == frame
    assert work.train_step_flops(cfg, ref_mod) == step_flops
    assert work.kernel_shapes(cfg) == shapes
    # the calls a step: one GModule call (two with the temporal branch),
    # each an affinity forward and backward and two spectral splits; one
    # kNN graph a TGCN clip frame
    calls = ref_mod.kernel_call_shapes(cfg)
    gm = 2 if "knn" in shapes else 1
    want = {"pairwise_mlp_fwd": [shapes["pairwise_mlp"]] * gm,
            "pairwise_mlp_bwd": [shapes["pairwise_mlp"]] * gm,
            "spectral": [(cfg.gmodule.num_classes, 113)] * 2 * gm}
    if "knn" in shapes:
        want["knn"] = [shapes["knn"]] * 8
    assert calls == want
