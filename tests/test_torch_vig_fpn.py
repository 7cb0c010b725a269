"""The FPN on a Pyramid ViG-S backbone (`FPN(back_bone="pvig_s")`), on the
CPU, against the benchmark's plain reference (`benchmark/reference/pvig.py`
inside `benchmark/reference/uda/fpn.py`), from the benchmark's seeded weights
(`benchmark/weights.py`).

The widths are shrunk (channels 8/16/24/32, k 3) at the published block
pattern 2/2/6/2, so that every key pooling (4, 2, 1, 1) and every dilation
(1, 2, 3) occurs; at a 96² crop stage 4 holds 3 x 3 nodes, as many as its
k·d = 9. The forward, and three train steps of the FPN under the cardiac
recipe's segmentation loss and the FPN's optimizer: the losses, each
leaf's first gradient and each leaf's change. The reference follows the
program's kNN graphs where they are its own up to near ties
(`benchmark/vig_graphs.py`): in the forward and the first step every graph
is its own, and no row is left unfollowed. Also: the backbone's maps are
`DeepGCN`'s, the reference's kNN calls are the train step's, its FLOPs
count on the meta device, and it imports nothing of the port or JAX."""

import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import experiment, weights, work
from benchmark.loops.train import _first_grads
from benchmark.reference import cardiac_pvig_s as ref_cardiac, pvig as ref_vig
from benchmark.reference.uda import losses as ref_losses
from benchmark.reference.uda.step import Optimizer, leaf_norms, median
from benchmark.vig_graphs import GRAPHS
from graphecho_torch import config as C
from graphecho_torch.data.synthetic import SyntheticEchoData
from graphecho_torch.models import tgcn as program_tgcn, vig
from graphecho_torch.train import losses
from graphecho_torch.train.state import create_train_state
from graphecho_torch.train.steps import build_fpn, build_models, check_supported, make_train_step

REPO = Path(__file__).resolve().parents[1]
TINY_VIG = {"blocks": (2, 2, 6, 2), "channels": (8, 16, 24, 32), "k": 3}
CROP = 96
SEED = 2 ** 31 + 17


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of a thread per core oversubscribes the machine
    (tens of times slower under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tiny_vig(monkeypatch):
    """Both sides' Pyramid ViG-S shrunk to `TINY_VIG`; the program's graph
    builder as it was afterwards (the reference's record wraps it)."""
    monkeypatch.setattr(vig, "dilated_knn_graph", vig.dilated_knn_graph)
    monkeypatch.setattr(vig, "PVIG_S", dict(TINY_VIG))
    monkeypatch.setattr("graphecho_torch.models.fpn.PVIG_S", dict(TINY_VIG))
    monkeypatch.setattr(ref_vig, "PVIG_S", dict(TINY_VIG))


def _shrink(cfg, batch=2):
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, img_crop=(CROP, CROP), batch_size=batch),
        model=dataclasses.replace(cfg.model, fpn_channels=32, semantic_channels=16),
        gmodule=dataclasses.replace(cfg.gmodule, in_channels=32, nodes_per_class=8),
        dis=dataclasses.replace(cfg.dis, in_channels=32),
        tgcn=dataclasses.replace(cfg.tgcn, input_dim=32, hidden_dim=32, clip_shape=(2, 4, 4)),
        cycle=dataclasses.replace(cfg.cycle, clip_length=24))


def _configs():
    """The cell's experiment, shrunk, on both sides."""
    conf = json.loads((REPO / "benchmark/configs/cardiac_pvig_s.json").read_text())
    return (_shrink(experiment.build(C, conf, {})),
            _shrink(experiment.build(ref_cardiac.config, conf, {})))


def _frames(cfg, n, seed):
    data = SyntheticEchoData(cfg, seed=seed, batch_size=n)
    imgs, masks = data._frames(n)
    return (torch.from_numpy(imgs).permute(0, 3, 1, 2).contiguous(),
            torch.from_numpy(masks).permute(0, 3, 1, 2).contiguous())


def test_fpn_on_pvig_s_follows_the_plain_reference_for_three_steps(tiny_vig, monkeypatch):
    cfg, ref_cfg = _configs()
    fpn = build_fpn(cfg)
    assert isinstance(fpn.back_bone, vig.PyramidViG)
    ref = ref_cardiac.TrainReference.build_fpn(ref_cfg)
    init = weights.make({"fpn": fpn}, SEED, torch.device("cpu"))["fpn"]
    assert init.keys() == weights.make({"fpn": ref}, SEED, torch.device("cpu"))["fpn"].keys()
    fpn.load_state_dict(init)
    ref.load_state_dict(init)
    batches = [_frames(cfg, 2, seed) for seed in range(3)]
    graphers = sum(TINY_VIG["blocks"])

    # the forward, train mode, from the same weights
    GRAPHS.arm(graphers)
    with torch.no_grad():
        logits, feats = fpn.train()(batches[0][0])
        GRAPHS.follow()
        ref_logits, ref_feats = ref.train()(batches[0][0])
    torch.testing.assert_close(logits, ref_logits, rtol=1e-4, atol=1e-5)
    for a, b in zip(feats, ref_feats):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    assert [(c["missing"], c["rejected"], c["followed"]) for c in GRAPHS.calls] == [
        (False, 0, 0)] * graphers

    # three steps: each side's segmentation loss, backward and optimizer
    fpn.load_state_dict(init)
    ref.load_state_dict(init)
    state = create_train_state(cfg, {"fpn": fpn}, torch.device("cpu"), seed=1)
    fpn.load_state_dict(init)
    opt = Optimizer(ref, ref_cfg.train.net)
    got, want, first, seen = [], [], None, []
    for i, (imgs, masks) in enumerate(batches):
        GRAPHS.arm(graphers)
        state.net.opt.zero_grad(set_to_none=True)
        pred, _ = fpn(imgs)
        loss = losses.dice_loss(pred, masks) + losses.bce_with_logits(pred, masks)
        loss.backward()
        state.net.apply_gradients(i)
        got.append(loss.item())
        if i == 0:
            first = leaf_norms(_first_grads(state.net))
        GRAPHS.follow()
        pred, _ = ref(imgs)
        loss = ref_losses.dice_loss(pred, masks) + ref_losses.bce_with_logits(pred, masks)
        loss.backward()
        opt.step(i)
        want.append(loss.item())
        seen.append(GRAPHS.report(1)[0])
    assert [s["calls"] for s in seen] == [graphers] * 3
    assert [s["rejected"] for s in seen] == [0, 0, 0]
    assert seen[0]["followed"] == 0 and seen[0]["gap_max"] == 0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    ref_first = leaf_norms(opt.first_grads)
    med = median(list(ref_first.values()))
    for name, r in ref_first.items():
        assert abs(first[name] - r) <= 1e-4 * max(r, med), name
    # the change over three steps, of every leaf that a gradient moves
    moved = leaf_norms({n: p.detach() - init[n] for n, p in fpn.named_parameters()})
    ref_moved = leaf_norms({n: p.detach() - init[n] for n, p in ref.named_parameters()})
    med = median(list(ref_moved.values()))
    for name, r in ref_moved.items():
        if ref_first[name] >= 1e-3 * median(list(ref_first.values())):
            assert abs(moved[name] - r) <= 1e-3 * max(r, med), name
    assert moved["back_bone.grapher_11.graph_conv.gc.gconv.nn.conv_0.weight"] > 0


def test_the_backbone_maps_are_deepgcns(tiny_vig):
    """`PyramidViG` is `DeepGCN` without its head: on DeepGCN's weights its
    maps give DeepGCN's logits, at strides 4, 4, 8, 16, 32."""
    kw = dict(TINY_VIG, img_size=CROP, in_channels=1)
    model = vig.DeepGCN(**kw, n_classes=10).eval()
    vig.initialize(model, torch.Generator().manual_seed(0))
    backbone = vig.PyramidViG(**kw).eval()
    head = {k for k in model.state_dict() if k.startswith("pred_")}
    assert set(model.state_dict()) - head == set(backbone.state_dict())
    backbone.load_state_dict({k: v for k, v in model.state_dict().items() if k not in head})
    x = torch.randn(2, 1, CROP, CROP, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        maps = backbone(x)
        want = model(x)
        pooled = maps[-1].mean(dim=(2, 3), keepdim=True)
        got = model.pred_conv2(model.act(model.pred_bn(model.pred_conv1(pooled))))[:, :, 0, 0]
    assert torch.equal(got, want)
    assert backbone.out_channels == (8, 8, 16, 24, 32)
    assert [tuple(m.shape[1:]) for m in maps] == [
        (c, CROP // s, CROP // s) for c, s in zip(backbone.out_channels, (4, 4, 8, 16, 32))]


def test_the_published_backbone_and_its_refusals():
    """`pvig_s` at the published widths on 1-channel 256² frames: DeepGCN's
    pvig_s parameters without the classifier head, the position embedding
    64², not 56²; remat, a non-square crop and an unknown backbone are
    refused."""
    cfg = C.cardiac_uda_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone="pvig_s"))
    with torch.device("meta"):
        fpn = build_fpn(cfg)
    b = fpn.back_bone
    assert b.out_channels == (80, 80, 160, 400, 640) and b.blocks == (2, 2, 6, 2)
    assert [b.get_submodule(f"grapher_{i}").graph_conv.dilation for i in range(12)] == [
        1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3]
    assert [b.get_submodule(f"grapher_{i}").r for i in range(12)] == [4, 4, 2, 2] + [1] * 8
    # the published count, less the head, with a 64² embedding and one input channel
    head = 640 * 1024 + 1024 + 2 * 1024 + 1024 * 1000 + 1000
    embedding = 80 * 64 * 64 - 80 * 56 * 56
    stem = 40 * 9 * (1 - 3)
    assert sum(p.numel() for p in b.parameters()) == 27_251_912 - head + embedding + stem
    with pytest.raises(ValueError, match="unknown backbone"):
        build_fpn(dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone="pvig_m")))
    with pytest.raises(ValueError, match="remat"):
        build_fpn(dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, remat=True)))
    with pytest.raises(ValueError, match="square"):
        check_supported(dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, img_crop=(256, 192))))


def _shape(x, y, k, dilation, relative_pos):
    n, c = x.shape[1], x.shape[2]
    m = n if y is None else y.shape[1]
    rel = 0 if relative_pos is None else relative_pos.numel()
    return (x.shape[0], n, m, c, k * dilation, y is None, rel)


def test_the_kernel_calls_are_the_train_steps(tiny_vig, monkeypatch):
    """One CPU train step with every branch calls the kNN graph at the
    shapes, in the order, that the reference's `kernel_call_shapes` lists."""
    cfg, ref_cfg = _configs()
    seen = []
    for owner in (vig, program_tgcn):
        fn = owner.dilated_knn_graph

        def wrapped(x, y=None, k=9, dilation=1, relative_pos=None, *args, _fn=fn, **kwargs):
            seen.append(_shape(x, y, k, dilation, relative_pos))
            return _fn(x, y, k, dilation, relative_pos, *args, **kwargs)

        monkeypatch.setattr(owner, "dilated_knn_graph", wrapped)
    state = create_train_state(cfg, build_models(cfg), torch.device("cpu"), seed=3)
    batch = SyntheticEchoData(cfg, seed=4).train_batch()
    metrics = make_train_step(cfg)(state, batch)
    assert math.isfinite(float(metrics["total_loss"]))
    calls = ref_cardiac.kernel_call_shapes(ref_cfg)
    want = [tuple(c) + (False, 0)[len(c) - 5:] for c in calls["knn"]]
    assert seen == want
    # the FPN on source, target and clip frames, the TGCN, the cycle clip
    assert len(want) == 4 * sum(TINY_VIG["blocks"]) + cfg.tgcn.clip_shape[0]
    assert calls["pairwise_mlp_fwd"] == ref_cardiac.step.kernel_call_shapes(ref_cfg)[
        "pairwise_mlp_fwd"]


def test_the_step_flops_count_on_the_reference(tiny_vig):
    _, ref_cfg = _configs()
    f = work.frame_flops(ref_cfg, ref_cardiac)
    assert f["fpn"] > f["backbone"] > 0
    d = ref_cfg.data
    frames = 2 * d.batch_size + 2 * (d.batch_size // 2) * ref_cfg.tgcn.clip_shape[0]
    assert work.train_step_flops(ref_cfg, ref_cardiac) == 3 * (
        frames * f["fpn"] + ref_cfg.cycle.clip_length * f["backbone"]
        + 2 * d.batch_size * f["discriminators"])


def test_the_reference_imports_nothing_of_the_port_or_jax():
    code = ("import sys, benchmark.reference.cardiac_pvig_s, benchmark.reference.pvig; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('graphecho_torch', 'graphecho_tpu', 'jax', 'jaxlib', 'flax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"


def test_the_cardiac_cli_takes_the_backbone(monkeypatch):
    """`train_cardiac_uda --backbone pvig_s` reaches the recipe's config;
    VGG16 stays the default; either way the recipe's background channel is
    left out in evaluation; no checkpoint loads into the ViG."""
    from graphecho_torch import entrypoints, train_cardiac_uda

    seen = []
    monkeypatch.setattr(entrypoints, "_run", lambda cfg, *args: seen.append((cfg, args[-1])))
    train_cardiac_uda.main(["--device", "cpu", "--backbone", "pvig_s"])
    train_cardiac_uda.main(["--device", "cpu"])
    entrypoints.train_camus_echo()
    assert [(c.model.backbone, bg) for c, bg in seen] == [
        ("pvig_s", True), ("VGG16", True), ("resnet", False)]
    with pytest.raises(SystemExit):
        train_cardiac_uda.main(["--device", "cpu", "--backbone", "pvig_s",
                                "--pretrained-backbone", "w.pth"])
