"""The train and eval steps, port of `graphecho_tpu/train/steps.py`.

One train step is the reference's module calls and one joint backward
(`train_camus_echo.py:206-299`, `train_cardiac_uda.py:228-253`): the FPN on
the source batch and, as a separate call, on the target batch (BatchNorm
statistics per call, running stats updated by both), FCOS node sampling, the
GModule, the four per-level discriminators behind gradient reversal; with
`temporal_graph`, one FPN call over every frame of the source and target
clips, a second GModule call on them and the TGCN; with `cyc_loss`, a
backbone forward over the 64-frame cycle clip and its cycle loss. Then one
backward of the summed losses and the Adam/SGD update of each component.
With `fused_fpn_forwards` the source, target and clip frames go through one
FPN call. Loss keys match the reference (`seg_loss`, `dis_loss`,
`node_loss`, `mat_loss_aff`, `mat_loss_qu`, `loss_adv_p2..p5`,
`temporal_graph_loss`, `cyc_loss`, plus `total_loss`); the temporal branch's
parts are reported as `tgcn_*` and `temp_*`.

Batches arrive as NHWC arrays, the JAX package's contract, and are moved to
the state's device and transposed to NCHW once, at entry.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import torch
from torch import nn
from torch.profiler import record_function

from graphecho_torch.config import ExperimentConfig
from graphecho_torch.models.discriminator import Discriminator
from graphecho_torch.models.fpn import FPN
from graphecho_torch.models.graph_matching import GModule
from graphecho_torch.models.tgcn import TGCN
from graphecho_torch.ops.sampling import masks_to_boxes, sample_nodes
from graphecho_torch.train import cycle
from graphecho_torch.train.losses import bce_with_logits, dice_loss
from graphecho_torch.train.metrics import confusion_counts
from graphecho_torch.train.state import DIS_LEVELS, TrainState


# the FPN's compute dtype by `ModelConfig.compute_dtype`; f32 is the
# unconverted path (`models/backbones.py::set_compute_dtype`)
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def check_supported(cfg: ExperimentConfig) -> None:
    """Raise for the train-step options that the port does not implement yet."""
    t, m = cfg.train, cfg.model
    deferred = {
        "mesh_data": (t.mesh_data is not None, "the data-parallel slice"),
        "compute_dtype='bfloat16' in the train step": (
            m.compute_dtype != "float32", "the bf16 train step"),
    }
    for name, (on, where) in deferred.items():
        if on:
            raise NotImplementedError(
                f"{name} is not ported to graphecho_torch yet; it comes with {where} "
                "(ROADMAP.md, Queue 1)")


def build_fpn(cfg: ExperimentConfig) -> FPN:
    """The FPN of `cfg.model`, computing in `cfg.model.compute_dtype`
    (`graphecho_tpu/train/steps.py:60-66`)."""
    m = cfg.model
    if m.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {m.compute_dtype!r}: one of {sorted(COMPUTE_DTYPES)}")
    return FPN(num_classes=m.num_classes, back_bone=m.backbone,
               fpn_channels=m.fpn_channels, semantic_channels=m.semantic_channels,
               in_channels=m.in_channels, vgg_spec=m.vgg_spec, remat=m.remat,
               dtype=COMPUTE_DTYPES[m.compute_dtype])


def build_models(cfg: ExperimentConfig) -> Dict[str, nn.Module]:
    t = cfg.train
    if t.temporal_graph and not t.graph_matching:
        # the temporal branch reuses the GModule (`train_camus_echo.py:271-272`)
        raise ValueError(
            "temporal_graph=True requires graph_matching=True (the temporal branch "
            "reuses the graph-matching module)")
    if t.discriminator and not t.graph_matching:
        raise ValueError(
            "discriminator=True requires graph_matching=True (the per-level "
            "discriminators run on the target-domain features the graph-matching "
            "branch computes)")
    models: Dict[str, nn.Module] = {"fpn": build_fpn(cfg)}
    if t.graph_matching:
        models["gmodule"] = GModule(cfg.gmodule)
    if t.discriminator:
        d = cfg.dis
        models["discriminator"] = nn.ModuleDict({
            lvl: Discriminator(d.num_convs, d.in_channels, d.grad_reverse_lambda,
                               d.grl_applied_domain)
            for lvl in DIS_LEVELS})
    if t.temporal_graph:
        models["tgcn"] = TGCN(cfg.tgcn, cfg.sinkhorn)
    return models


def to_nchw(x, device: torch.device) -> torch.Tensor:
    """An NHWC batch array -> a float32 NCHW tensor on `device`; leading
    dimensions beyond one (clips of frames) are flattened into the batch."""
    x = torch.as_tensor(x, dtype=torch.float32).to(device, non_blocking=True)
    return x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2).contiguous()


def make_train_step(cfg: ExperimentConfig
                    ) -> Callable[[TrainState, Mapping[str, Any]], Dict[str, torch.Tensor]]:
    """Returns `train_step(state, batch) -> metrics`; the step updates `state`
    in place and returns its losses as 0-d tensors on the device.

    batch keys (NHWC): imgs_source (B,H,W,1), masks (B,H,W,Cm); with
    graph_matching imgs_target (Bt,H,W,1); with temporal_graph
    temp_imgs_source/target (Bc,T,H,W,1), temp_masks (Bc,T,H,W,Cm) and
    update_idx_source/target (Bc,); with cyc_loss cyc_imgs
    (n_clips*64,H,W,1), whole clips back to back."""
    check_supported(cfg)
    t = cfg.train
    is_camus = cfg.model.backbone == "resnet"
    sampler = cfg.gmodule.sampler
    fused = cfg.model.fused_fpn_forwards and t.graph_matching

    def seg_supervision(pred, masks):
        if is_camus:
            # camus trainer: masks[:, :1], 0.1 * (dice+bce)/2
            # (`train_camus_echo.py:210-213`)
            masks = masks[:, :1]
            pred = pred[:, :masks.shape[1]]
            return 0.1 * (dice_loss(pred, masks) + bce_with_logits(pred, masks)) / 2
        # cardiac trainer: full channels, dice+bce (`train_cardiac_uda.py:228`)
        return dice_loss(pred, masks) + bce_with_logits(pred, masks)

    def train_step(state: TrainState, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        fpn = state.net.module
        for comp in state.components():
            comp.module.train()
            comp.opt.zero_grad(set_to_none=True)
        losses: Dict[str, torch.Tensor] = {}
        extra: Dict[str, torch.Tensor] = {}  # reported, not summed

        dev = state.device
        masks = to_nchw(batch["masks"], dev)
        if t.temporal_graph:
            ts_clips, tt_clips = batch["temp_imgs_source"], batch["temp_imgs_target"]
            assert ts_clips.shape == tt_clips.shape, (
                "temporal source/target clip batches must match "
                f"({ts_clips.shape} vs {tt_clips.shape}): the TGCN splits its batch at the "
                "midpoint")
            bc, tl = ts_clips.shape[:2]
            clip_frames = torch.cat([to_nchw(ts_clips, dev), to_nchw(tt_clips, dev)])

        fused_out = None
        if fused:
            # one FPN call over the source, target (and clip) frames
            # (ModelConfig.fused_fpn_forwards): BatchNorm statistics over the
            # union, one running-stats update
            parts = [to_nchw(batch["imgs_source"], dev), to_nchw(batch["imgs_target"], dev)]
            if t.temporal_graph:
                parts.append(clip_frames)
            assert all(p.shape[1:] == parts[0].shape[1:] for p in parts), (
                "fused_fpn_forwards requires same-geometry frames across the "
                f"source/target/temporal branches, got {[tuple(p.shape) for p in parts]}")
            with record_function("step.fpn_fused"):
                preds_cat, feats_cat = fpn(torch.cat(parts))
            sizes = [p.shape[0] for p in parts]
            fused_out = list(zip(preds_cat.split(sizes),
                                 zip(*(f.split(sizes) for f in feats_cat))))
            pred_s, feats_s = fused_out[0]
        else:
            with record_function("step.fpn_source"):
                pred_s, feats_s = fpn(to_nchw(batch["imgs_source"], dev))
        losses["seg_loss"] = seg_supervision(pred_s, masks)

        new_seeds = None
        if t.graph_matching:
            gm = state.gmn.module
            if fused:
                pred_t, feats_t = fused_out[1]
            else:
                with record_function("step.fpn_target"):
                    pred_t, feats_t = fpn(to_nchw(batch["imgs_target"], dev))
            with record_function("step.sampling"):
                # target pseudo-labels: sigmoid(pred) > class_threshold
                # (`train_camus_echo.py:219`)
                with torch.no_grad():
                    score_maps = (torch.sigmoid(pred_t) > sampler.class_threshold).float()
                    boxes_s = masks_to_boxes(masks[:, :1] if is_camus else masks)
                    boxes_t = masks_to_boxes(score_maps)
                src = sample_nodes(gm.project_features(feats_s), boxes_s, sampler)
                tgt = sample_nodes(gm.project_features(feats_t), boxes_t, sampler)
            with record_function("step.gmodule"):
                gm_losses, new_seeds, _ = gm(src, tgt, (state.sr_seed, state.tg_seed),
                                             train=True, generator=state.generator)
            new_seeds = tuple(s.detach() for s in new_seeds)
            losses.update(gm_losses)
            if t.discriminator:
                with record_function("step.discriminators"):
                    for i, lvl in enumerate(DIS_LEVELS):
                        losses[f"loss_adv_{lvl}"] = cfg.dis.loss_weight * state.dis.module[lvl](
                            feats_s[i], feats_t[i])

        new_queues = None
        if t.temporal_graph:
            # one FPN call over the 2*Bc*T clip frames (`train_camus_echo.py:246-254`)
            if fused:
                preds_, feats_ = fused_out[2]
            else:
                with record_function("step.fpn_temporal"):
                    preds_, feats_ = fpn(clip_frames)
            half = bc * tl
            with record_function("step.sampling_temporal"):
                with torch.no_grad():
                    tm = to_nchw(batch["temp_masks"], dev)
                    # frames with enough mask area supervise the sampling; the
                    # others use the RAW logits as pseudo-masks, boxed as
                    # `mask != 0`, so they degenerate to full-image boxes as in
                    # the reference (`train_camus_echo.py:253-264`; a quirk kept)
                    area_ok = tm.sum(dim=(1, 2, 3)) > 100
                    src_masks = torch.where(area_ok[:, None, None, None], tm,
                                            preds_[:half, :tm.shape[1]])
                    boxes_s2 = masks_to_boxes(src_masks[:, :1] if is_camus else src_masks)
                    # deviation kept from the JAX package: the target maps are
                    # thresholded like the main branch's, where the reference
                    # boxes the raw logits (`train_camus_echo.py:272`)
                    boxes_t2 = masks_to_boxes(
                        (torch.sigmoid(preds_[half:]) > sampler.class_threshold).float())
                src2 = sample_nodes(gm.project_features([f[:half] for f in feats_]),
                                    boxes_s2, sampler)
                tgt2 = sample_nodes(gm.project_features([f[half:] for f in feats_]),
                                    boxes_t2, sampler)
            with record_function("step.gmodule_temporal"):
                # the second call starts from the first call's new seeds
                seeds = new_seeds or (state.sr_seed, state.tg_seed)
                gm2_losses, new_seeds2, (g1, g2) = gm(src2, tgt2, seeds, train=True,
                                                      generator=state.generator)
            new_seeds = tuple(s.detach() for s in new_seeds2)
            with record_function("step.tgcn"):
                b2 = 2 * bc
                clips = [f.reshape(b2, tl, *f.shape[1:]) for f in feats_]
                update_idx = tuple(torch.as_tensor(batch[k]).to(dev, non_blocking=True)
                                   for k in ("update_idx_source", "update_idx_target"))
                tg_losses, new_queues = state.tgcn.module(
                    clips, g1.nodes.detach(), g1.valid, g2.nodes.detach(), g2.valid,
                    (state.queue_source, state.queue_target), update_idx,
                    generator=state.generator)
            losses["temporal_graph_loss"] = (sum(tg_losses.values())
                                             + sum(gm2_losses.values()))
            extra.update({f"tgcn_{k}": v for k, v in tg_losses.items()})
            extra.update({f"temp_{k}": v for k, v in gm2_losses.items()})

        if t.cyc_loss:
            with record_function("step.cycle"):
                # layer-4 backbone features summed over space, the network in
                # train mode, so the 64-frame batch statistics normalize and
                # move the running stats (`train_cardiac_uda.py:245-253`)
                c = cfg.cycle
                feat_out = fpn.back_bone(to_nchw(batch["cyc_imgs"], dev))[-1].sum(dim=(2, 3))
                # several whole clips back to back: the loss is per clip
                feat_clips = feat_out.reshape(-1, c.clip_length, feat_out.shape[-1])
                starts = cycle.draw_starts(state.generator, feat_clips.shape[0],
                                           c.target_region, c.cyc_off, c.chunk_size)
                losses["cyc_loss"] = torch.stack([
                    cycle.seg_cycle(f, s, c.target_region, c.cyc_off, c.chunk_size,
                                    c.temperature)
                    for f, s in zip(feat_clips, starts)]).mean()

        total = sum(losses.values())
        with record_function("step.backward"):
            total.backward()
        with record_function("step.optimizers"):
            for comp in state.components():
                comp.apply_gradients(state.step)
        if new_seeds is not None:
            state.sr_seed, state.tg_seed = new_seeds
        if new_queues is not None:
            state.queue_source, state.queue_target = new_queues
        state.step += 1

        metrics = {k: v.detach() for k, v in {**losses, **extra}.items()}
        metrics["total_loss"] = total.detach()
        return metrics

    return train_step


def make_eval_step(cfg: ExperimentConfig, drop_bg_channel: bool = False):
    """Returns `eval_step(state, imgs, masks) -> (counts, per_part, loss)`, the
    reference validation contract (`train_camus_echo.py:350-417`). With
    `drop_bg_channel`, channel 0 is left out as the cardiac trainer does
    (`train_cardiac_uda.py:399-400`)."""
    is_camus = cfg.model.backbone == "resnet"

    @torch.no_grad()
    def eval_step(state: TrainState, imgs, masks):
        fpn = state.net.module
        fpn.eval()
        logits, _ = fpn(to_nchw(imgs, state.device))
        masks = to_nchw(masks, state.device)
        if is_camus:
            masks, logits = masks[:, :1], logits[:, :1]
        loss = bce_with_logits(logits, masks)
        if drop_bg_channel:
            logits, masks = logits[:, 1:], masks[:, 1:]
        pred = (torch.sigmoid(logits) > 0.5).float()
        counts = confusion_counts(masks, pred)
        per_part = {f"part{i}": confusion_counts(masks[:, i], pred[:, i])
                    for i in range(logits.shape[1])}
        return counts, per_part, loss

    return eval_step
