"""The train and eval steps, port of `graphecho_tpu/train/steps.py`.

One train step is the reference's ~6 module calls and one joint backward
(`train_camus_echo.py:206-299`): the FPN on the source batch and, as a
separate call, on the target batch (BatchNorm statistics per call, running
stats updated by both), FCOS node sampling, the GModule, the four per-level
discriminators behind gradient reversal, one backward of the summed losses,
and the Adam/SGD update of each component. Loss keys match the reference
(`seg_loss`, `dis_loss`, `node_loss`, `mat_loss_aff`, `mat_loss_qu`,
`loss_adv_p2..p5`, plus `total_loss`).

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
from graphecho_torch.ops.sampling import masks_to_boxes, sample_nodes
from graphecho_torch.train.losses import bce_with_logits, dice_loss
from graphecho_torch.train.metrics import confusion_counts
from graphecho_torch.train.state import DIS_LEVELS, TrainState


def check_supported(cfg: ExperimentConfig) -> None:
    """Raise for the options that the port does not implement yet."""
    t, m = cfg.train, cfg.model
    deferred = {
        "temporal_graph": (t.temporal_graph, "the temporal (TGCN) slice"),
        "cyc_loss": (t.cyc_loss, "the cycle-loss slice"),
        "mesh_data": (t.mesh_data is not None, "the data-parallel slice"),
        "compute_dtype='bfloat16'": (m.compute_dtype != "float32",
                                     "the serving and quantised-inference slice"),
        "remat": (m.remat, "the temporal (TGCN) slice"),
        "fused_fpn_forwards": (m.fused_fpn_forwards, "the temporal (TGCN) slice"),
    }
    for name, (on, where) in deferred.items():
        if on:
            raise NotImplementedError(
                f"{name} is not ported to graphecho_torch yet; it comes with {where} "
                "(ROADMAP.md, Queue 1)")


def build_models(cfg: ExperimentConfig) -> Dict[str, nn.Module]:
    check_supported(cfg)
    t = cfg.train
    if t.discriminator and not t.graph_matching:
        raise ValueError(
            "discriminator=True requires graph_matching=True (the per-level "
            "discriminators run on the target-domain features the graph-matching "
            "branch computes)")
    models: Dict[str, nn.Module] = {
        "fpn": FPN(num_classes=cfg.model.num_classes, back_bone=cfg.model.backbone,
                   fpn_channels=cfg.model.fpn_channels,
                   semantic_channels=cfg.model.semantic_channels,
                   in_channels=cfg.model.in_channels, vgg_spec=cfg.model.vgg_spec),
    }
    if t.graph_matching:
        models["gmodule"] = GModule(cfg.gmodule)
    if t.discriminator:
        d = cfg.dis
        models["discriminator"] = nn.ModuleDict({
            lvl: Discriminator(d.num_convs, d.in_channels, d.grad_reverse_lambda,
                               d.grl_applied_domain)
            for lvl in DIS_LEVELS})
    return models


def to_nchw(x, device: torch.device) -> torch.Tensor:
    """An NHWC batch array -> a float32 NCHW tensor on `device`."""
    x = torch.as_tensor(x, dtype=torch.float32).to(device, non_blocking=True)
    return x.permute(0, 3, 1, 2).contiguous()


def make_train_step(cfg: ExperimentConfig
                    ) -> Callable[[TrainState, Mapping[str, Any]], Dict[str, torch.Tensor]]:
    """Returns `train_step(state, batch) -> metrics`; the step updates `state`
    in place and returns its losses as 0-d tensors on the device.

    batch keys (NHWC): imgs_source (B,H,W,1), masks (B,H,W,Cm) and, with
    graph_matching, imgs_target (Bt,H,W,1)."""
    t = cfg.train
    is_camus = cfg.model.backbone == "resnet"
    sampler = cfg.gmodule.sampler

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

        masks = to_nchw(batch["masks"], state.device)
        with record_function("step.fpn_source"):
            pred_s, feats_s = fpn(to_nchw(batch["imgs_source"], state.device))
            losses["seg_loss"] = seg_supervision(pred_s, masks)

        new_seeds = None
        if t.graph_matching:
            gm = state.gmn.module
            with record_function("step.fpn_target"):
                pred_t, feats_t = fpn(to_nchw(batch["imgs_target"], state.device))
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
            losses.update(gm_losses)
            if t.discriminator:
                with record_function("step.discriminators"):
                    for i, lvl in enumerate(DIS_LEVELS):
                        losses[f"loss_adv_{lvl}"] = cfg.dis.loss_weight * state.dis.module[lvl](
                            feats_s[i], feats_t[i])

        total = sum(losses.values())
        with record_function("step.backward"):
            total.backward()
        with record_function("step.optimizers"):
            for comp in state.components():
                comp.apply_gradients(state.step)
        if new_seeds is not None:
            state.sr_seed, state.tg_seed = (s.detach() for s in new_seeds)
        state.step += 1

        metrics = {k: v.detach() for k, v in losses.items()}
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
