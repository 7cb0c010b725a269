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

`ModelConfig.compute_dtype="bfloat16"` follows the JAX package's dtype path
(`graphecho_tpu/train/steps.py:60-81`): the FPN and the TGCN compute in bf16;
the GModule and the discriminators are built without a dtype, so flax
promotes their bf16 inputs with their f32 parameters to f32, which the port
does with a cast at their entry (the pairwise-MLP kernels keep taking f32);
the losses compute in f32; the parameters and optimizer states stay f32.

With a `parallel.mesh.Mesh`, the step is data parallel over its ranks with
the semantics of one step on the global batch (`parallel/mesh.py`): each
rank's batch is its row block of every entry; the FPN runs on the rank's
rows with global BatchNorm statistics and its outputs are all-gathered with
autograd; everything after it runs on the global batch, the same on every
rank, from the step generator that every rank holds equal; the FPN's
gradients are summed over the ranks before the update, the replicated
components' averaged (equal on every rank up to the card's atomics).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from graphecho_torch.config import ExperimentConfig
from graphecho_torch.models.backbones import set_batch_norm_group
from graphecho_torch.models.discriminator import Discriminator
from graphecho_torch.models.fpn import FPN
from graphecho_torch.models.graph_matching import GModule
from graphecho_torch.models.tgcn import TGCN
from graphecho_torch.ops.sampling import masks_to_boxes, sample_nodes
from graphecho_torch.parallel.mesh import Mesh, all_gather_nodes, all_reduce_grads
from graphecho_torch.train import cycle
from graphecho_torch.train.losses import bce_with_logits, dice_loss
from graphecho_torch.train.metrics import confusion_counts
from graphecho_torch.train.state import DIS_LEVELS, TrainState
from graphecho_torch.utils.profiling import annotate


# the FPN's and the TGCN's compute dtype by `ModelConfig.compute_dtype`; f32
# is the unconverted path (`models/backbones.py::set_compute_dtype`)
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def check_supported(cfg: ExperimentConfig) -> None:
    """Raise ValueError for a crop, a compute dtype or a mesh size the step
    cannot take. Every option of the JAX package's step is ported; the
    Pyramid ViG-S backbone (`pvig_s`) takes square frames (`FPN` names the
    backbones and refuses remat on the ViG)."""
    m, t = cfg.model, cfg.train
    if m.backbone == "pvig_s" and cfg.data.img_crop[0] != cfg.data.img_crop[1]:
        raise ValueError(f"the Pyramid ViG takes square frames, not {cfg.data.img_crop}")
    if m.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype {m.compute_dtype!r}: one of {sorted(COMPUTE_DTYPES)}")
    if t.mesh_data is not None and t.mesh_data < 1:
        raise ValueError(f"mesh_data={t.mesh_data}: a positive number of ranks")


def build_fpn(cfg: ExperimentConfig) -> FPN:
    """The FPN of `cfg.model`, computing in `cfg.model.compute_dtype`
    (`graphecho_tpu/train/steps.py:60-66`)."""
    m = cfg.model
    check_supported(cfg)
    return FPN(num_classes=m.num_classes, back_bone=m.backbone,
               fpn_channels=m.fpn_channels, semantic_channels=m.semantic_channels,
               in_channels=m.in_channels, vgg_spec=m.vgg_spec, remat=m.remat,
               dtype=COMPUTE_DTYPES[m.compute_dtype], img_size=cfg.data.img_crop[0])


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
        models["tgcn"] = TGCN(cfg.tgcn, cfg.sinkhorn,
                              dtype=COMPUTE_DTYPES[cfg.model.compute_dtype])
    return models


def to_device(x, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A batch entry on `device`: the step's copy to the card, in a
    `step.h2d` span."""
    with annotate("step.h2d"):
        return torch.as_tensor(x, dtype=dtype).to(device, non_blocking=True)


def to_nchw(x, device: torch.device) -> torch.Tensor:
    """An NHWC batch array -> a float32 NCHW tensor on `device`; leading
    dimensions beyond one (clips of frames) are flattened into the batch."""
    x = to_device(x, device, torch.float32)
    return x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2).contiguous()


def _f32(feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The entry of a component built without a dtype: flax promotes a bf16
    input with f32 parameters to f32 (a no-op for f32 features)."""
    return [f.float() for f in feats]


def _part_major(x: torch.Tensor, sizes: Sequence[int], world: int) -> torch.Tensor:
    """Gathered rank blocks, each the concatenation of parts of `sizes` rows,
    -> every rank's rows of part 0, then of part 1, ...: the global layout of
    a batch whose entries are each sharded by rows."""
    if len(sizes) == 1:
        return x
    blocks = [b.split(list(sizes)) for b in x.split(sum(sizes))]
    assert len(blocks) == world
    return torch.cat([blk[i] for i in range(len(sizes)) for blk in blocks])


def make_train_step(cfg: ExperimentConfig, mesh: Optional[Mesh] = None
                    ) -> Callable[[TrainState, Mapping[str, Any]], Dict[str, torch.Tensor]]:
    """Returns `train_step(state, batch) -> metrics`; the step updates `state`
    in place and returns its losses as 0-d tensors on the device.

    batch keys (NHWC): imgs_source (B,H,W,1), masks (B,H,W,Cm); with
    graph_matching imgs_target (Bt,H,W,1); with temporal_graph
    temp_imgs_source/target (Bc,T,H,W,1), temp_masks (Bc,T,H,W,Cm) and
    update_idx_source/target (Bc,); with cyc_loss cyc_imgs
    (n_clips*64,H,W,1), whole clips back to back. With a `mesh` each rank
    passes its row block of every entry, the same number of rows on every
    rank (`parallel.mesh.shard_batch` cuts one from a global batch)."""
    check_supported(cfg)
    t = cfg.train
    is_camus = cfg.model.backbone == "resnet"
    sampler = cfg.gmodule.sampler
    fused = cfg.model.fused_fpn_forwards and t.graph_matching
    world = 1 if mesh is None else mesh.size

    def gather(x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of `x`, rank 0's first, with autograd."""
        return x if mesh is None else all_gather_nodes(x, mesh)

    def fpn_call(fpn, parts: Sequence[torch.Tensor]
                 ) -> Tuple[torch.Tensor, List[torch.Tensor], List[int]]:
        """One FPN call over this rank's rows of `parts`. Returns the logits
        and the pyramid of the global batch, every rank's rows of part 0
        first, then of part 1, ..., and the global row count of each part."""
        pred, feats = fpn(parts[0] if len(parts) == 1 else torch.cat(parts))
        sizes = [p.shape[0] for p in parts]
        if mesh is None:
            return pred, list(feats), sizes
        pred, *feats = (_part_major(gather(x), sizes, world) for x in (pred, *feats))
        return pred, feats, [n * world for n in sizes]

    def seg_supervision(pred, masks):
        if is_camus:
            # camus trainer: masks[:, :1], 0.1 * (dice+bce)/2
            # (`train_camus_echo.py:210-213`)
            masks = masks[:, :1]
            pred = pred[:, :masks.shape[1]]
            return 0.1 * (dice_loss(pred, masks) + bce_with_logits(pred, masks)) / 2
        # cardiac trainer: full channels, dice+bce (`train_cardiac_uda.py:228`)
        return dice_loss(pred, masks) + bce_with_logits(pred, masks)

    grouped: List[nn.Module] = []  # the FPNs whose BatchNorms reduce over the mesh

    def train_step(state: TrainState, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        fpn = state.net.module
        for comp in state.components():
            comp.module.train()
            comp.opt.zero_grad(set_to_none=True)
        losses: Dict[str, torch.Tensor] = {}
        extra: Dict[str, torch.Tensor] = {}  # reported, not summed

        dev = state.device
        if mesh is not None and fpn not in grouped:
            set_batch_norm_group(fpn, mesh.group)
            grouped.append(fpn)
        with torch.no_grad():
            masks = gather(to_nchw(batch["masks"], dev))
        if t.temporal_graph:
            ts_clips, tt_clips = batch["temp_imgs_source"], batch["temp_imgs_target"]
            assert ts_clips.shape == tt_clips.shape, (
                "temporal source/target clip batches must match "
                f"({ts_clips.shape} vs {tt_clips.shape}): the TGCN splits its batch at the "
                "midpoint")
            bc, tl = ts_clips.shape[0] * world, ts_clips.shape[1]
            clip_parts = [to_nchw(ts_clips, dev), to_nchw(tt_clips, dev)]

        fused_out = None
        if fused:
            # one FPN call over the source, target (and clip) frames
            # (ModelConfig.fused_fpn_forwards): BatchNorm statistics over the
            # union, one running-stats update
            parts = [to_nchw(batch["imgs_source"], dev), to_nchw(batch["imgs_target"], dev)]
            if t.temporal_graph:
                parts += clip_parts
            assert all(p.shape[1:] == parts[0].shape[1:] for p in parts), (
                "fused_fpn_forwards requires same-geometry frames across the "
                f"source/target/temporal branches, got {[tuple(p.shape) for p in parts]}")
            with annotate("step.fpn_fused"):
                preds_cat, feats_cat, sizes = fpn_call(fpn, parts)
            # the clip halves are adjacent: one piece
            sizes = sizes[:2] + ([sum(sizes[2:])] if t.temporal_graph else [])
            fused_out = list(zip(preds_cat.split(sizes),
                                 zip(*(f.split(sizes) for f in feats_cat))))
            pred_s, feats_s = fused_out[0]
        else:
            with annotate("step.fpn_source"):
                pred_s, feats_s, _ = fpn_call(fpn, [to_nchw(batch["imgs_source"], dev)])
        losses["seg_loss"] = seg_supervision(pred_s, masks)

        new_seeds = None
        if t.graph_matching:
            gm = state.gmn.module
            if fused:
                pred_t, feats_t = fused_out[1]
            else:
                with annotate("step.fpn_target"):
                    pred_t, feats_t, _ = fpn_call(fpn, [to_nchw(batch["imgs_target"], dev)])
            with annotate("step.sampling"):
                # target pseudo-labels: sigmoid(pred) > class_threshold
                # (`train_camus_echo.py:219`)
                with torch.no_grad(), annotate("step.nodes.boxes"):
                    score_maps = (torch.sigmoid(pred_t) > sampler.class_threshold).float()
                    boxes_s = masks_to_boxes(masks[:, :1] if is_camus else masks)
                    boxes_t = masks_to_boxes(score_maps)
                with annotate("step.nodes.sample"):
                    src = sample_nodes(gm.project_features(_f32(feats_s)), boxes_s, sampler)
                    tgt = sample_nodes(gm.project_features(_f32(feats_t)), boxes_t, sampler)
            with annotate("step.gmodule"):
                gm_losses, new_seeds, _ = gm(src, tgt, (state.sr_seed, state.tg_seed),
                                             train=True, generator=state.generator)
            new_seeds = tuple(s.detach() for s in new_seeds)
            losses.update(gm_losses)
            if t.discriminator:
                with annotate("step.discriminators"):
                    for i, lvl in enumerate(DIS_LEVELS):
                        losses[f"loss_adv_{lvl}"] = cfg.dis.loss_weight * state.dis.module[lvl](
                            feats_s[i].float(), feats_t[i].float())

        new_queues = None
        if t.temporal_graph:
            # one FPN call over the 2*Bc*T clip frames (`train_camus_echo.py:246-254`)
            if fused:
                preds_, feats_ = fused_out[2]
            else:
                with annotate("step.fpn_temporal"):
                    preds_, feats_, _ = fpn_call(fpn, clip_parts)
            half = bc * tl
            with annotate("step.sampling_temporal"):
                with torch.no_grad():
                    tm = gather(to_nchw(batch["temp_masks"], dev))
                with torch.no_grad(), annotate("step.nodes.boxes"):
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
                with annotate("step.nodes.sample"):
                    src2 = sample_nodes(gm.project_features(_f32(f[:half] for f in feats_)),
                                        boxes_s2, sampler)
                    tgt2 = sample_nodes(gm.project_features(_f32(f[half:] for f in feats_)),
                                        boxes_t2, sampler)
            with annotate("step.gmodule_temporal"):
                # the second call starts from the first call's new seeds
                seeds = new_seeds or (state.sr_seed, state.tg_seed)
                gm2_losses, new_seeds2, (g1, g2) = gm(src2, tgt2, seeds, train=True,
                                                      generator=state.generator)
            new_seeds = tuple(s.detach() for s in new_seeds2)
            with annotate("step.tgcn"):
                b2 = 2 * bc
                clips = [f.reshape(b2, tl, *f.shape[1:]) for f in feats_]
                update_idx = tuple(gather(to_device(batch[k], dev))
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
            with annotate("step.cycle"):
                # layer-4 backbone features summed over space, the network in
                # train mode, so the 64-frame batch statistics normalize and
                # move the running stats (`train_cardiac_uda.py:245-253`)
                c = cfg.cycle
                feat_out = gather(
                    fpn.back_bone(to_nchw(batch["cyc_imgs"], dev))[-1].sum(dim=(2, 3)))
                # several whole clips back to back: the loss is per clip
                feat_clips = feat_out.reshape(-1, c.clip_length, feat_out.shape[-1])
                starts = cycle.draw_starts(state.generator, feat_clips.shape[0],
                                           c.target_region, c.cyc_off, c.chunk_size)
                losses["cyc_loss"] = torch.stack([
                    cycle.seg_cycle(f, s, c.target_region, c.cyc_off, c.chunk_size,
                                    c.temperature)
                    for f, s in zip(feat_clips, starts)]).mean()

        total = sum(losses.values())
        with annotate("step.backward"):
            total.backward()
        if mesh is not None:
            with annotate("step.all_reduce"):
                # the FPN's rows differ by rank: its gradients are summed.
                # Everything after the gather is replicated; its gradients
                # and the state it updates differ between cards only by the
                # rounding of atomics, and their mean keeps the replicas
                # equal to the bit
                others = [comp.module for comp in state.components() if comp is not state.net]
                all_reduce_grads(mesh, fpn.parameters(),
                                 (p for m in others for p in m.parameters()),
                                 [*(b for m in others for b in m.buffers()),
                                  *(new_seeds or ()), *(new_queues or ())])
        with annotate("step.optimizers"):
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


def make_eval_step(cfg: ExperimentConfig, drop_bg_channel: bool = False,
                   mesh: Optional[Mesh] = None):
    """Returns `eval_step(state, imgs, masks) -> (counts, per_part, loss)`, the
    reference validation contract (`train_camus_echo.py:350-417`). With
    `drop_bg_channel`, channel 0 is left out as the cardiac trainer does
    (`train_cardiac_uda.py:399-400`). With a `mesh`, every rank passes the
    same global batch and runs its share of the rows (none, where there are
    fewer rows than ranks); the counts and the loss's sum are summed over
    the ranks, so every rank returns the global batch's."""
    is_camus = cfg.model.backbone == "resnet"
    sharded = mesh is not None and mesh.group is not None

    def score(fpn, imgs, masks):
        # a rank whose share has no rows runs no forward; its sums are zeros
        logits = fpn(imgs)[0] if imgs.shape[0] else masks
        if is_camus:
            masks, logits = masks[:, :1], logits[:, :1]
        loss = bce_with_logits(logits, masks, reduction="sum" if sharded else "mean")
        if drop_bg_channel:
            logits, masks = logits[:, 1:], masks[:, 1:]
        pred = (torch.sigmoid(logits) > 0.5).float()
        counts = confusion_counts(masks, pred)
        per_part = {f"part{i}": confusion_counts(masks[:, i], pred[:, i])
                    for i in range(logits.shape[1])}
        return counts, per_part, loss

    @torch.no_grad()
    def eval_step(state: TrainState, imgs, masks):
        fpn = state.net.module
        fpn.eval()
        imgs, masks = to_nchw(imgs, state.device), to_nchw(masks, state.device)
        if not sharded:
            return score(fpn, imgs, masks)
        n_loss = masks[:, :1].numel() if is_camus else masks.numel()
        imgs, masks = (x.tensor_split(mesh.size)[mesh.rank] for x in (imgs, masks))
        counts, per_part, loss = score(fpn, imgs, masks)
        keys = list(counts)
        parts = [(p, k) for p, c in per_part.items() for k in c]
        flat = torch.stack([loss.float()] + [counts[k] for k in keys]
                           + [per_part[p][k] for p, k in parts])
        dist.all_reduce(flat, group=mesh.group)
        counts = dict(zip(keys, flat[1:1 + len(keys)]))
        per_part = {}
        for (p, k), v in zip(parts, flat[1 + len(keys):]):
            per_part.setdefault(p, {})[k] = v
        return counts, per_part, flat[0] / n_loss

    return eval_step
