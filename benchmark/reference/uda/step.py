"""One UDA train step of the reference, in float32, and its optimizers.

The step is the reference trainers' (`train_camus_echo.py:206-299`,
`train_cardiac_uda.py:228-253`): the FPN on the source batch and, as a
separate call, on the target batch; FCOS node sampling; the GModule; the
four per-level discriminators behind gradient reversal; with
`temporal_graph` one FPN call over every clip frame, a second GModule call
and the TGCN; with `cyc_loss` a backbone forward over the 64-frame cycle clip
and its cycle loss. Then one backward of the summed losses and the update of
each component: Adam or SGD with momentum, weight decay added to the
gradient (coupled L2), at the LR of the warm-up schedule.

The random draws (the GModule's hallucination noise, attention and TGCN
dropout, the cycle starts) come from one `torch.Generator`, in the order
the system under test draws them; the benchmark gives both sides a
generator seeded alike.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from benchmark.reference.uda import cycle
from benchmark.reference.uda.config import ComponentConfig, ExperimentConfig
from benchmark.reference.uda.discriminator import Discriminator
from benchmark.reference.uda.fpn import FPN
from benchmark.reference.uda.graph_matching import GModule
from benchmark.reference.uda.losses import bce_with_logits, dice_loss
from benchmark.reference.uda.sampling import masks_to_boxes, sample_nodes
from benchmark.reference.uda.tgcn import TGCN

DIS_LEVELS = ("p2", "p3", "p4", "p5")


def build_fpn(cfg: ExperimentConfig) -> FPN:
    m = cfg.model
    return FPN(num_classes=m.num_classes, back_bone=m.backbone, fpn_channels=m.fpn_channels,
               semantic_channels=m.semantic_channels, in_channels=m.in_channels,
               vgg_spec=m.vgg_spec)


def kernel_call_shapes(cfg: ExperimentConfig) -> Dict[str, List[Tuple[int, ...]]]:
    """The calls one train step of the uda experiment `cfg` makes to each
    hand-written kernel, by the name of the program's launch counter
    (`LAUNCHES` in `ops/pairwise_mlp.py`, `ops/knn.py`, `ops/spectral.py`),
    one shape per call: a shape is the arguments of the kernel's work
    function in `benchmark/work.py`, and a spectral split's (classes,
    points). Each GModule call (one, and a second with the temporal branch)
    makes one affinity forward and backward over every class's node slots
    on both sides with the MLP's 2d hidden width and, with the cluster
    update, two spectral splits of each class's node slots and its seed;
    the TGCN makes one kNN graph a clip frame (2 x clips, the node grid
    against the hidden state, the hidden width, k)."""
    g, t = cfg.gmodule, cfg.train
    n = g.num_classes * g.nodes_per_class
    gm_calls = (1 + int(t.temporal_graph)) if t.graph_matching else 0
    splits = 2 * gm_calls if g.with_cluster_update and g.spectral_solver == "lanczos" else 0
    calls = {"pairwise_mlp_fwd": [(n, n, 2 * g.in_channels)] * gm_calls,
             "pairwise_mlp_bwd": [(n, n, 2 * g.in_channels)] * gm_calls,
             "spectral": [(g.num_classes, g.nodes_per_class + 1)] * splits}
    if t.temporal_graph:
        frames, gh, gw = cfg.tgcn.clip_shape
        clips = 2 * max(cfg.data.batch_size // 2, 1)
        calls["knn"] = [(clips, gh * gw, gh * gw, cfg.tgcn.hidden_dim, cfg.tgcn.knn_k)] * frames
    return {name: c for name, c in calls.items() if c}


def build_models(cfg: ExperimentConfig,
                 fpn_builder: Callable[[ExperimentConfig], nn.Module]) -> Dict[str, nn.Module]:
    """The trained components by name: fpn (from `fpn_builder`), gmodule,
    discriminator, tgcn."""
    t = cfg.train
    models: Dict[str, nn.Module] = {"fpn": fpn_builder(cfg)}
    if t.graph_matching:
        models["gmodule"] = GModule(cfg.gmodule)
    if t.discriminator:
        d = cfg.dis
        models["discriminator"] = nn.ModuleDict({
            lvl: Discriminator(d.num_convs, d.in_channels, d.grad_reverse_lambda,
                               d.grl_applied_domain) for lvl in DIS_LEVELS})
    if t.temporal_graph:
        models["tgcn"] = TGCN(cfg.tgcn, cfg.sinkhorn)
    return models


def lr_factor(count: int, cfg: ComponentConfig) -> float:
    """The warm-up multi-step LR multiplier after `count` scheduler steps."""
    s = cfg.sch
    if count < s.warmup_iters:
        if s.warmup_method == "constant":
            warmup = s.warmup_factor
        else:
            alpha = min(count / max(s.warmup_iters, 1), 1.0)
            warmup = s.warmup_factor * (1 - alpha) + alpha
    else:
        warmup = 1.0
    return warmup * s.gamma ** sum(count >= m for m in s.steps)


class Optimizer:
    """Adam (bias-corrected, eps 1e-8) or SGD with momentum, weight decay
    added to the gradient, one parameter at a time. `first_grads` holds each
    leaf's gradient as the update of step 0 saw it (decay included)."""

    def __init__(self, module: nn.Module, cfg: ComponentConfig):
        self.cfg = cfg
        self.params = dict(module.named_parameters())
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        self.first_grads: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, count: int, steps_per_epoch: int = 1) -> None:
        o = self.cfg.opt
        lr = o.lr * lr_factor(count // steps_per_epoch, self.cfg)
        for name, p in self.params.items():
            g = torch.zeros_like(p) if p.grad is None else p.grad
            g = g + o.weight_decay * p
            if count == 0:
                self.first_grads[name] = g.clone()
            st = self.state.setdefault(name, {})
            if o.opt_name == "Adam":
                b1, b2 = o.betas
                m = st["m"] = st.get("m", torch.zeros_like(p)) * b1 + (1 - b1) * g
                v = st["v"] = st.get("v", torch.zeros_like(p)) * b2 + (1 - b2) * g * g
                n = st["n"] = st.get("n", 0) + 1
                denom = (v / (1 - b2 ** n)).sqrt() + 1e-8
                p -= lr * (m / (1 - b1 ** n)) / denom
            elif o.opt_name == "SGD":
                buf = st["buf"] = g.clone() if "buf" not in st else st["buf"] * o.momentum + g
                p -= lr * buf
            else:
                raise ValueError(f"unknown optimizer {o.opt_name!r}")
            p.grad = None


def to_nchw(x, device: torch.device) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=torch.float32).to(device)
    return x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2).contiguous()


class TrainReference:
    """The models, their optimizers and the step's state (seed banks,
    queues, generator), advanced one step at a time by `step(batch)`.

    The FPN comes from `build_fpn`; a configuration whose model is another
    FPN subclasses this class and sets `build_fpn` to its own builder."""

    build_fpn = staticmethod(build_fpn)

    def __init__(self, cfg: ExperimentConfig, device: torch.device):
        self.cfg = cfg
        self.device = device
        self.models = {k: m.to(device) for k, m in build_models(cfg, self.build_fpn).items()}
        comp_cfg = {"fpn": cfg.train.net, "gmodule": cfg.train.gmn,
                    "discriminator": cfg.train.dis, "tgcn": cfg.train.tgcn}
        self.opts = {k: Optimizer(m, comp_cfg[k]) for k, m in self.models.items()}
        self.sr_seed: Optional[torch.Tensor] = None
        self.tg_seed: Optional[torch.Tensor] = None
        self.queue_source: Optional[torch.Tensor] = None
        self.queue_target: Optional[torch.Tensor] = None
        self.generator: Optional[torch.Generator] = None
        self.count = 0

    def step(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        cfg, t, dev = self.cfg, self.cfg.train, self.device
        is_camus = cfg.model.backbone == "resnet"
        sampler = cfg.gmodule.sampler
        gen = self.generator
        fpn = self.models["fpn"]
        for m in self.models.values():
            m.train()
        losses: Dict[str, torch.Tensor] = {}

        def seg(pred, masks):
            if is_camus:
                masks = masks[:, :1]
                pred = pred[:, :masks.shape[1]]
                return 0.1 * (dice_loss(pred, masks) + bce_with_logits(pred, masks)) / 2
            return dice_loss(pred, masks) + bce_with_logits(pred, masks)

        masks = to_nchw(batch["masks"], dev)
        pred_s, feats_s = fpn(to_nchw(batch["imgs_source"], dev))
        losses["seg_loss"] = seg(pred_s, masks)

        new_seeds = None
        if t.graph_matching:
            gm = self.models["gmodule"]
            pred_t, feats_t = fpn(to_nchw(batch["imgs_target"], dev))
            with torch.no_grad():
                score_maps = (torch.sigmoid(pred_t) > sampler.class_threshold).float()
                boxes_s = masks_to_boxes(masks[:, :1] if is_camus else masks)
                boxes_t = masks_to_boxes(score_maps)
            src = sample_nodes(gm.project_features(feats_s), boxes_s, sampler)
            tgt = sample_nodes(gm.project_features(feats_t), boxes_t, sampler)
            gm_losses, new_seeds, _ = gm(src, tgt, (self.sr_seed, self.tg_seed), train=True,
                                         generator=gen)
            new_seeds = tuple(s.detach() for s in new_seeds)
            losses.update(gm_losses)
            if t.discriminator:
                dis = self.models["discriminator"]
                for i, lvl in enumerate(DIS_LEVELS):
                    losses[f"loss_adv_{lvl}"] = cfg.dis.loss_weight * dis[lvl](feats_s[i],
                                                                               feats_t[i])

        new_queues = None
        if t.temporal_graph:
            ts, tt = batch["temp_imgs_source"], batch["temp_imgs_target"]
            bc, tl = ts.shape[0], ts.shape[1]
            clips = torch.cat([to_nchw(ts, dev), to_nchw(tt, dev)])
            preds_, feats_ = fpn(clips)
            half = bc * tl
            with torch.no_grad():
                tm = to_nchw(batch["temp_masks"], dev)
                area_ok = tm.sum(dim=(1, 2, 3)) > 100
                src_masks = torch.where(area_ok[:, None, None, None], tm,
                                        preds_[:half, :tm.shape[1]])
                boxes_s2 = masks_to_boxes(src_masks[:, :1] if is_camus else src_masks)
                boxes_t2 = masks_to_boxes(
                    (torch.sigmoid(preds_[half:]) > sampler.class_threshold).float())
            src2 = sample_nodes(gm.project_features([f[:half] for f in feats_]), boxes_s2,
                                sampler)
            tgt2 = sample_nodes(gm.project_features([f[half:] for f in feats_]), boxes_t2,
                                sampler)
            seeds = new_seeds or (self.sr_seed, self.tg_seed)
            gm2_losses, new_seeds2, (g1, g2) = gm(src2, tgt2, seeds, train=True, generator=gen)
            new_seeds = tuple(s.detach() for s in new_seeds2)
            b2 = 2 * bc
            clip_feats = [f.reshape(b2, tl, *f.shape[1:]) for f in feats_]
            update_idx = tuple(torch.as_tensor(batch[k]).to(dev)
                               for k in ("update_idx_source", "update_idx_target"))
            tg_losses, new_queues = self.models["tgcn"](
                clip_feats, g1.nodes.detach(), g1.valid, g2.nodes.detach(), g2.valid,
                (self.queue_source, self.queue_target), update_idx, generator=gen)
            losses["temporal_graph_loss"] = sum(tg_losses.values()) + sum(gm2_losses.values())

        if t.cyc_loss:
            c = cfg.cycle
            feat_out = fpn.back_bone(to_nchw(batch["cyc_imgs"], dev))[-1].sum(dim=(2, 3))
            feat_clips = feat_out.reshape(-1, c.clip_length, feat_out.shape[-1])
            starts = cycle.draw_starts(gen, feat_clips.shape[0], c.target_region, c.cyc_off,
                                       c.chunk_size)
            losses["cyc_loss"] = torch.stack([
                cycle.seg_cycle(f, s, c.target_region, c.cyc_off, c.chunk_size, c.temperature)
                for f, s in zip(feat_clips, starts)]).mean()

        total = sum(losses.values())
        total.backward()
        for opt in self.opts.values():
            opt.step(self.count)
        if new_seeds is not None:
            self.sr_seed, self.tg_seed = new_seeds
        if new_queues is not None:
            self.queue_source, self.queue_target = new_queues
        self.count += 1
        out = {k: v.detach() for k, v in losses.items()}
        out["total_loss"] = total.detach()
        return out


def leaf_norms(tensors: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """{name: L2 norm} of each tensor, in float64, one transfer to the host."""
    names = list(tensors)
    if not names:
        return {}
    norms = torch.stack([torch.linalg.vector_norm(tensors[n].double()) for n in names])
    return dict(zip(names, norms.tolist()))


def median(values: List[float]) -> float:
    s = sorted(values)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

