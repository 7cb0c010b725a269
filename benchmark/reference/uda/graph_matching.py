"""Graph-matching UDA head (GModule), in float32 (a frozen copy of the system's math).

Reference `GModule` (`models/graph_matching.py:101-746`), `_forward_train`
(`:244-352`):
  1. node-domain discriminator at 'feat' on the RAW sampled nodes (GRL +
     4-layer MLP + BCE, weight 0.1), or at 'intra'/'inter' on the graph nodes;
  2. head_in_ln projection (Linear-LN-ReLU-Linear-LN, no affine), or the
     GN/IN `GRAPHHead` conv tower on the feature maps before sampling;
  3. class-grouped regrouping into fixed per-class slots, hallucinating a
     class missing from one domain from the seed memory bank (`:381-483`);
  4. intra-domain graph attention -> (nodes, edges);
  5. seed-bank EMA update with spectral sub-clustering (`:532-567`);
  6. cross-domain graph attention;
  7. node classification CE;
  8. affinity + masked InstanceNorm + slack Sinkhorn + o2o focal matching
     loss, or 'm2m' on sigmoid(M); quadratic structure loss.

Shapes are static as in the JAX package: per-class slots of
`nodes_per_class` with validity masks, masked-mean losses, and the
reference's `< 6 source nodes` early exit as a gate that zeroes the losses.
Seed banks are explicit state, passed in and returned. The hallucination noise
and the attention dropout come from the caller's `torch.Generator`.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.uda.config import GModuleConfig
from benchmark.reference.uda.affinity import Affinity
from benchmark.reference.uda.attention import MultiHeadAttention, linear
from benchmark.reference.uda.backbones import conv2d
from benchmark.reference.uda.grl import gradient_reversal
from benchmark.reference.uda.sampling import NodeSet
from benchmark.reference.uda.sinkhorn import sinkhorn_rpm
from benchmark.reference.uda.spectral import seed_consistent_mean
from benchmark.reference.uda.losses import bce_focal_loss_probs, bce_with_logits, cross_entropy



class GRAPHHead(nn.Module):
    """Conv tower projecting feature maps before node sampling, the
    reference's `head_in_cfg != 'LN'` path (`graph_matching.py:48-98`).
    'GN' = GroupNorm(32) with affine; 'IN' = one group per channel without
    affine (torch InstanceNorm2d's default); eps 1e-5 both."""

    def __init__(self, num_convs: int = 2, channels: int = 256, norm: str = "GN"):
        super().__init__()
        self.num_convs = num_convs
        n_groups = {"GN": 32, "IN": channels}.get(norm)
        for i in range(num_convs):
            setattr(self, f"conv_{i}", conv2d(channels, channels, 3, padding=1))
            if n_groups is not None:
                setattr(self, f"gn_{i}", nn.GroupNorm(n_groups, channels, eps=1e-5,
                                                      affine=norm != "IN"))

    def forward(self, features):
        outs = []
        for x in features:
            for i in range(self.num_convs):
                x = getattr(self, f"conv_{i}")(x)
                norm = getattr(self, f"gn_{i}", None)
                if norm is not None:
                    x = norm(x)
                if i != self.num_convs - 1:
                    x = F.relu(x)
            outs.append(x)
        return outs


class GroupedNodes(NamedTuple):
    """Per-class slotted node sets: (num_classes * S, ...)."""

    nodes: torch.Tensor  # (C*S, D)
    labels: torch.Tensor  # (C*S,)
    weights: torch.Tensor  # (C*S,)
    valid: torch.Tensor  # (C*S,) bool


def _select_classes(nodes, labels, valid, weights, num_classes: int, slots: int):
    """For every class c: up to `slots` nodes of class c in their original
    order, their weights and slot validity, each with a leading class axis."""
    n = nodes.shape[0]
    classes = torch.arange(num_classes, device=nodes.device)
    mask = (labels[None, :] == classes[:, None]) & valid[None, :]  # (C, N)
    key = torch.where(mask, torch.arange(n, device=nodes.device), 2 ** 30)
    order = torch.argsort(key, dim=-1, stable=True)[:, :slots]
    count = mask.sum(-1).clamp(max=slots)
    slot_valid = torch.arange(slots, device=nodes.device)[None, :] < count[:, None]
    f = slot_valid.to(nodes.dtype)
    return nodes[order] * f[..., None], weights[order] * f, slot_valid


def _masked_mean_std(x: torch.Tensor, valid: torch.Tensor):
    """Per-class column mean/std over valid rows (unbiased std, as torch's
    .std(0)); x (C, S, D), valid (C, S). A class with one or no valid row
    gets std 0 without a sqrt of 0 in the graph."""
    f = valid.to(x.dtype)[..., None]
    cnt = f.sum(1).clamp_min(1.0)
    mean = (x * f).sum(1) / cnt
    var = (((x - mean[:, None]) ** 2) * f).sum(1) / (cnt - 1.0).clamp_min(1.0)
    ok = var > 1e-12
    std = torch.where(ok, torch.sqrt(torch.where(ok, var, 1.0)), 0.0)
    return mean, std


def _masked_instance_norm(m: torch.Tensor, pair_valid: torch.Tensor,
                          eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm over the whole matrix restricted to valid entries
    (reference `InstNorm_layer`, `graph_matching.py:177,574`)."""
    m = m.float()
    f = pair_valid.to(m.dtype)
    cnt = f.sum().clamp_min(1.0)
    mean = (m * f).sum() / cnt
    var = (((m - mean) ** 2) * f).sum() / cnt  # biased, like torch IN
    return (m - mean) * torch.rsqrt(var + eps)


def layer_norm_noaffine(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis without scale or bias (eps 1e-5, as the
    JAX package sets it)."""
    return F.layer_norm(x, (x.shape[-1],), eps=eps)


def pair_row(valid: torch.Tensor) -> torch.Tensor:
    """(N,) validity -> (N, N) row*col mask as float."""
    f = valid.float()
    return f[:, None] * f[None, :]


class GModule(nn.Module):
    def __init__(self, cfg: GModuleConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.in_channels

        def dense(cin, cout):
            return linear(cin, cout)

        if cfg.head_in_cfg == "LN":
            self.head_in_1 = dense(c, c)
            self.head_in_2 = dense(c, c)
        elif cfg.head_in_cfg in ("GN", "IN"):
            self.graph_head = GRAPHHead(num_convs=2, channels=c, norm=cfg.head_in_cfg)
        else:
            raise ValueError(
                f"head_in_cfg={cfg.head_in_cfg!r} not supported: 'LN', 'GN' or 'IN' "
                "('BN' needs running stats the reference's dead path never defined)")
        self.node_cls_1 = dense(c, 2 * c)
        self.node_cls_2 = dense(2 * c, cfg.num_classes)
        self.seed_project_left = dense(c, c)
        self.intra_domain_graph = MultiHeadAttention(c, 1, dropout=cfg.dropout)
        self.cross_domain_graph = MultiHeadAttention(c, 1, dropout=cfg.dropout)
        self.node_affinity = Affinity(d=c)
        if cfg.with_node_dis:
            for i in range(3):
                setattr(self, f"node_dis_{i}", dense(c, c))
            self.node_dis_out = dense(c, 1)

    # ---------------------------------------------------------------- helpers
    def _node_dis_loss(self, nodes_s, valid_s, nodes_t, valid_t) -> torch.Tensor:
        x = gradient_reversal(torch.cat([nodes_s, nodes_t], dim=0), self.cfg.lambda_dis)
        for i in range(3):
            x = F.relu(layer_norm_noaffine(getattr(self, f"node_dis_{i}")(x)))
        logits = self.node_dis_out(x)[:, 0]
        target = torch.cat([torch.ones_like(valid_s, dtype=torch.float32),
                            torch.zeros_like(valid_t, dtype=torch.float32)])
        w = torch.cat([valid_s, valid_t]).float()
        return self.cfg.weight_dis * bce_with_logits(logits, target, weight=w)

    def _head_in(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.head_in_cfg != "LN":
            return x  # the maps went through project_features() already
        x = F.relu(layer_norm_noaffine(self.head_in_1(x)))
        return layer_norm_noaffine(self.head_in_2(x))

    def project_features(self, features):
        """The GN/IN conv tower on the FPN maps before sampling; the identity
        in the shipped 'LN' mode."""
        if self.cfg.head_in_cfg == "LN":
            return list(features)
        return self.graph_head(features)

    def _group_by_class(self, src: NodeSet, tgt: NodeSet, nodes_s, nodes_t,
                        seeds, generator: Optional[torch.Generator]
                        ) -> Tuple[GroupedNodes, GroupedNodes]:
        """Static-shape `_forward_preprocessing_source_target` (`:381-483`)."""
        cfg = self.cfg
        S, C = cfg.nodes_per_class, cfg.num_classes
        sr_seed, tg_seed = seeds
        sn0, sw0, sv0 = _select_classes(nodes_s, src.labels, src.valid, src.weights, C, S)
        tn0, tw0, tv0 = _select_classes(nodes_t, tgt.labels, tgt.valid, tgt.weights, C, S)
        s_cnt, t_cnt = sv0.sum(1), tv0.sum(1)
        s_present, t_present = s_cnt > 0, t_cnt > 0

        dev = nodes_s.device
        noise_s = torch.randn((C, S, sr_seed.shape[1]), generator=generator, device=dev)
        noise_t = torch.randn((C, S, tg_seed.shape[1]), generator=generator, device=dev)
        _, t_std = _masked_mean_std(tn0, tv0)
        _, s_std = _masked_mean_std(sn0, sv0)

        # hallucinated nodes from the seed bank (`:432-449`): sigma 0.01 with
        # fewer than 5 real nodes in the mirrored domain, else its std
        base_s = sr_seed[:, None, :].expand_as(noise_s)
        base_t = tg_seed[:, None, :].expand_as(noise_t)
        if cfg.with_semantic_completion:
            hall_s = torch.where((t_cnt < 5)[:, None, None], base_s + 0.01 * noise_s,
                                 base_s + noise_s * t_std[:, None, :])
            hall_t = torch.where((s_cnt < 5)[:, None, None], base_t + 0.01 * noise_t,
                                 base_t + noise_t * s_std[:, None, :])
        else:
            hall_s, hall_t = 0.01 * noise_s, 0.01 * noise_t
        hall_s = self.seed_project_left(hall_s)
        hall_t = self.seed_project_left(hall_t)

        # a class present in neither domain stays fully invalid
        use_hall_s = ((~s_present) & t_present)[:, None]
        use_hall_t = ((~t_present) & s_present)[:, None]
        sn = torch.where(use_hall_s[..., None], hall_s, sn0)
        sv = torch.where(use_hall_s, tv0, sv0)  # mirror the other domain's count
        tn = torch.where(use_hall_t[..., None], hall_t, tn0)
        tv = torch.where(use_hall_t, sv0, tv0)
        sw = torch.where(use_hall_s, 1.0, sw0)  # hallucinated slots weigh 1
        tw = torch.where(use_hall_t, 1.0, tw0)

        labels = torch.arange(C, device=dev).repeat_interleave(S)
        vs, vt = sv.reshape(-1), tv.reshape(-1)
        fs, ft = vs.to(sn.dtype), vt.to(tn.dtype)
        d = sn.shape[-1]
        return (GroupedNodes(sn.reshape(-1, d) * fs[:, None], labels, sw.reshape(-1) * fs, vs),
                GroupedNodes(tn.reshape(-1, d) * ft[:, None], labels, tw.reshape(-1) * ft, vt))

    @torch.no_grad()
    def _update_seeds(self, nodes, valid, seed) -> torch.Tensor:
        """EMA seed update with spectral sub-clustering (`update_seed`,
        `:532-567`), all classes at once; class c owns slots [c*S, (c+1)*S)."""
        cfg = self.cfg
        C, S = cfg.num_classes, cfg.nodes_per_class
        nodes = nodes.detach().reshape(C, S, -1)
        valid_c = valid.reshape(C, S)
        cnt = valid_c.sum(-1)
        f = valid_c.to(nodes.dtype)[..., None]
        plain_mean = (nodes * f).sum(1) / f.sum(1).clamp_min(1.0)
        if cfg.with_cluster_update:
            cl_mean, ok = seed_consistent_mean(seed, nodes, valid_c,
                                               solver=cfg.spectral_solver)
            use_cluster = (cnt > cfg.seed_cluster_min_nodes) & ok
            bs = torch.where(use_cluster[:, None], cl_mean, plain_mean)
        else:
            bs = plain_mean
        cos = (bs * seed).sum(-1) / (torch.linalg.vector_norm(bs, dim=-1)
                                     * torch.linalg.vector_norm(seed, dim=-1)).clamp_min(1e-8)
        updated = seed * cos[:, None] + bs * (1.0 - cos[:, None])
        return torch.where((cnt > 0)[:, None], updated, seed)

    def _elem_matching_loss(self, p, target, mask) -> torch.Tensor:
        """'FL' focal BCE (masked elementwise mean, the shipped default),
        'L1'/'MSE' with the reference's reduction='sum'."""
        lt = self.cfg.matching_loss_type
        if lt == "L1":
            return ((p - target).abs() * mask.to(p.dtype)).sum()
        if lt == "MSE":
            return (((p - target) ** 2) * mask.to(p.dtype)).sum()
        return bce_focal_loss_probs(p, target, mask=mask)

    def _matching_losses(self, g1: GroupedNodes, g2: GroupedNodes, edges_1, edges_2):
        """Affinity + Sinkhorn + o2o matching loss (`:569-599`) and the
        quadratic loss (`:604-607`), masked; 'm2m' (`:592-595`) skips the
        InstanceNorm and Sinkhorn and scores sigmoid(M)."""
        cfg = self.cfg
        m = self.node_affinity(g1.nodes, g2.nodes)  # (N1, N2)
        pair_valid = g1.valid[:, None] & g2.valid[None, :]
        target = (g1.labels[:, None] == g2.labels[None, :]) & pair_valid
        n_pairs = pair_valid.to(m.dtype).sum().clamp_min(1.0)
        e1 = edges_1.detach() * pair_row(g1.valid)
        e2 = edges_2.detach() * pair_row(g2.valid)

        if cfg.matching_cfg == "m2m":
            matching_loss = self._elem_matching_loss(torch.sigmoid(m), target.to(m.dtype),
                                                     mask=pair_valid)
            # the quadratic loss runs on the RAW affinity in m2m (`:593-599`)
            mm = m * pair_valid
            r = e1 @ mm - mm @ e2
            return matching_loss, (r.abs() * pair_valid).sum() / n_pairs

        m = _masked_instance_norm(m, pair_valid)
        log_m = sinkhorn_rpm(m[None], n_iters=cfg.sinkhorn_iters, slack=True,
                             row_mask=g1.valid[None], col_mask=g2.valid[None])[0]
        m = torch.exp(log_m)

        # o2o: per valid row, the best same-class entry is a TP sample
        idx = torch.argmax(m * target.to(m.dtype), dim=-1)
        tp_samples = torch.gather(m, 1, idx[:, None])[:, 0]
        n_tp = g1.valid.to(m.dtype).sum().clamp_min(1.0)
        # reference quirk: the FL path is an elementwise mean AND divided by
        # len(TP) again (`:587`)
        tp_loss = self._elem_matching_loss(tp_samples, torch.ones_like(tp_samples),
                                           mask=g1.valid) / n_tp
        fp_mask = (~target) & pair_valid
        fp_sum = torch.where(fp_mask, m, 0.0).sum().clamp_min(1e-8).detach()
        fp_loss = self._elem_matching_loss(m, torch.zeros_like(m), mask=fp_mask) / fp_sum

        # quadratic structure loss: R = E1 M - M E2, L1 -> 0
        mm = m * pair_valid
        r = e1 @ mm - mm @ e2
        return tp_loss + fp_loss, (r.abs() * pair_valid).sum() / n_pairs

    # ------------------------------------------------------------------ main
    def forward(self, src: NodeSet, tgt: NodeSet, seeds: Tuple[torch.Tensor, torch.Tensor],
                train: bool = True, generator: Optional[torch.Generator] = None
                ) -> Tuple[Dict[str, torch.Tensor], Tuple[torch.Tensor, torch.Tensor],
                           Tuple[GroupedNodes, GroupedNodes]]:
        """src/tgt: sampled NodeSets. seeds: (sr, tg) (num_classes, C) banks.
        Returns (losses, new seeds, (grouped source, grouped target))."""
        cfg = self.cfg
        losses: Dict[str, torch.Tensor] = {}
        # `< 6 source nodes` guard (`:259-260`) as a multiplicative gate
        enough = (src.valid.sum() >= 6).float()

        if cfg.with_node_dis and cfg.node_dis_place == "feat":
            losses["dis_loss"] = enough * self._node_dis_loss(
                src.points, src.valid, tgt.points, tgt.valid)

        nodes_s = self._head_in(src.points)
        nodes_t = self._head_in(tgt.points)
        g1, g2 = self._group_by_class(src, tgt, nodes_s, nodes_t, seeds, generator)

        if cfg.with_complete_graph:
            n1, edges_1 = self.intra_domain_graph(g1.nodes, g1.nodes, g1.nodes,
                                                  key_mask=g1.valid, train=train,
                                                  generator=generator)
            n2, edges_2 = self.intra_domain_graph(g2.nodes, g2.nodes, g2.nodes,
                                                  key_mask=g2.valid, train=train,
                                                  generator=generator)
            g1 = g1._replace(nodes=n1 * g1.valid[:, None])
            g2 = g2._replace(nodes=n2 * g2.valid[:, None])
        else:
            edges_1 = edges_2 = nodes_s.new_zeros((g1.nodes.shape[0],) * 2)

        # seed bank EMA update, kept only when the gate is open (a select,
        # not a branch: no host sync)
        sr_seed, tg_seed = seeds
        gate = enough > 0
        new_sr = torch.where(gate, self._update_seeds(g1.nodes, g1.valid, sr_seed), sr_seed)
        new_tg = torch.where(gate, self._update_seeds(g2.nodes, g2.valid, tg_seed), tg_seed)

        if cfg.with_node_dis and cfg.node_dis_place == "intra":
            losses["dis_loss"] = enough * self._node_dis_loss(
                g1.nodes, g1.valid, g2.nodes, g2.valid)

        if cfg.with_domain_interaction:
            if cfg.with_global_graph:
                # single attention over the union (`:491-498`)
                n1l = g1.nodes.shape[0]
                union = torch.cat([g1.nodes, g2.nodes], dim=0)
                enhanced, _ = self.cross_domain_graph(
                    union, union, union, key_mask=torch.cat([g1.valid, g2.valid]),
                    train=train, generator=generator)
                n1e, n2e = enhanced[:n1l], enhanced[n1l:]
            else:
                n2e, _ = self.cross_domain_graph(g1.nodes, g1.nodes, g2.nodes,
                                                 key_mask=g1.valid, train=train,
                                                 generator=generator)
                n1e, _ = self.cross_domain_graph(g2.nodes, g2.nodes, g1.nodes,
                                                 key_mask=g2.valid, train=train,
                                                 generator=generator)
            g1 = g1._replace(nodes=n1e * g1.valid[:, None])
            g2 = g2._replace(nodes=n2e * g2.valid[:, None])

        if cfg.with_node_dis and cfg.node_dis_place == "inter":
            losses["dis_loss"] = enough * self._node_dis_loss(
                g1.nodes, g1.valid, g2.nodes, g2.valid)

        # node classification (`:505-530`); with_score_weight scales each
        # node's CE by its sampled confidence
        all_nodes = torch.cat([g1.nodes, g2.nodes], dim=0)
        logits = self.node_cls_2(F.relu(self.node_cls_1(all_nodes)))
        ce_w = torch.cat([g1.weights, g2.weights]) if cfg.with_score_weight else None
        losses["node_loss"] = enough * cfg.weight_nodes * cross_entropy(
            logits, torch.cat([g1.labels, g2.labels]), weight=ce_w,
            mask=torch.cat([g1.valid, g2.valid]))

        if cfg.matching_cfg != "none":
            mat_aff, mat_qu = self._matching_losses(g1, g2, edges_1, edges_2)
            losses["mat_loss_aff"] = enough * cfg.weight_matching * mat_aff
            if cfg.with_quadratic_matching:
                losses["mat_loss_qu"] = enough * mat_qu

        return losses, (new_sr, new_tg), (g1, g2)
