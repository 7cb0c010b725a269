"""Temporal graph module (TGCN) of the reference model, in float32.

Every frame of the four FPN levels is pooled onto the (T, H, W) node grid;
per frame an MLP, dropout and a position embedding, then a Max-Relative
graph conv over the k nearest hidden-state nodes; a strided prediction head
gives the clip embedding; momentum-queue or linear clustering; a joint
attention over the clip nodes and the GModule's nodes; node discrimination
behind gradient reversal or a Sinkhorn transport cost. Dropout draws from
the caller's generator.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.uda import attention
from benchmark.reference.uda.attention import MultiHeadAttention, linear
from benchmark.reference.uda.backbones import BatchNorm2d, LayerNorm, conv2d
from benchmark.reference.uda.config import SinkhornConfig, TGCNConfig
from benchmark.reference.uda.grl import gradient_reversal
from benchmark.reference.uda.knn import gather_neighbors, knn_graph
from benchmark.reference.uda.losses import bce_with_logits, cross_entropy
from benchmark.reference.uda.resize import adaptive_avg_pool2d
from benchmark.reference.uda.sinkhorn import sinkhorn_distance

DROPOUT = 0.1  # `TGCN.py:60,63-65`


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class MRConv(nn.Module):
    """Max-Relative graph conv: [x, max_j(y_j - x)] with the channels
    interleaved, then a grouped (4) 1x1 conv and GELU."""

    def __init__(self, in_channels: int, out_channels: int, groups: int = 4):
        super().__init__()
        self.nn = nn.Module()
        self.nn.conv_0 = nn.Conv1d(2 * in_channels, out_channels, 1, groups=groups)

    def forward(self, x: torch.Tensor, nn_idx: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        x_j = gather_neighbors(y, nn_idx)
        agg = torch.amax(x_j - x.unsqueeze(2), dim=2)
        b, n, c = x.shape
        mixed = torch.stack([x, agg], dim=-1).reshape(b, n, 2 * c).transpose(1, 2)
        return gelu(self.nn.conv_0(mixed))


def queue_update(queue: torch.Tensor, feats: torch.Tensor, labels: torch.Tensor,
                 m: float) -> torch.Tensor:
    """The EMA enqueue (`TGCN.py:296-302`) on a copy of `queue` (C, K): for
    each item i in order, column labels[i] <- m * column + (1 - m) * feats[i].
    In order, as the reference's loop, so that a repeated label composes as
    two EMA steps."""
    queue = queue.clone()
    for i in range(feats.shape[0]):
        col = labels[i:i + 1].long()
        queue.index_copy_(1, col, queue.index_select(1, col) * m + feats[i, :, None] * (1 - m))
    return queue


class TGCN(nn.Module):
    def __init__(self, cfg: TGCNConfig, sinkhorn: SinkhornConfig = SinkhornConfig()):
        super().__init__()
        self.cfg, self.sinkhorn = cfg, sinkhorn
        c, h = cfg.input_dim, cfg.hidden_dim
        t, gh, gw = cfg.clip_shape
        # the 3x3/s2 VALID head needs >= 3 nodes a side, or its mean is NaN
        assert gh >= 3 and gw >= 3, f"TGCN node grid {gh}x{gw} too small for the prediction head"
        self.mlp_conv1 = conv2d(len(cfg.pool_ratios) * c, h, 1)
        self.mlp_bn = BatchNorm2d(h)
        self.mlp_conv2 = conv2d(h, h, 1)
        self.mr_conv = MRConv(h, h)
        self.graph_attention = MultiHeadAttention(c, 1, dropout=DROPOUT)
        self.pos_embed = nn.Parameter(torch.zeros(t, 1, c, gh, gw))
        self.pred_conv = conv2d(h, h, 3, stride=2)
        self.pred_bn = BatchNorm2d(h)
        if cfg.cluster_method == "linear_clustering":
            self.classifier_source = linear(h, cfg.source_class)
            self.classifier_target = linear(h, cfg.target_class)
        if cfg.transport_method == "node_discriminate":
            for i in range(3):
                setattr(self, f"node_dis_{i}", linear(c, c))
                setattr(self, f"node_dis_ln_{i}",
                        LayerNorm(c, eps=1e-5, elementwise_affine=False))
            self.node_dis_out = linear(c, 1)
        self.gelu = gelu

    def forward(self, pyramid_clips: Sequence[torch.Tensor],
                source_nodes: torch.Tensor, source_valid: torch.Tensor,
                target_nodes: torch.Tensor, target_valid: torch.Tensor,
                queues: Tuple[torch.Tensor, torch.Tensor],
                update_idx: Tuple[torch.Tensor, torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> Tuple[Dict[str, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
        """pyramid_clips: 4 tensors (B, T, C, H_l, W_l), source clips in the
        first half of B, target clips in the second (`train_camus_echo.py:246`).
        source/target_nodes: (N, C) GModule nodes (the caller detaches them,
        `:278`) with their (N,) validity. queues: (queue_source, queue_target),
        each (hidden, K). update_idx: per-domain (B/2,) video indices. Train
        mode is `self.training`. Returns (losses, new queues)."""
        cfg = self.cfg
        train = self.training
        t_len, gh, gw = cfg.clip_shape
        b = pyramid_clips[0].shape[0]
        losses: Dict[str, torch.Tensor] = {}

        # every frame of every level onto the grid in one batched pool a level
        frames = torch.cat([adaptive_avg_pool2d(lvl.reshape(b * t_len, *lvl.shape[2:]), gh, gw)
                            for lvl in pyramid_clips], dim=1)
        frames = frames.reshape(b, t_len, -1, gh, gw)

        # the graph conv's output dtype, which the recurrence carries
        hidden = frames.new_zeros(b, gh * gw, cfg.hidden_dim)
        for t in range(t_len):
            x = self.gelu(self.mlp_bn(self.mlp_conv1(frames[:, t])))
            x = attention.dropout(x, DROPOUT, train, generator)
            x = self.mlp_conv2(x) + self.pos_embed[t]
            x = x.flatten(2).transpose(1, 2)  # (B, N, C)
            nn_idx = knn_graph(x, hidden, cfg.knn_k)
            hidden = self.mr_conv(x, nn_idx, hidden).transpose(1, 2)

        # prediction head -> clip embedding (B, hidden)
        e = self.pred_conv(hidden.transpose(1, 2).reshape(b, -1, gh, gw))
        e = attention.dropout(self.gelu(self.pred_bn(e)), DROPOUT, train, generator)
        output_f = e.mean(dim=(2, 3))

        idx_s, idx_t = update_idx
        queue_s, queue_t = queues
        half = b // 2
        if cfg.cluster_method == "momentum_queue":
            q = F.normalize(output_f, dim=1, eps=1e-12)
            # the loss reads the bank as it was before this step's update
            bank = torch.cat([queue_s, queue_t], dim=-1).detach()
            l_pos = q @ bank
            qd = q.detach()
            queue_s = queue_update(queue_s, qd[:half], idx_s, cfg.queue_momentum)
            queue_t = queue_update(queue_t, qd[half:], idx_t, cfg.queue_momentum)
            labels = torch.cat([idx_s, idx_t + cfg.queue_size])
            losses["clustering_loss"] = cross_entropy(l_pos, labels)
        elif cfg.cluster_method == "linear_clustering":
            losses["clustering_loss"] = (
                cross_entropy(self.classifier_source(output_f[:half]), idx_s)
                + cross_entropy(self.classifier_target(output_f[half:]), idx_t))

        # joint attention over [clip nodes; source nodes; target nodes]
        out_g = hidden.reshape(b * gh * gw, -1)
        all_nodes = torch.cat([out_g, source_nodes, target_nodes], dim=0)
        key_mask = torch.cat([torch.ones(out_g.shape[0], dtype=torch.bool, device=out_g.device),
                              source_valid, target_valid])
        attended, _ = self.graph_attention(all_nodes, all_nodes, all_nodes, key_mask=key_mask,
                                           train=train, generator=generator)
        nodes_g = attended[:out_g.shape[0]].reshape(b, gh * gw, -1)

        if cfg.transport_method == "node_discriminate":
            x = gradient_reversal(nodes_g.reshape(b * gh * gw, -1), 0.02)
            for i in range(3):
                x = F.relu(getattr(self, f"node_dis_ln_{i}")(getattr(self, f"node_dis_{i}")(x)))
            logits = self.node_dis_out(x)[:, 0]
            n_src = half * gh * gw
            target = torch.cat([logits.new_ones(n_src), logits.new_zeros(logits.shape[0] - n_src)])
            losses["node_dis_loss"] = 0.1 * bce_with_logits(logits, target)
        elif cfg.transport_method == "sinkhorn_distance":
            s = self.sinkhorn
            cost, _, _ = sinkhorn_distance(nodes_g[:half], nodes_g[half:], eps=s.eps,
                                           max_iter=s.max_iter, reduction=s.reduction)
            losses["sinkhorn_loss"] = cost
        return losses, (queue_s, queue_t)
