"""Temporal graph module (TGCN), port of `graphecho_tpu/models/tgcn.py`
(reference `models/TGCN.py:168-312`).

  * Every frame of a clip pools its 4 FPN levels onto the node grid, one
    batched adaptive pool per level, concatenates them (4C channels),
    projects them with a 1x1 conv MLP and adds a learned per-frame position
    embedding (`TGCN.py:62-72,182`).
  * A recurrence over the T frames, a Python loop in place of `nn.scan`: a
    kNN graph from the frame's nodes to the previous hidden state, then a
    Max-Relative graph conv gives the next hidden state (`:230-236`). The
    first hidden state is zeros, so the first frame's distances all tie.
    `mlp_bn` folds each frame's batch statistics into its running stats in
    frame order, as the scan carries them.
  * A prediction head pools the last hidden state into a clip embedding
    (`:184-190`); it runs, and `pred_bn` moves, whatever `cluster_method` is.
  * Optional clustering: a momentum queue (`:192-198,243-251`) or linear
    classifiers (`:200-202,253-256`).
  * Joint attention over [clip nodes; source nodes; target nodes], then a
    transport loss: a node discriminator behind gradient reversal
    (`:272-279`) or the Sinkhorn OT cost (`:281-283`).

Nodes are (B, N, C) as in the JAX package (N = the grid flattened row-major);
feature maps are NCHW. Module names are the flax names, so
`graphecho_torch.convert.from_flax` carries the weights over by walking the
tree; `pos_embed` is (T, 1, C, H, W). The queues are explicit state, passed
in and returned. The dropouts (0.1, hard-coded upstream) draw their masks
from the generator given to `forward`, through `attention.dropout`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from graphecho_torch.config import SinkhornConfig, TGCNConfig
from graphecho_torch.models import attention
from graphecho_torch.models.attention import MultiHeadAttention, linear
from graphecho_torch.models.backbones import BatchNorm2d, conv2d
from graphecho_torch.models.vig import MRConv, _act
from graphecho_torch.ops.grl import gradient_reversal
from graphecho_torch.ops.knn import dilated_knn_graph
from graphecho_torch.ops.resize import adaptive_avg_pool2d
from graphecho_torch.ops.sinkhorn import sinkhorn_distance
from graphecho_torch.train.losses import bce_with_logits, cross_entropy

DROPOUT = 0.1  # `TGCN.py:60,63-65`


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
        self.mr_conv = MRConv(h, h, act="gelu", norm=None)
        self.graph_attention = MultiHeadAttention(c, 1, dropout=DROPOUT)
        self.pos_embed = nn.Parameter(torch.zeros(t, 1, c, gh, gw))
        self.pred_conv = conv2d(h, h, 3, stride=2)
        self.pred_bn = BatchNorm2d(h)
        if cfg.cluster_method == "linear_clustering":
            self.classifier_source = linear(h, cfg.source_class)
            self.classifier_target = linear(h, cfg.target_class)
        if cfg.transport_method == "node_discriminate":
            for i in range(3):
                setattr(self, f"node_dis_{i}", linear(c, c, init=("normal", 0.01)))
                setattr(self, f"node_dis_ln_{i}",
                        nn.LayerNorm(c, eps=1e-5, elementwise_affine=False))
            self.node_dis_out = linear(c, 1, init=("normal", 0.01))
        self.gelu = _act("gelu")

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

        hidden = frames.new_zeros(b, gh * gw, cfg.hidden_dim)
        for t in range(t_len):
            x = self.gelu(self.mlp_bn(self.mlp_conv1(frames[:, t])))
            x = attention.dropout(x, DROPOUT, train, generator)
            x = self.mlp_conv2(x) + self.pos_embed[t]
            x = x.flatten(2).transpose(1, 2)  # (B, N, C)
            nn_idx = dilated_knn_graph(x, hidden, cfg.knn_k, 1)
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
            l_pos = q @ torch.cat([queue_s, queue_t], dim=-1).detach()
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
