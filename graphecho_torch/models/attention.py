"""Graph attention blocks, port of `graphecho_tpu/models/attention.py`.

  * `MultiHeadAttention` with the reference's v2 semantics
    (`models/transformer.py:25-110`): unbatched node sets (N, C);
    scale = (dim_per_head // num_heads) ** -0.5 (a reference quirk, not the
    usual 1/sqrt(d)); the residual is the RAW query; post-LN; returns
    (output, attention matrix). The attention matrix doubles as the graph's
    edge matrix for the quadratic matching loss.
  * `CrossGraph`, the bi-directional message passing of `transformer.py:115-160`
    (defined but unused upstream).

As in the JAX package, an optional boolean `key_mask` keeps padded node slots
out of the softmax. Dropout draws its mask from the caller's
`torch.Generator`, so a run is reproducible from its seed.

`dtype` is flax's: the linears compute in it and the LayerNorm in f32 with a
`dtype` output (`models/backbones.py::set_compute_dtype`); the attention
logits accumulate in f32 (`preferred_element_type`) and are cast back to the
values' dtype for the weighted sum, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from graphecho_torch.models.backbones import LayerNorm, Linear, set_compute_dtype
from graphecho_torch.models.initializers import set_init

_NEG_INF = -1e9


def dropout(x: torch.Tensor, p: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout (keep with prob 1-p, scale by 1/(1-p)) from an
    explicit generator; the identity outside training or at p = 0."""
    if not train or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep.to(x.dtype) / (1.0 - p)


def linear(cin: int, cout: int, bias: bool = True, init="lecun") -> Linear:
    return set_init(Linear(cin, cout, bias=bias), init)


class MultiHeadAttention(nn.Module):
    def __init__(self, model_dim: int = 256, num_heads: int = 1, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.model_dim, self.num_heads, self.p = model_dim, num_heads, dropout
        self.linear_k = linear(model_dim, model_dim)
        self.linear_v = linear(model_dim, model_dim)
        self.linear_q = linear(model_dim, model_dim)
        self.linear_final = linear(model_dim, model_dim)
        self.layer_norm = LayerNorm(model_dim, eps=1e-5)
        set_compute_dtype(self, dtype)

    def forward(self, key: torch.Tensor, value: torch.Tensor, query: torch.Tensor,
                key_mask: Optional[torch.Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """key/value/query: (N, C). key_mask: (N_k,) bool, False entries are
        left out of the softmax. Returns ((N_q, C), attention)."""
        h = self.num_heads
        dph = self.model_dim // h
        residual = query

        def heads(x):  # (N, C) -> (heads, N, dph)
            return x.reshape(x.shape[0], h, dph).transpose(0, 1)

        k = heads(self.linear_k(key))
        v = heads(self.linear_v(value))
        q = heads(self.linear_q(query))

        # reference quirk: scale = (dim_per_head // num_heads) ** -0.5
        scale = float(dph // h) ** -0.5
        acc = torch.promote_types(q.dtype, torch.float32)
        attn = torch.einsum("hqd,hkd->hqk", q.to(acc), k.to(acc)) * scale
        if key_mask is not None:
            attn = torch.where(key_mask[None, None, :], attn, _NEG_INF)
        attn = torch.softmax(attn, dim=-1)
        attn = dropout(attn, self.p, train, generator)

        context = torch.einsum("hqk,hkd->hqd", attn.to(v.dtype), v)
        context = context.transpose(0, 1).reshape(query.shape[0], self.model_dim)
        out = dropout(self.linear_final(context), self.p, train, generator)
        out = self.layer_norm(residual + out)
        return out, (attn[0] if h == 1 else attn)


class CrossGraph(nn.Module):
    """Bi-directional cross-graph node update (`transformer.py:115-160`)."""

    def __init__(self, model_dim: int = 256, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.p = dropout
        self.linear_edge = linear(model_dim, model_dim)
        self.linear_node1 = linear(model_dim, model_dim)
        self.linear_final = linear(model_dim, model_dim)
        self.layer_norm = LayerNorm(model_dim, eps=1e-5)
        set_compute_dtype(self, dtype)

    def forward(self, node_1: torch.Tensor, node_2: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        edge1 = self.linear_edge(node_1)
        edge2 = self.linear_edge(node_2)
        n1p = self.linear_node1(node_1)
        n2p = self.linear_node1(node_2)
        attention = edge1 @ edge2.T
        out_1 = torch.softmax(attention, dim=-1) @ n2p
        out_2 = torch.softmax(attention.T, dim=-1) @ n1p
        out_1 = dropout(self.linear_final(out_1), self.p, train, generator)
        out_2 = dropout(self.linear_final(out_2), self.p, train, generator)
        return self.layer_norm(node_1 + out_1), self.layer_norm(node_2 + out_2)

