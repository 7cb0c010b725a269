"""Graph attention blocks, in float32 (a frozen copy of the system's math).

  * `MultiHeadAttention` with the reference's v2 semantics
    (`models/transformer.py:25-110`): unbatched node sets (N, C);
    scale = (dim_per_head // num_heads) ** -0.5 (a reference quirk, not the
    usual 1/sqrt(d)); the residual is the RAW query; post-LN; returns
    (output, attention matrix). The attention matrix doubles as the graph's
    edge matrix for the quadratic matching loss.

As in the JAX package, an optional boolean `key_mask` keeps padded node slots
out of the softmax. Dropout draws its mask from the caller's
`torch.Generator`, so a run is reproducible from its seed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from benchmark.reference.uda.backbones import LayerNorm, Linear

_NEG_INF = -1e9


def dropout(x: torch.Tensor, p: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout (keep with prob 1-p, scale by 1/(1-p)) from an
    explicit generator; the identity outside training or at p = 0."""
    if not train or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep.to(x.dtype) / (1.0 - p)


def linear(cin: int, cout: int, bias: bool = True) -> Linear:
    return Linear(cin, cout, bias=bias)


class MultiHeadAttention(nn.Module):
    def __init__(self, model_dim: int = 256, num_heads: int = 1, dropout: float = 0.0):
        super().__init__()
        self.model_dim, self.num_heads, self.p = model_dim, num_heads, dropout
        self.linear_k = linear(model_dim, model_dim)
        self.linear_v = linear(model_dim, model_dim)
        self.linear_q = linear(model_dim, model_dim)
        self.linear_final = linear(model_dim, model_dim)
        self.layer_norm = LayerNorm(model_dim, eps=1e-5)

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
