"""Semantic-aware node affinity layer, port of `graphecho_tpu/models/affinity.py`.

Reference `Affinity` (`models/affinity_layer.py:8-73`):
M[i,j] = MLP([proj_sr(x_i); proj_tg(y_j)]) with MLP = Linear(2d, 2d) + ReLU +
Linear(2d, 1). The first Linear is kept split into its X and Y halves
(`fc1_wx`, `fc1_wy`, in the JAX package's (in, out) layout), so the pairwise
ReLU-reduce runs fused: the CUDA kernel on the card, the plain version on the
CPU (`graphecho_torch.ops.pairwise_mlp.pairwise_mlp_auto`).
"""

from __future__ import annotations

import torch
from torch import nn

from graphecho_torch.models.attention import linear
from graphecho_torch.ops.pairwise_mlp import pairwise_mlp_auto


class Affinity(nn.Module):
    def __init__(self, d: int = 256):
        super().__init__()
        hidden = 2 * d
        self.project_sr = linear(d, d, bias=False, init=("normal", 0.01))
        self.project_tg = linear(d, d, bias=False, init=("normal", 0.01))
        self.fc1_wx = nn.Parameter(torch.empty(d, hidden))
        self.fc1_wy = nn.Parameter(torch.empty(d, hidden))
        self.fc1_b = nn.Parameter(torch.zeros(hidden))
        self.fc2_w = nn.Parameter(torch.empty(hidden))
        self.fc2_b = nn.Parameter(torch.zeros(()))

    @torch.no_grad()
    def init_parameters(self, gen: torch.Generator) -> None:
        """normal(0.01) weights and zero biases, as the flax module declares."""
        for w in (self.fc1_wx, self.fc1_wy, self.fc2_w):
            w.copy_(torch.randn(w.shape, generator=gen) * 0.01)
        self.fc1_b.zero_()
        self.fc2_b.zero_()

    def forward(self, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        """X: (N1, d), Y: (N2, d) -> affinity M: (N1, N2)."""
        a = self.project_sr(X) @ self.fc1_wx + self.fc1_b  # (N1, hidden)
        b = self.project_tg(Y) @ self.fc1_wy  # (N2, hidden); b1 folded into a
        return pairwise_mlp_auto(a, b, self.fc2_w, self.fc2_b)
