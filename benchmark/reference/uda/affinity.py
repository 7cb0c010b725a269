"""Semantic-aware node affinity layer, in float32 (a frozen copy of the system's math).

Reference `Affinity` (`models/affinity_layer.py:8-73`):
M[i,j] = MLP([proj_sr(x_i); proj_tg(y_j)]) with MLP = Linear(2d, 2d) + ReLU +
Linear(2d, 1). The first Linear is kept split into its X and Y halves
(`fc1_wx`, `fc1_wy`, in (in, out) layout); the pairwise ReLU-reduce is
the plain `pairwise_mlp`.
"""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.uda.attention import linear
from benchmark.reference.uda.pairwise_mlp import pairwise_mlp


class Affinity(nn.Module):
    def __init__(self, d: int = 256):
        super().__init__()
        hidden = 2 * d
        self.project_sr = linear(d, d, bias=False, )
        self.project_tg = linear(d, d, bias=False)
        self.fc1_wx = nn.Parameter(torch.empty(d, hidden))
        self.fc1_wy = nn.Parameter(torch.empty(d, hidden))
        self.fc1_b = nn.Parameter(torch.zeros(hidden))
        self.fc2_w = nn.Parameter(torch.empty(hidden))
        self.fc2_b = nn.Parameter(torch.zeros(()))

    def forward(self, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        """X: (N1, d), Y: (N2, d) -> affinity M: (N1, N2)."""
        a = self.project_sr(X) @ self.fc1_wx + self.fc1_b  # (N1, hidden)
        b = self.project_tg(Y) @ self.fc1_wy  # (N2, hidden); b1 folded into a
        return pairwise_mlp(a, b, self.fc2_w, self.fc2_b)
