"""GRU-style temporal graph convolution cells and the Laplacian helpers, port
of `graphecho_tpu/models/tgcn_cells.py` (reference `models/TGCN.py:11-38`,
`:81-165`). Upstream defines them and its `TGCN.forward` never calls them;
they are kept for completeness and as an alternative recurrence.

Parameter names and layouts are the flax ones: `weights` (in, out) and
`biases` (out,), so `graphecho_torch.convert.module_state_dict` carries them.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn


def laplacian_with_self_loop(matrix: torch.Tensor) -> torch.Tensor:
    """((A+I) D^-1/2)^T D^-1/2 per batch item (`TGCN.py:11-23`), with the
    reference's transpose (it feeds non-symmetric matrices). (..., N, N)."""
    n = matrix.shape[-1]
    a = matrix + torch.eye(n, dtype=matrix.dtype, device=matrix.device)
    d_inv_sqrt = torch.sum(a, dim=-1) ** -0.5
    d_inv_sqrt = torch.where(torch.isfinite(d_inv_sqrt), d_inv_sqrt,
                             torch.zeros_like(d_inv_sqrt))
    scaled = a * d_inv_sqrt[..., None, :]  # (A+I) D^-1/2
    return scaled.transpose(-2, -1) * d_inv_sqrt[..., None, :]


def laplacian_without_self_loop(graph: torch.Tensor, normalize: bool = False) -> torch.Tensor:
    """D - A, or I - D^-1/2 A D^-1/2 when `normalize` (`TGCN.py:25-38`). (N, N)."""
    deg = torch.sum(graph, dim=-1)
    if normalize:
        d_inv_sqrt = torch.where(deg > 0, deg ** -0.5, torch.zeros_like(deg))
        eye = torch.eye(graph.shape[-1], dtype=graph.dtype, device=graph.device)
        return eye - d_inv_sqrt[:, None] * graph * d_inv_sqrt[None, :]
    return torch.diag(deg) - graph


class TGCNGraphConvolution(nn.Module):
    """Graph conv over the per-batch feature Laplacian (`TGCN.py:81-129`).
    `input_dim` is the feature width F of `inputs` (flax infers it)."""

    def __init__(self, input_dim: int, num_gru_units: int, output_dim: int,
                 bias_init_value: float = 0.0):
        super().__init__()
        self.num_gru_units, self.output_dim = num_gru_units, output_dim
        self.bias_init_value = bias_init_value
        self.weights = nn.Parameter(torch.empty(num_gru_units + input_dim, output_dim))
        self.biases = nn.Parameter(torch.full((output_dim,), float(bias_init_value)))

    def init_parameters(self, gen: torch.Generator) -> None:
        """Xavier-uniform weights (flax's `xavier_uniform`), constant biases."""
        fan_in, fan_out = self.weights.shape
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        with torch.no_grad():
            self.weights.copy_((torch.rand(self.weights.shape, generator=gen) * 2 - 1) * bound)
            self.biases.fill_(self.bias_init_value)

    def forward(self, inputs: torch.Tensor, hidden_state: torch.Tensor) -> torch.Tensor:
        """inputs (B, N, F), hidden_state (B, N*units) -> (B, N*output_dim)."""
        b, n, _ = inputs.shape
        lap = laplacian_with_self_loop(inputs)
        hidden = hidden_state.reshape(b, n, self.num_gru_units)
        ax = torch.bmm(lap, torch.cat([inputs, hidden], dim=-1))
        out = ax.reshape(b * n, -1) @ self.weights + self.biases
        return out.reshape(b, n * self.output_dim)


class TGCNCell(nn.Module):
    """GRU cell over graph convolutions (`TGCN.py:140-161`)."""

    def __init__(self, input_dim: int, hidden_dim: int):
        super().__init__()
        self.input_dim, self.hidden_dim = input_dim, hidden_dim
        self.graph_conv1 = TGCNGraphConvolution(input_dim, hidden_dim, hidden_dim * 2, 1.0)
        self.graph_conv2 = TGCNGraphConvolution(input_dim, hidden_dim, hidden_dim)

    def forward(self, inputs: torch.Tensor, hidden_state: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        conc = torch.sigmoid(self.graph_conv1(inputs, hidden_state))
        r, u = torch.chunk(conc, 2, dim=1)
        c = torch.tanh(self.graph_conv2(inputs, r * hidden_state))
        new_hidden = u * hidden_state + (1.0 - u) * c
        return new_hidden, new_hidden
