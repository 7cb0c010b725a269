"""Dense kNN graph in plain PyTorch: L2-normalised rows, squared
distances, the k nearest keys in ascending distance with ties to the lowest
column (a stable sort)."""

from __future__ import annotations

from typing import Optional

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp_min(norm, eps)


def pairwise_sq_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, M, C) -> (B, N, M) squared distances, no gradient."""
    x, y = x.detach(), y.detach()
    x_sq = torch.sum(x * x, dim=-1, keepdim=True)
    y_sq = torch.sum(y * y, dim=-1, keepdim=True)
    return x_sq - 2.0 * torch.bmm(x, y.transpose(1, 2)) + y_sq.transpose(-2, -1)


def knn_graph(x: torch.Tensor, y: Optional[torch.Tensor], k: int) -> torch.Tensor:
    """(B, N, k) int32 indices of each x-row's k nearest y-rows (y = x when
    None), both L2-normalised."""
    x = l2_normalize(x.detach().float())
    y = x if y is None else l2_normalize(y.detach().float())
    dist = pairwise_sq_distance(x, y)
    return torch.sort(dist, dim=-1, stable=True).indices[..., :k].to(torch.int32)


def gather_neighbors(y: torch.Tensor, nn_idx: torch.Tensor) -> torch.Tensor:
    """y: (B, M, C), nn_idx: (B, N, k) -> (B, N, k, C)."""
    b, m, c = y.shape
    _, n, k = nn_idx.shape
    base = (torch.arange(b, device=nn_idx.device) * m)[:, None, None]
    flat = (nn_idx.long() + base).reshape(-1)
    return y.reshape(b * m, c).index_select(0, flat).reshape(b, n, k, c)
