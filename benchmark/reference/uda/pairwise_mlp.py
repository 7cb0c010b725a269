"""The pairwise-concat MLP of the affinity layer, in plain PyTorch.

M[i, j] = w2 . relu(a_i + b_j) + b2, with a = X Wx + b1 and b = Y Wy: the
first Linear of the reference `Affinity` MLP split into its X and Y halves.
Autograd differentiates it; relu's gradient is 1[t > 0] (0 at NaN).
"""

from __future__ import annotations

import torch


def _relu(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t > 0, t, torch.relu(t.detach()))


def pairwise_mlp(a: torch.Tensor, b: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor, block: int = 128) -> torch.Tensor:
    """a: (N1, K), b: (N2, K), w2: (K,), b2: scalar -> (N1, N2), in row
    blocks of `a` so the (block, N2, K) broadcast stays bounded."""
    rows = [torch.sum(_relu(a[s:s + block, None, :] + b[None, :, :]) * w2, dim=-1)
            for s in range(0, a.shape[0], block)]
    return torch.cat(rows, dim=0) + b2
