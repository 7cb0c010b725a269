"""Log-domain Sinkhorn, in float32 (a frozen copy of the system's math).

  * `sinkhorn_rpm`: slack-padded normalization of a log score matrix
    (reference `models/graph_matching.py:637-689`). A fixed number of
    row/column rounds, no early stop (the reference default `eps=-1` disables
    it too);
  * `sinkhorn_distance`: the entropic OT cost between two point clouds with
    uniform marginals (reference `utils/sinkhorn_distance.py:5-91`), the
    TGCN's `sinkhorn_distance` transport.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_NEG_INF = -1e9


def sinkhorn_rpm(log_alpha: torch.Tensor, n_iters: int = 5, slack: bool = True,
                 row_mask: Optional[torch.Tensor] = None,
                 col_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """log_alpha: (B, J, K). With `slack`, one zero slack row and column are
    padded and never normalized, so each real row/column sums to <= 1.
    row_mask/col_mask: (B, J)/(B, K) bool; invalid rows/columns are pushed to
    -1e9 so padded node slots absorb no mass. Returns (B, J, K) log of the
    (near) doubly-stochastic matrix."""
    log_alpha = log_alpha.float()
    if row_mask is not None:
        log_alpha = torch.where(row_mask[:, :, None], log_alpha, _NEG_INF)
    if col_mask is not None:
        log_alpha = torch.where(col_mask[:, None, :], log_alpha, _NEG_INF)

    if slack:
        a = F.pad(log_alpha, (0, 1, 0, 1))
        for _ in range(n_iters):
            a = torch.cat([a[:, :-1] - torch.logsumexp(a[:, :-1], dim=2, keepdim=True),
                           a[:, -1:]], dim=1)
            a = torch.cat([a[:, :, :-1] - torch.logsumexp(a[:, :, :-1], dim=1,
                                                          keepdim=True),
                           a[:, :, -1:]], dim=2)
        out = a[:, :-1, :-1]
    else:
        out = log_alpha
        for _ in range(n_iters):
            out = out - torch.logsumexp(out, dim=2, keepdim=True)
            out = out - torch.logsumexp(out, dim=1, keepdim=True)

    if row_mask is not None:
        out = torch.where(row_mask[:, :, None], out, _NEG_INF)
    if col_mask is not None:
        out = torch.where(col_mask[:, None, :], out, _NEG_INF)
    return out


def _cost_matrix(x: torch.Tensor, y: torch.Tensor, p: int = 2) -> torch.Tensor:
    """|x_i - y_j|^p summed over features (reference `sinkhorn_distance.py:80-86`)."""
    return torch.sum(torch.abs(x[..., :, None, :] - y[..., None, :, :]) ** p, dim=-1)


def sinkhorn_distance(x: torch.Tensor, y: torch.Tensor, eps: float = 0.1,
                      max_iter: int = 5, reduction: str = "none"
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (..., P1, D), y: (..., P2, D), uniform marginals. Returns (cost,
    transport plan pi, cost matrix C), the reference's contract
    (`sinkhorn_distance.py:73`), after `max_iter` log-domain rounds."""
    C = _cost_matrix(x, y)
    p1, p2 = x.shape[-2], y.shape[-2]
    # the reference's +1e-8 inside the log marginals
    log_mu = torch.log(torch.full(C.shape[:-1], 1.0 / p1, dtype=C.dtype, device=C.device) + 1e-8)
    log_nu = torch.log(torch.full(C.shape[:-2] + (p2,), 1.0 / p2, dtype=C.dtype,
                                  device=C.device) + 1e-8)

    def M(u, v):
        return (-C + u[..., :, None] + v[..., None, :]) / eps

    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(max_iter):
        u = eps * (log_mu - torch.logsumexp(M(u, v), dim=-1)) + u
        v = eps * (log_nu - torch.logsumexp(M(u, v).transpose(-2, -1), dim=-1)) + v

    pi = torch.exp(M(u, v))
    cost = torch.sum(pi * C, dim=(-2, -1))
    if reduction == "mean":
        cost = cost.mean()
    elif reduction == "sum":
        cost = cost.sum()
    return cost, pi, C
