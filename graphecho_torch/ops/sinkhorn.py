"""Slack-padded log-domain Sinkhorn, port of
`graphecho_tpu/ops/sinkhorn.py::sinkhorn_rpm` (reference
`models/graph_matching.py:637-689`). A fixed number of row/column rounds, no
early stop (the reference default `eps=-1` disables it too).
"""

from __future__ import annotations

from typing import Optional

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
