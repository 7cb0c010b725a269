"""Segmentation metrics as confusion-count reductions, port of
`graphecho_tpu/train/metrics.py`.

The reference's inline `_calculate_overlap_metrics`
(`train_camus_echo.py:402-417`): flatten, TP/FP/FN/TN, eps=1e-5,
dice = (2TP+eps)/(2TP+FP+FN+eps).
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch


class OverlapMetrics(NamedTuple):
    pixel_acc: torch.Tensor
    dice: torch.Tensor
    precision: torch.Tensor
    specificity: torch.Tensor
    recall: torch.Tensor


def confusion_counts(gt: torch.Tensor, pred: torch.Tensor) -> Dict[str, torch.Tensor]:
    """TP/FP/FN/TN sums over all elements. `pred` is already binarized."""
    output = pred.reshape(-1).float()
    target = gt.reshape(-1).float()
    tp = torch.sum(output * target)
    fp = torch.sum(output * (1 - target))
    fn = torch.sum((1 - output) * target)
    tn = torch.sum((1 - output) * (1 - target))
    return {"tp": tp, "fp": fp, "fn": fn, "tn": tn}


def overlap_metrics_from_counts(c: Dict[str, torch.Tensor], eps: float = 1e-5
                                ) -> OverlapMetrics:
    tp, fp, fn, tn = c["tp"], c["fp"], c["fn"], c["tn"]
    return OverlapMetrics(
        pixel_acc=(tp + tn + eps) / (tp + tn + fp + fn + eps),
        dice=(2 * tp + eps) / (2 * tp + fp + fn + eps),
        precision=(tp + eps) / (tp + fp + eps),
        specificity=(tn + eps) / (tn + fp + eps),
        recall=(tp + eps) / (tp + fn + eps),
    )


def calculate_overlap_metrics(gt: torch.Tensor, pred: torch.Tensor,
                              eps: float = 1e-5) -> OverlapMetrics:
    """Drop-in equivalent of the reference metric function (`pred` binarized)."""
    return overlap_metrics_from_counts(confusion_counts(gt, pred), eps)


def binarize_logits(logits: torch.Tensor, thresh: float = 0.5) -> torch.Tensor:
    """sigmoid(logits) > thresh as {0,1} — the reference's prediction rule."""
    return (1.0 / (1.0 + torch.exp(-logits)) > thresh).to(torch.int32)
