"""Segmentation / matching losses, in float32 (a frozen copy of the system's math).

  * BinaryDiceLoss / DiceLoss  (reference `utils/losses.py:24-95`)
  * BCEWithLogits              (the torch loss the trainers use)
  * BCEFocalLoss on probabilities (`models/graph_matching.py:23-45`)
  * FocalLoss on logits        (`models/gradient_reversal.py:35-39`)

The port keeps tensors NCHW, so `dice_loss` defaults to channel axis 1 (the
JAX package's default is -1, its NHWC channel axis).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def binary_dice_loss(predict: torch.Tensor, target: torch.Tensor,
                     smooth: float = 1.0, p: int = 2,
                     reduction: str = "mean") -> torch.Tensor:
    """Dice loss of a binary prediction (a probability map), flattened per
    sample: num = sum(x*y)+smooth, den = sum(x^p + y^p)+smooth."""
    n = predict.shape[0]
    predict = predict.reshape(n, -1)
    target = target.reshape(n, -1)
    num = torch.sum(predict * target, dim=1) + smooth
    den = torch.sum(predict ** p + target ** p, dim=1) + smooth
    loss = 1.0 - num / den
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def dice_loss(logits: torch.Tensor, target: torch.Tensor,
              channel_axis: int = 1) -> torch.Tensor:
    """Multi-channel dice: softmax over channels, then the mean of the
    per-channel binary dice (`utils/losses.py:64-95`)."""
    prob = torch.softmax(logits.float(), dim=channel_axis)
    prob = torch.movedim(prob, channel_axis, 1)
    target = torch.movedim(target, channel_axis, 1)
    c = prob.shape[1]
    total = 0.0
    for i in range(c):
        total = total + binary_dice_loss(prob[:, i], target[:, i])
    return total / c


def bce_with_logits(logits: torch.Tensor, target: torch.Tensor,
                    weight: Optional[torch.Tensor] = None,
                    reduction: str = "mean") -> torch.Tensor:
    """Stable binary cross entropy with logits, in f32:
    max(x,0) - x*z + log(1+exp(-|x|)). A weighted mean divides by sum(weight)."""
    logits = logits.float()
    target = target.float()
    loss = logits.clamp_min(0) - logits * target + torch.log1p(torch.exp(-logits.abs()))
    if weight is not None:
        loss = loss * weight
    if reduction == "mean":
        if weight is not None:
            return loss.sum() / weight.sum().clamp_min(1e-8)
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def bce_focal_loss_probs(p: torch.Tensor, target: torch.Tensor,
                         gamma: float = 2.0, alpha: float = 0.25,
                         mask: Optional[torch.Tensor] = None,
                         eps: float = 1e-7) -> torch.Tensor:
    """Focal BCE on probabilities, elementwise mean (over the `mask`ed
    entries when given)."""
    p = p.clamp(eps, 1.0 - eps)
    loss = (-alpha * (1 - p) ** gamma * target * torch.log(p)
            - (1 - alpha) * p ** gamma * (1 - target) * torch.log(1 - p))
    if mask is None:
        return loss.mean()
    mask = mask.to(loss.dtype)
    return (loss * mask).sum() / mask.sum().clamp_min(1.0)


def focal_loss_logits(logits: torch.Tensor, target: torch.Tensor,
                      gamma: float = 5.0) -> torch.Tensor:
    """Focal loss on logits (`models/gradient_reversal.py:35-39`)."""
    bce = bce_with_logits(logits, target, reduction="none")
    pt = torch.exp(-bce)
    return ((1 - pt) ** gamma * bce).mean()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weight: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-class CE over int labels with optional per-sample weight and
    validity mask (masked mean). Out-of-range labels contribute 0, as the
    JAX package's one-hot formulation gives."""
    log_p = F.log_softmax(logits, dim=-1)
    n_cls = logits.shape[-1]
    in_range = (labels >= 0) & (labels < n_cls)
    picked = torch.gather(log_p, -1, labels.clamp(0, n_cls - 1).long()[..., None])[..., 0]
    nll = -picked * in_range.to(log_p.dtype)
    if weight is not None:
        nll = nll * weight
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
