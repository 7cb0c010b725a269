"""Regression and segmentation metric wrappers, port of
`graphecho_tpu/utils/metric_wrappers.py` (reference `utils/metrics.py:20-45`,
sklearn and MONAI wrappers) in plain numpy on the host. The trainers do not
call them (they count confusion sums on the device, `train/metrics.py`);
they are kept for the API.
"""

from __future__ import annotations

import numpy as np


def mse(y_true, y_pred) -> float:
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    return float(np.mean((y_true - y_pred) ** 2))


def mae(y_true, y_pred) -> float:
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    return float(np.mean(np.abs(y_true - y_pred)))


def rmse(y_true, y_pred) -> float:
    return float(np.sqrt(mse(y_true, y_pred)))


def r2_score(y_true, y_pred) -> float:
    y_true = np.asarray(y_true, np.float64)
    y_pred = np.asarray(y_pred, np.float64)
    ss_res = np.sum((y_true - y_pred) ** 2)
    ss_tot = np.sum((y_true - np.mean(y_true)) ** 2)
    return float(1.0 - ss_res / ss_tot) if ss_tot > 0 else 0.0


def dice_score_onehot(y_pred_logits, y_true_onehot,
                      include_background: bool = True) -> float:
    """MONAI-DiceMetric-style: argmax over channels, one-hot, mean per-class
    dice (`utils/metrics.py:35-45` equivalent). Channel-last arrays."""
    y_pred_logits = np.asarray(y_pred_logits)
    y_true = np.asarray(y_true_onehot)
    n_cls = y_pred_logits.shape[-1]
    pred_lab = np.argmax(y_pred_logits, axis=-1)
    pred = np.eye(n_cls, dtype=np.float32)[pred_lab]
    dices = []
    start = 0 if include_background else 1
    for c in range(start, n_cls):
        p = pred[..., c].ravel()
        t = y_true[..., c].ravel()
        inter = (p * t).sum()
        denom = p.sum() + t.sum()
        if denom > 0:
            dices.append(2 * inter / denom)
    return float(np.mean(dices)) if dices else float("nan")
