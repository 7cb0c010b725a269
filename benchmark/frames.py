"""Echo-like frames and their masks, made on the host from a numpy
generator: speckle in [0, 0.3] and one bright ellipse per foreground part.
A single part sits near the centre; several parts own a quadrant and a
brightness band each, so every mask channel is identifiable. With a
background channel, channel 0 is the complement of the parts' union."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def frames(rng: np.random.Generator, n: int, h: int, w: int, n_channels: int,
           bg_channel: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(n, h, w, 1) float32 frames in [0, 1] and (n, h, w, n_channels)
    float32 masks."""
    n_fg = n_channels - int(bg_channel)
    ys = np.arange(h, dtype=np.float32)[None, :, None]
    xs = np.arange(w, dtype=np.float32)[None, None, :]
    img = rng.random((n, h, w), dtype=np.float32) * np.float32(0.3)
    masks = np.zeros((n, h, w, n_channels), np.float32)
    union = np.zeros((n, h, w), bool)
    for idx in range(n_fg):
        if n_fg == 1:
            cy, cx = (rng.uniform(0.3, 0.7, (2, n)) * np.array([[h], [w]])).astype(np.float32)
            ry, rx = (rng.uniform(0.12, 0.3, (2, n)) * np.array([[h], [w]])).astype(np.float32)
            bright = 0.5 * rng.uniform(0.5, 1.0, n)
        else:
            qy, qx = divmod(idx % 4, 2)
            cy = ((0.25 + 0.5 * qy + rng.uniform(-0.06, 0.06, n)) * h).astype(np.float32)
            cx = ((0.25 + 0.5 * qx + rng.uniform(-0.06, 0.06, n)) * w).astype(np.float32)
            ry, rx = (rng.uniform(0.10, 0.18, (2, n)) * np.array([[h], [w]])).astype(np.float32)
            bright = 0.25 + 0.5 * (idx + 1) / n_fg + rng.uniform(-0.04, 0.04, n)
        inside = (((ys - cy[:, None, None]) / ry[:, None, None]) ** 2
                  + ((xs - cx[:, None, None]) / rx[:, None, None]) ** 2) <= 1.0
        masks[..., idx + int(bg_channel)] = inside
        union |= inside
        img += inside * bright.astype(np.float32)[:, None, None]
    if bg_channel:
        masks[..., 0] = ~union
    return np.clip(img, 0.0, 1.0)[..., None], masks


def video_frames(rng: np.random.Generator, n: int, h: int, w: int) -> np.ndarray:
    """(n, h, w) uint8 frames with one bright part each."""
    img, _ = frames(rng, n, h, w, 1, False)
    return (img[..., 0] * 255.0).round().astype(np.uint8)
