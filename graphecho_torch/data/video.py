"""Video IO + statistics utilities for EchoNet-style AVI datasets, port of
`graphecho_tpu/data/video.py`.

Re-implements the reference's video helpers (`datasets/echo.py`):
  * `loadvideo` (`:294-328`) — cv2 AVI decode to (F, H, W, C) float-ready u8
    (the reference returns (C, F, H, W); we keep frames-first NHWC, the batch
    contract, and convert at the contract boundary);
  * `savevideo` (`:331-350`);
  * `get_mean_and_std` (`:353-394`);
  * `bootstrap` confidence intervals (`:397-420`);
  * `dice_similarity_coefficient` (`:440-446`).

cv2 is imported inside the functions that decode or encode, never at import
time: only EchoNet's `.avi` path needs it.
"""

from __future__ import annotations

import os
from typing import Callable, Sequence, Tuple

import numpy as np


def loadvideo(filename: str, grey: bool = True) -> np.ndarray:
    """Decode an AVI to (F, H, W, C) uint8 (C=1 grayscale like the reference's
    `grey=True` path)."""
    import cv2

    if not os.path.exists(filename):
        raise FileNotFoundError(filename)
    capture = cv2.VideoCapture(filename)
    frame_count = int(capture.get(cv2.CAP_PROP_FRAME_COUNT))
    frames = []
    for _ in range(frame_count):
        ret, frame = capture.read()
        if not ret:
            break
        if grey:
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)[..., None]
        else:
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        frames.append(frame)
    capture.release()
    if not frames:
        raise ValueError(f"no frames decoded from {filename}")
    return np.stack(frames)


def savevideo(filename: str, array: np.ndarray, fps: int = 1) -> None:
    """array: (F, H, W) or (F, H, W, C) uint8."""
    import cv2

    if array.ndim == 3:
        array = array[..., None]
    f, h, w, c = array.shape
    fourcc = cv2.VideoWriter_fourcc(*"MJPG")
    out = cv2.VideoWriter(filename, fourcc, fps, (w, h))
    for i in range(f):
        frame = array[i]
        if frame.shape[-1] == 1:
            frame = np.repeat(frame, 3, axis=-1)
        out.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    out.release()


def get_mean_and_std(dataset, samples: int = 128,
                     getter: Callable = lambda x: x[0]) -> Tuple[float, float]:
    """Running mean/std over dataset images (`echo.py:353-394` equivalent)."""
    n, s1, s2 = 0, 0.0, 0.0
    count = min(len(dataset), samples)
    for i in range(count):
        x = np.asarray(getter(dataset[i]), np.float64).ravel()
        n += x.size
        s1 += x.sum()
        s2 += (x**2).sum()
    mean = s1 / n
    std = float(np.sqrt(s2 / n - mean**2))
    return float(mean), std


def bootstrap(a: Sequence[float], b: Sequence[float],
              func: Callable, samples: int = 10000,
              seed: int = 0) -> Tuple[float, float, float]:
    """(value, 5th pct, 95th pct) bootstrap CI (`echo.py:397-420`)."""
    a = np.asarray(a)
    b = np.asarray(b)
    rng = np.random.RandomState(seed)
    bootstraps = []
    for _ in range(samples):
        idx = rng.choice(len(a), len(a))
        bootstraps.append(func(a[idx], b[idx]))
    bootstraps = np.sort(bootstraps)
    return (func(a, b), bootstraps[round(0.05 * len(bootstraps))],
            bootstraps[round(0.95 * len(bootstraps))])


def dice_similarity_coefficient(inter: Sequence, union: Sequence) -> float:
    """2*|A∩B| / (|A| + |B|) from per-sample intersection/union lists
    (`echo.py:440-446`)."""
    return 2 * float(np.sum(inter)) / (float(np.sum(union))
                                       + float(np.sum(inter)))
