"""Host-side image transforms matching the reference's MONAI pipeline, a
port of `graphecho_tpu/data/transforms.py`.

The reference composes AddChannel → Resized(mode='nearest') →
RandSpatialCrop/CenterSpatialCrop → EnsureType (`datasets/camus.py:142-158`,
`cardiac_uda.py:269-285`; the RandFlips it constructs are never added to the
Compose). `nearest_resize` of float32 and uint8 arrays and `polygon_mask` run
in the host C++ kernels of `data/native.py` (`csrc/dataops.cpp`, a copy of the
JAX package's `native/dataops.cpp`), where the JAX transforms call theirs;
other dtypes, and every call on a host where the library cannot be built or
loaded (`native.try_load()` warns once), take the numpy versions,
`nearest_resize_plain` and `polygon_mask_plain`, which compute the same
bytes. Nearest resize takes source index floor(i*in/out): the C++ kernel as
floor(i*(double)in/out), the numpy version in exact integer arithmetic, equal
for every size a loader meets (`tests/test_torch_native.py`).

The JAX package falls back too, but to numpy versions of its own (float
index arithmetic, a fill rounded twice) that can differ from its C++ path.
The port's fallback copies the C++ path instead, which is what the JAX
package runs wherever it has a compiler: a host without g++ loads the same
items and prepares the same frames as one with it.

`polygon_mask` replaces `skimage.draw.polygon` for the EchoNet LV-trace
rasterization (`datasets/echo.py:243-255`): even-odd scanline fill.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Optional, Sequence, Tuple

import numpy as np

from graphecho_torch.data import native


def nearest_resize(arr: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Nearest resize of the LEADING two spatial dims (H, W, ...) with torch
    'nearest' semantics; float32 and uint8 in the C++ kernel."""
    h, w = arr.shape[:2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return arr
    if arr.dtype in native.DTYPES and native.try_load() is not None:
        return native.nearest_resize(arr, oh, ow)
    return nearest_resize_plain(arr, out_hw)


def nearest_resize_plain(arr: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """`nearest_resize` in numpy, for any dtype."""
    h, w = arr.shape[:2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return arr
    iy = np.arange(oh, dtype=np.int64) * h // oh
    ix = np.arange(ow, dtype=np.int64) * w // ow
    return arr[iy][:, ix]


def center_crop(arr: np.ndarray, crop_hw: Tuple[int, int]) -> np.ndarray:
    h, w = arr.shape[:2]
    ch, cw = crop_hw
    y0 = max((h - ch) // 2, 0)
    x0 = max((w - cw) // 2, 0)
    return arr[y0:y0 + ch, x0:x0 + cw]


def rand_crop(arr: np.ndarray, crop_hw: Tuple[int, int],
              rng: np.random.RandomState) -> np.ndarray:
    h, w = arr.shape[:2]
    ch, cw = crop_hw
    y0 = rng.randint(0, max(h - ch, 0) + 1)
    x0 = rng.randint(0, max(w - cw, 0) + 1)
    return arr[y0:y0 + ch, x0:x0 + cw]


def resize_and_crop(images: np.ndarray, masks: Optional[np.ndarray],
                    spatial: Tuple[int, int], crop: Tuple[int, int],
                    train: bool, rng: Optional[np.random.RandomState] = None
                    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """The reference transform pipeline on (H, W, ...) arrays. Images and
    masks share the same random crop (MONAI dict-transform semantics)."""
    images = nearest_resize(images, spatial)
    if masks is not None:
        masks = nearest_resize(masks, spatial)
    if train:
        rng = rng or np.random.RandomState()
        h, w = images.shape[:2]
        ch, cw = crop
        y0 = rng.randint(0, max(h - ch, 0) + 1)
        x0 = rng.randint(0, max(w - cw, 0) + 1)
        images = images[y0:y0 + ch, x0:x0 + cw]
        if masks is not None:
            masks = masks[y0:y0 + ch, x0:x0 + cw]
    else:
        images = center_crop(images, crop)
        if masks is not None:
            masks = center_crop(masks, crop)
    return images, masks


def polygon_mask(ys: Sequence[float], xs: Sequence[float],
                 shape: Tuple[int, int]) -> np.ndarray:
    """Rasterize a polygon to a float32 {0,1} mask (even-odd scanline fill;
    replaces `skimage.draw.polygon` in the EchoNet trace pipeline) in the
    C++ kernel (`csrc/dataops.cpp::ge_polygon_mask`)."""
    if native.try_load() is None:
        return polygon_mask_plain(ys, xs, shape)
    return native.polygon_mask(ys, xs, shape)


def polygon_mask_plain(ys: Sequence[float], xs: Sequence[float],
                       shape: Tuple[int, int]) -> np.ndarray:
    """`polygon_mask` in numpy, the C++ fill line for line."""
    h, w = shape
    mask = np.zeros((h, w), np.float32)
    ys = np.asarray(ys, np.float64)
    xs = np.asarray(xs, np.float64)
    n = len(ys)
    if n < 3:
        return mask
    for row in range(h):
        y = row + 0.0
        nodes = []
        j = n - 1
        for i in range(n):
            if (ys[i] <= y < ys[j]) or (ys[j] <= y < ys[i]):
                t = (y - ys[i]) / (ys[j] - ys[i])
                # rounded once, as the fused multiply-add GCC makes of this
                # line under -march=native on a CPU with FMA
                nodes.append(float(Fraction(xs[i]) + Fraction(t) * Fraction(xs[j] - xs[i])))
            j = i
        nodes.sort()
        for k in range(0, len(nodes) - 1, 2):
            # clamped to the row as `csrc/dataops.cpp` does (a span left
            # of the image must not become a negative slice end)
            x0 = max(int(np.ceil(nodes[k])), 0)
            x1 = min(int(np.floor(nodes[k + 1])), w - 1)
            if x1 >= x0:
                mask[row, x0:x1 + 1] = 1.0
    return mask
