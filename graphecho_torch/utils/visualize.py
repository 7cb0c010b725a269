"""Host-side drawing for checking the node sampler, port of
`graphecho_tpu/utils/visualize.py`.

Upstream's debug-only drawing (`draw_bounding_boxes` and the `draw_bbox`
helper that saves `graph_matching.png`, `models/graph_matching.py:748-859`)
is never called from the train loop; it lets a person check the mask-to-box
conversion that feeds the FCOS node sampler. Here it is plain numpy on uint8
images. As in the JAX package there is no text rendering: per-box colours
from a fixed palette carry the class, which is all the one upstream call
site uses (`colors="red"`, no labels, `:856`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np

Color = Tuple[int, int, int]

# Fixed, high-contrast palette (cycled) replacing the reference's
# random `_generate_color_palette`.
_PALETTE: Tuple[Color, ...] = (
    (230, 25, 75), (60, 180, 75), (0, 130, 200), (255, 225, 25),
    (245, 130, 48), (145, 30, 180), (70, 240, 240), (240, 50, 230),
)


def _as_rgb(image: np.ndarray) -> np.ndarray:
    """(H, W) | (H, W, 1) | (H, W, 3) uint8 -> (H, W, 3) uint8 copy."""
    if image.dtype != np.uint8:
        raise ValueError(f"uint8 image expected, got {image.dtype}")
    if image.ndim == 2:
        image = image[:, :, None]
    if image.ndim != 3 or image.shape[-1] not in (1, 3):
        raise ValueError(f"(H,W[,1|3]) image expected, got {image.shape}")
    if image.shape[-1] == 1:
        image = np.tile(image, (1, 1, 3))
    return image.copy()


def draw_boxes(image: np.ndarray, boxes: np.ndarray,
               colors: Union[Color, Sequence[Color], None] = None,
               width: int = 1) -> np.ndarray:
    """Draw (x1, y1, x2, y2) box outlines on a uint8 image.

    image: (H, W) grayscale or (H, W, 3) RGB uint8 (NHWC convention — the
    reference's CHW `draw_bounding_boxes` transposed). boxes: (N, 4) float or
    int, absolute pixel coordinates, clipped to the image. colors: one RGB
    tuple for all boxes, a sequence of per-box tuples, or None for the
    default palette cycle. Returns a new (H, W, 3) uint8 array.
    """
    img = _as_rgb(image)
    h, w = img.shape[:2]
    boxes = np.asarray(boxes)
    if boxes.size == 0:
        return img
    if boxes.ndim != 2 or boxes.shape[1] != 4:
        raise ValueError(f"(N, 4) boxes expected, got {boxes.shape}")
    if colors is None:
        per_box = [_PALETTE[i % len(_PALETTE)] for i in range(len(boxes))]
    elif isinstance(colors[0], (int, np.integer)):
        per_box = [tuple(colors)] * len(boxes)  # type: ignore[arg-type]
    else:
        per_box = [tuple(c) for c in colors]  # type: ignore[union-attr]
        if len(per_box) < len(boxes):
            raise ValueError(f"{len(per_box)} colors for {len(boxes)} boxes")

    for (x1, y1, x2, y2), color in zip(boxes, per_box):
        x1i, y1i = max(int(x1), 0), max(int(y1), 0)
        x2i, y2i = min(int(round(x2)), w - 1), min(int(round(y2)), h - 1)
        if x2i < x1i or y2i < y1i:
            continue
        c = np.asarray(color, np.uint8)
        for t in range(width):
            xa, ya = min(x1i + t, w - 1), min(y1i + t, h - 1)
            xb, yb = max(x2i - t, 0), max(y2i - t, 0)
            img[ya, xa:xb + 1] = c
            img[yb, xa:xb + 1] = c
            img[ya:yb + 1, xa] = c
            img[ya:yb + 1, xb] = c
    return img


def render_node_sampling(masks: np.ndarray,
                         image: Optional[np.ndarray] = None,
                         path: Optional[str] = None) -> np.ndarray:
    """Visualize the mask→bbox conversion feeding the FCOS node sampler.

    Analogue of the reference's `draw_bbox` (`graph_matching.py:852-859`):
    computes per-channel boxes with the SAME `masks_to_boxes` the sampler
    uses (`ops/sampling.py`), then draws them — over `image` if given, else
    over the union mask scaled to 255 like upstream's `(mask * 255)`.

    masks: (H, W, C) binary; image: optional (H, W[,3]) uint8 backdrop;
    path: optional PNG output (written via PIL, the reference's backend).
    Returns the (H, W, 3) uint8 render.
    """
    import numpy as onp
    import torch

    from graphecho_torch.ops.sampling import masks_to_boxes

    masks = onp.asarray(masks)
    if masks.ndim != 3:
        raise ValueError(f"(H, W, C) masks expected, got {masks.shape}")
    boxes = masks_to_boxes(torch.from_numpy(masks).permute(2, 0, 1)[None])[0].numpy()  # (C, 4)
    # drop the full-image fallback boxes of empty channels — drawing them
    # would read as a (wrong) detection
    nonempty = masks.reshape(-1, masks.shape[-1]).any(axis=0)
    boxes = boxes[nonempty]
    colors = [_PALETTE[i % len(_PALETTE)]
              for i in range(masks.shape[-1]) if nonempty[i]]
    if image is None:
        image = (masks.any(axis=-1) * 255).astype(onp.uint8)
    out = draw_boxes(image, boxes, colors=colors)
    if path is not None:
        from PIL import Image

        Image.fromarray(out).save(path)
    return out
