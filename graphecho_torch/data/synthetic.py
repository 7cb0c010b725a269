"""Synthetic in-memory datasets mimicking the reference datasets' contracts.

Per SURVEY.md §4(c): CAMUS/EchoNet/CardiacUDA-shaped data generated on the fly
so the full train loop runs (and is tested) without real data. Shapes and
return contracts follow `datasets/camus.py:103-105` (`(image, mask,
mask_index, index)`), `datasets/echo.py:284`, `datasets/cardiac_uda.py:155`,
converted to NHWC batch dicts for the train step (a numpy copy of
`graphecho_tpu/data/synthetic.py`; the step transposes to NCHW once at entry).

Images are normalized to [0, 1] like the reference's `/255.0`; masks are
ellipse blobs per foreground channel so the FCOS box sampler finds plausible
geometry.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np


def _ellipse_mask(h: int, w: int, cy: float, cx: float, ry: float, rx: float
                  ) -> np.ndarray:
    ys, xs = np.mgrid[0:h, 0:w]
    return ((((ys - cy) / ry) ** 2 + ((xs - cx) / rx) ** 2) <= 1.0).astype(np.float32)


def synth_image_and_mask(rng: np.random.RandomState, h: int, w: int,
                         n_channels: int, bg_channel: bool = False
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """One grayscale echo-like frame + per-channel masks (NHWC)."""
    img = rng.rand(h, w, 1).astype(np.float32) * 0.3
    masks = np.zeros((h, w, n_channels), np.float32)
    start = 1 if bg_channel else 0
    n_fg = n_channels - start
    fg = np.zeros((h, w), np.float32)
    for idx, c in enumerate(range(start, n_channels)):
        if n_fg == 1:
            cy = rng.uniform(0.3, 0.7) * h
            cx = rng.uniform(0.3, 0.7) * w
            ry = rng.uniform(0.12, 0.3) * h
            rx = rng.uniform(0.12, 0.3) * w
            bright = 0.5 * rng.uniform(0.5, 1.0)
        else:
            # multi-part scenes must be channel-IDENTIFIABLE: each part owns
            # a quadrant and a brightness band. With the earlier exchangeable
            # parts (same center/brightness distribution for every channel)
            # no model can tell which blob belongs to which channel, capping
            # achievable per-channel dice well below 1 — the r4 cardiac_full
            # rehearsal plateaued at ~.6 for exactly this reason. Real
            # CardiacUDA parts (LV/RV/LA/RA) are of course anatomically
            # distinguishable.
            qy, qx = divmod(idx % 4, 2)
            cy = (0.25 + 0.5 * qy + rng.uniform(-0.06, 0.06)) * h
            cx = (0.25 + 0.5 * qx + rng.uniform(-0.06, 0.06)) * w
            ry = rng.uniform(0.10, 0.18) * h
            rx = rng.uniform(0.10, 0.18) * w
            bright = 0.25 + 0.5 * (idx + 1) / n_fg + rng.uniform(-0.04, 0.04)
        m = _ellipse_mask(h, w, cy, cx, ry, rx)
        masks[..., c] = m
        fg = np.maximum(fg, m)
        img[..., 0] += bright * m
    if bg_channel:
        masks[..., 0] = 1.0 - fg
    return np.clip(img, 0, 1), masks


class SyntheticEchoData:
    """Infinite batch iterator matching the train-step batch contract."""

    def __init__(self, cfg, seed: int = 0,
                 batch_size: Optional[int] = None, bg_channel: Optional[bool] = None):
        self.cfg = cfg
        self.rng = np.random.RandomState(seed)
        self.batch_size = batch_size or cfg.data.batch_size
        self.h, self.w = cfg.data.img_crop
        self.n_ch = cfg.model.num_classes
        # cardiac has BG ch.: the recipe's entry point says; else the JAX package's rule
        self.bg_channel = cfg.model.backbone == "VGG16" if bg_channel is None else bg_channel

    def _frames(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        imgs = np.zeros((n, self.h, self.w, 1), np.float32)
        masks = np.zeros((n, self.h, self.w, self.n_ch), np.float32)
        for i in range(n):
            imgs[i], masks[i] = synth_image_and_mask(
                self.rng, self.h, self.w, self.n_ch, self.bg_channel)
        return imgs, masks

    def train_batch(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        b = self.batch_size
        imgs, masks = self._frames(b)
        batch = {"imgs_source": imgs, "masks": masks}
        if cfg.train.graph_matching:
            bt = b * cfg.data.target_batch_mult
            batch["imgs_target"] = self._frames(bt)[0]
        if cfg.train.temporal_graph:
            tl = cfg.tgcn.clip_shape[0]
            bc = max(b // 2, 1)
            clips = np.zeros((2 * bc, tl, self.h, self.w, 1), np.float32)
            cmasks = np.zeros((bc, tl, self.h, self.w, self.n_ch), np.float32)
            for i in range(2 * bc):
                fr, ms = self._frames(tl)
                clips[i] = fr
                if i < bc:
                    cmasks[i] = ms
            batch["temp_imgs_source"] = clips[:bc]
            batch["temp_imgs_target"] = clips[bc:]
            batch["temp_masks"] = cmasks
            # momentum-queue labels must index queue columns: the reference
            # assumes dataset size <= K (`TGCN.py:245-251` CE over 2K logits)
            batch["update_idx_source"] = self.rng.randint(
                0, min(cfg.tgcn.source_class, cfg.tgcn.queue_size),
                bc).astype(np.int32)
            batch["update_idx_target"] = self.rng.randint(
                0, min(cfg.tgcn.target_class, cfg.tgcn.queue_size),
                bc).astype(np.int32)
        if cfg.train.cyc_loss:
            batch["cyc_imgs"] = self._frames(cfg.cycle.clip_length)[0]
        return batch

    def eval_batches(self, n_samples: int, video: bool = False,
                     clip_len: int = 8) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for _ in range(n_samples):
            if video:
                imgs, masks = self._frames(clip_len)
                yield imgs, masks  # already (T, H, W, C) = flattened video
            else:
                imgs, masks = self._frames(1)
                yield imgs, masks
