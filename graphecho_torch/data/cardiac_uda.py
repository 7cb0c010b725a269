"""CardiacUDA dataset (.nii.gz multi-view echo, Site_G / Site_R), port of
`graphecho_tpu/data/cardiac_uda.py`.

Re-implements the reference `Seg_Cardiac_UDA_Dataset`
(`datasets/cardiac_uda.py:38-286`):
  * site selection from the `infos` dict (pid -> {'dataset_name',
    'views_images', 'views_labels'}, `get_dict` `:179-189`);
  * 90/10 train split + 10% valid subsample + held-out test via python
    `random.sample` (`:59-66`);
  * single-frame mode: random frame whose mask area > 100 (`input_select`
    `:191-221`); clip mode: `clip_length` frames at a stride derived from
    `total_length` (`:99-113`);
  * per-view organ channel splits with explicit BG channel (`:128-151`);
  * `fill_mask`: contour labels -> filled masks (`contour_to_mask` `:223-246`)
    — reproduced bug-compatibly (a polygon fill over the raw argwhere points
    with transposed write-back) so the video-test metrics stay comparable.
    The fill is `fill_poly`, a numpy transcription of OpenCV's `cv2.fillPoly`
    (which the reference and the JAX package call), so the port needs no cv2;
  * nearest resize `spatial_size` + random/center crop `crop_size`;
  * returns channel-LAST arrays: (H, W, 1) or (T, H, W, 1) images in [0, 1],
    (H, W, P) or (T, H, W, P) masks.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from graphecho_torch.data.formats import read_nifti
from graphecho_torch.data.transforms import nearest_resize, resize_and_crop

ORGAN_NUM = {"1": 2, "2": 1, "3": 2, "4": 4}

# OpenCV's fixed point for polygon edges (`XY_SHIFT` in imgproc/drawing.cpp)
XY_SHIFT = 16


def _trunc_div(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """int64 division truncating toward zero, as C's `/` does."""
    q = np.abs(a) // np.abs(b)
    return np.where((a < 0) != (b < 0), -q, q)


def _clip_lines(w: int, h: int, x1, y1, x2, y2):
    """OpenCV's `clipLine` on arrays of segments: Cohen-Sutherland against
    the (w, h) image, each step computed in double and truncated to int64,
    the second end's step from the first end's clipped point. Returns
    (inside, x1, y1, x2, y2); segments wholly outside keep partly moved
    ends, as OpenCV leaves them."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    def step(num, d_other, den, sel):
        # trunc(double(num) * d_other / den) where sel, else 0
        den = np.where(sel, den, 1).astype(np.float64)
        return np.where(sel, np.trunc(num.astype(np.float64) * d_other / den), 0).astype(np.int64)

    x1, y1, x2, y2 = (np.asarray(v, np.int64).copy() for v in (x1, y1, x2, y2))
    c1, c2 = code(x1, y1), code(x2, y2)
    go = ((c1 & c2) == 0) & ((c1 | c2) != 0)
    sel = go & ((c1 & 12) != 0)
    a = np.where(c1 < 8, 0, bottom)
    x1 = x1 + step(a - y1, x2 - x1, y2 - y1, sel)
    y1 = np.where(sel, a, y1)
    c1 = np.where(sel, (x1 < 0) + (x1 > right) * 2, c1)
    sel = go & ((c2 & 12) != 0)
    a = np.where(c2 < 8, 0, bottom)
    x2 = x2 + step(a - y2, x2 - x1, y2 - y1, sel)
    y2 = np.where(sel, a, y2)
    c2 = np.where(sel, (x2 < 0) + (x2 > right) * 2, c2)
    go = go & ((c1 & c2) == 0) & ((c1 | c2) != 0)
    sel = go & (c1 != 0)
    a = np.where(c1 == 1, 0, right)
    y1 = y1 + step(a - x1, y2 - y1, x2 - x1, sel)
    x1 = np.where(sel, a, x1)
    c1 = np.where(sel, 0, c1)
    sel = go & (c2 != 0)
    a = np.where(c2 == 1, 0, right)
    y2 = y2 + step(a - x2, y2 - y1, x2 - x1, sel)
    x2 = np.where(sel, a, x2)
    c2 = np.where(sel, 0, c2)
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line_pixels(x1, y1, x2, y2):
    """The pixels of 8-connected lines drawn left to right, OpenCV's
    `LineIterator`: the major axis steps every pixel and the minor one when
    the Bresenham error goes negative, which after i steps has moved it
    ceil((2*minor*i - major) / (2*major)) pixels. Returns (xs, ys)."""
    swap = x2 < x1
    x1, y1, x2, y2 = (np.where(swap, b, a) for a, b in ((x1, x2), (y1, y2), (x2, x1), (y2, y1)))
    dx, dy = x2 - x1, y2 - y1
    sy = np.where(dy < 0, -1, 1)
    steep = np.abs(dy) > dx
    major = np.where(steep, np.abs(dy), dx)
    minor = np.where(steep, dx, np.abs(dy))
    n = major + 1
    line = np.repeat(np.arange(len(n)), n)
    i = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    maj, mnr = major[line], minor[line]
    m = -((maj - 2 * mnr * i) // np.maximum(2 * maj, 1))
    st = steep[line]
    xs = x1[line] + np.where(st, m, i)
    ys = y1[line] + sy[line] * np.where(st, i, m)
    return xs, ys


def fill_poly(points: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """`cv2.fillPoly(img, [points], 255)` on a zero (h, w) image, as a bool
    mask, in numpy: one polygon of integer (x, y) points, 8-connected edges,
    no shift. A transcription of OpenCV's `CollectPolyEdges` and
    `FillEdgeCollection` (imgproc/drawing.cpp):

      * every edge is drawn as a line (`_line_pixels`), clipped to the image
        first (`_clip_lines`);
      * a non-horizontal edge enters the scanline table with 16.16
        fixed-point x and a slope truncated to an integer; an edge that left
        the image takes its clipped ends' x (and their y, when those differ),
        and its x at the first row is stepped from there;
      * an edge is active on rows y0 <= y < y1; on each row the active x's,
        sorted, pair up into spans from ceil(x_left) to floor(x_right),
        clipped to the image.

    The scanline walk is vectorised: an edge's x on row y is its start plus
    (y - y0) slopes, which is what OpenCV's running sum gives, since a closed
    polygon puts an even number of edges on every row."""
    h, w = shape
    out = np.zeros((h, w), bool)
    pts = np.asarray(points, np.int64).reshape(-1, 2)
    if len(pts) == 0:
        return out
    p1x, p1y = pts[:, 0], pts[:, 1]
    p0x, p0y = np.roll(p1x, 1), np.roll(p1y, 1)  # edge k runs from point k-1 to k
    outside = ((p0x < 0) | (p0x >= w) | (p1x < 0) | (p1x >= w)
               | (p0y < 0) | (p0y >= h) | (p1y < 0) | (p1y >= h))
    inside, t0x, t0y, t1x, t1y = _clip_lines(w, h, p0x, p0y, p1x, p1y)
    drawn = inside | ~outside
    xs, ys = _line_pixels(t0x[drawn], t0y[drawn], t1x[drawn], t1y[drawn])
    out[ys, xs] = True

    # the scanline table: clipped edges take the clipped ends
    moved_y = outside & (t0y != t1y)
    c0y, c1y = np.where(moved_y, t0y, p0y), np.where(moved_y, t1y, p1y)
    c0x = np.where(outside, t0x, p0x) << XY_SHIFT
    c1x = np.where(outside, t1x, p1x) << XY_SHIFT
    edge = p0y != p1y
    if edge.sum() < 2:
        return out
    c0x, c0y, c1x, c1y, p0y, p1y = (v[edge] for v in (c0x, c0y, c1x, c1y, p0y, p1y))
    dx = _trunc_div(c1x - c0x, c1y - c0y)
    down = p0y < p1y
    y0, y1 = np.minimum(p0y, p1y), np.maximum(p0y, p1y)
    x0 = np.where(down, c0x + (y0 - c0y) * dx, c1x + (y0 - c1y) * dx)
    x_end = x0 + (y1 - y0) * dx
    if (y1.max() < 0 or y0.min() >= h or max(x0.max(), x_end.max()) < 0
            or min(x0.min(), x_end.min()) >= (w << XY_SHIFT)):
        return out
    r0, r1 = np.maximum(y0, 0), np.minimum(y1, h)
    n = np.maximum(r1 - r0, 0)
    e = np.repeat(np.arange(len(n)), n)
    rows = r0[e] + np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    xr = x0[e] + (rows - y0[e]) * dx[e]
    order = np.lexsort((xr, rows))
    rows, xr = rows[order], xr[order]
    row, xa, xb = rows[0::2], xr[0::2], xr[1::2]
    x1 = (xa + (1 << XY_SHIFT) - 1) >> XY_SHIFT  # ceil
    x2 = xb >> XY_SHIFT  # floor
    keep = (x1 < w) & (x2 >= 0)
    row, x1, x2 = row[keep], np.maximum(x1[keep], 0), np.minimum(x2[keep], w - 1)
    keep = x1 <= x2
    # spans as +1/-1 marks, summed along each row
    marks = np.zeros((h, w + 1), np.int64)
    np.add.at(marks, (row[keep], x1[keep]), 1)
    np.add.at(marks, (row[keep], x2[keep] + 1), -1)
    out |= np.cumsum(marks, axis=1)[:, :w] > 0
    return out


class SegCardiacUDADataset:
    def __init__(self, infos: Dict, root: str, is_train: bool, repeat: int = 1,
                 data_list: Optional[List[str]] = None,
                 set_select: Tuple[str, ...] = ("Site_G",),
                 view_num: Tuple[str, ...] = ("2",), spatial_size: int = 328,
                 crop_size: int = 256, single_frame: bool = True,
                 total_length: int = 40, clip_length: int = 8,
                 seg_parts: bool = True, source_domain: bool = True,
                 fill_mask: bool = False, seed: Optional[int] = 7777):
        self.root = root
        self.is_train = is_train
        self.set_select = list(set_select)
        self.view_num = list(view_num)
        self.spatial_size = spatial_size
        self.crop_size = crop_size
        self.single_frame = single_frame
        self.total_length = total_length
        self.clip_length = clip_length
        self.seg_parts = seg_parts
        self.source_domain = source_domain
        self.fill_mask = fill_mask
        self.repeat = repeat
        # default seed mirrors the reference's module-level random.seed(7777)
        # (`datasets/cardiac_uda.py:35-36`): the 90/10 split below MUST be
        # identical across dataset instances (src/temporal/cyc loaders) and
        # across restarts/hosts, or held-out test videos leak into training
        self._py_rng = random.Random(seed)
        self._rng = np.random.RandomState(seed)

        self.data_dict = {
            k: {"images": v["views_images"], "masks": v["views_labels"]}
            for k, v in infos.items() if v["dataset_name"] in self.set_select
        }
        self.id_list = list(self.data_dict.keys())

        if is_train:
            self.train_list = self._py_rng.sample(
                self.id_list, int(len(self.id_list) * 0.9))
            self.valid_list = self._py_rng.sample(
                self.train_list, max(int(len(self.train_list) * 0.1), 0))
            self.test_list = list(set(self.id_list) - set(self.train_list))
            self.id_list = self.train_list
        elif data_list is not None:
            self.id_list = data_list
        self.num_data = len(self.id_list)

    def __len__(self) -> int:
        return self.num_data * self.repeat if self.is_train else self.num_data

    # ------------------------------------------------------------- selection
    def _input_select(self, images: np.ndarray, masks: np.ndarray):
        """Pick a frame/clip with enough mask area (`input_select` `:191-221`).
        images/masks arrive (H, W, T) from the NIfTI (x, y, t) layout."""
        if masks.ndim == 3:
            area = np.sum(masks, axis=(0, 1))
            candidates = np.argwhere(np.where(area > 100, 1, 0) == 1)
            if candidates.size == 0:
                return None, None, None
            select_index = int(self._py_rng.choice(list(candidates[:, 0])))
            if self.single_frame:
                return (images[:, :, select_index], masks[:, :, select_index],
                        select_index)
            r_index = self._py_rng.randint(
                0, select_index if select_index < self.clip_length - 1
                else self.clip_length - 1)
            t = images.shape[-1]
            if t < self.clip_length:
                return None, None, None
            # clamp so the window never runs past the video tail (a short
            # clip would break the collate of fixed-shape batches)
            start = min(select_index - r_index, t - self.clip_length)
            end = start + self.clip_length  # full clip_length frames
            return images[:, :, start:end], masks[:, :, start:end], r_index
        if self.single_frame:
            return images, masks, 0
        tiled = np.tile(images[..., None], (1, 1, self.clip_length))
        tiled_m = np.tile(masks[..., None], (1, 1, self.clip_length))
        return tiled, tiled_m, 0

    def _clip_select(self, images: np.ndarray, masks: np.ndarray):
        """Clip sampling at derived stride (`:99-113`). Deviation: the
        reference slices `[start : start+clip_length : rate]`, yielding only
        clip_length/rate frames; we slice the intended full window so clips
        really have `clip_length` frames."""
        video_length = images.shape[-1]
        sample_rate = max(int(self.total_length / self.clip_length), 1)
        if video_length < self.clip_length:
            return None, None, None
        if video_length < self.clip_length * sample_rate:
            sample_rate = max(video_length // self.clip_length, 1)
        start = self._py_rng.randint(
            0, max(video_length - self.clip_length * sample_rate, 0))
        end = start + self.clip_length * sample_rate
        sel_i = images[:, :, start:end:sample_rate]
        sel_m = masks[:, :, start:end:sample_rate]
        mask_index = np.where(np.sum(sel_m, axis=(0, 1)) > 100, 1, 0)
        if self.fill_mask:
            sel_m = self.contour_to_mask(sel_m)
        return sel_i, sel_m, mask_index

    # ------------------------------------------------------------ mask utils
    def contour_to_mask(self, contours: np.ndarray) -> np.ndarray:
        """Bug-compatible `contour_to_mask` (`:223-246`): `fill_poly` over raw
        argwhere point lists, written back with swapped indices."""
        h, w, t = contours.shape
        all_cls = sorted(set(contours.reshape(-1).tolist()) - {0})
        out = np.zeros_like(contours, dtype=np.float64)
        n_organs = ORGAN_NUM[self.view_num[0]]
        for i in range(t):
            contour = contours[:, :, i]
            mask = np.zeros((h, w))
            for cls in range(1, n_organs + 1):
                if cls > len(all_cls):
                    break
                pts = np.argwhere(contour == all_cls[cls - 1])
                if len(pts) == 0:
                    continue
                # (row, col) points read as (x, y): the reference's transpose
                rows, cols = np.nonzero(fill_poly(pts, (h, w)))
                mask[cols, rows] = cls  # reference's transposed write
            out[:, :, i] = mask
        return out

    def _split_channels(self, masks: np.ndarray) -> np.ndarray:
        """Per-view BG+organ channel split (`:128-151`). masks: (...,) label
        map -> (..., P) float channels, BG first."""
        view = self.view_num[0]
        organs = ORGAN_NUM[view]
        if not self.seg_parts:
            return (masks > 0).astype(np.float32)[..., None]
        chans = [(masks == 0).astype(np.float32)]
        for c in range(1, organs + 1):
            chans.append((masks == c).astype(np.float32))
        return np.stack(chans, axis=-1)

    # ----------------------------------------------------------------- items
    def __getitem__(self, index: int):
        index = (index // self.repeat) % max(self.num_data, 1)
        for _attempt in range(max(self.num_data, 1)):
            pid = self.id_list[index]
            view = self.view_num[0]
            entry = self.data_dict[pid]
            img_path = entry["images"].get(view)
            mask_path = entry["masks"].get(view)
            if img_path is None or mask_path is None:
                index = self._py_rng.randint(0, self.num_data - 1)
                continue
            images = read_nifti(img_path).astype(np.float32)  # (H, W[, T])
            masks = read_nifti(mask_path).astype(np.float32)
            if self.single_frame:
                sel_i, sel_m, mask_index = self._input_select(images, masks)
            else:
                if images.ndim == 3:
                    sel_i, sel_m, mask_index = self._clip_select(images, masks)
                else:
                    sel_i, sel_m, mask_index = self._input_select(images, masks)
            if sel_i is None or (self.single_frame and np.sum(sel_m) < 100):
                index = self._py_rng.randint(0, self.num_data - 1)
                continue
            break
        else:
            raise RuntimeError("no usable sample found")

        mask_ch = self._split_channels(sel_m)

        if self.single_frame:
            img = sel_i[..., None]  # (H, W, 1)
            img, mask_ch = resize_and_crop(
                img, mask_ch, (self.spatial_size, self.spatial_size),
                (self.crop_size, self.crop_size), self.is_train, self._rng)
            return img / 255.0, mask_ch, mask_index, index

        # clip mode: (H, W, T) -> per-frame resize/crop -> (T, H, W, C)
        t = sel_i.shape[-1]
        img = nearest_resize(sel_i, (self.spatial_size, self.spatial_size))
        mk = nearest_resize(mask_ch, (self.spatial_size, self.spatial_size))
        if self.is_train:
            h, w = img.shape[:2]
            y0 = self._rng.randint(0, max(h - self.crop_size, 0) + 1)
            x0 = self._rng.randint(0, max(w - self.crop_size, 0) + 1)
        else:
            y0 = max((img.shape[0] - self.crop_size) // 2, 0)
            x0 = max((img.shape[1] - self.crop_size) // 2, 0)
        img = img[y0:y0 + self.crop_size, x0:x0 + self.crop_size]
        mk = mk[y0:y0 + self.crop_size, x0:x0 + self.crop_size]
        img = np.transpose(img, (2, 0, 1))[..., None]  # (T, H, W, 1)
        mk = np.transpose(mk, (2, 0, 1, 3))  # (T, H, W, P)
        return img / 255.0, mk, mask_index, index
