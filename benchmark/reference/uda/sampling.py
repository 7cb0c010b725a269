"""Static-shape FCOS-style node sampling, in float32 (a frozen copy of the system's math).

Reference `PrototypeComputation` (`models/graph_matching.py:861-1065`) with
its helpers `compute_locations` (`:609-635`) and `masks_to_boxes`
(`:702-746`). As in the JAX package, every level contributes a FIXED budget
of background and positive node slots plus a validity mask, so node selection
matches it slot for slot:

  * positives: up to `pos_budget_per_level` evenly spaced positives in flat
    (B·H·W) order;
  * background: `taken_pos // bg_ratio` linspace-spaced negatives.

Feature maps are NCHW; flat order is the JAX package's NHWC (b, y, x) order.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from benchmark.reference.uda.config import NodeSamplerConfig

INF = 1e8


class NodeSet(NamedTuple):
    """A fixed-size set of sampled nodes with validity mask."""

    points: torch.Tensor  # (N, C) node features
    labels: torch.Tensor  # (N,) int64 class labels (0 = background)
    weights: torch.Tensor  # (N,) float loss weights
    valid: torch.Tensor  # (N,) bool


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """masks (B, C, H, W) -> boxes (B, C, 4) as (x1, y1, x2, y2). A channel
    with no foreground gives the full-image box [0, 0, W, H] (the reference's
    empty-mask fallback, `graph_matching.py:728-733`)."""
    b, c, h, w = masks.shape
    nz = masks != 0
    any_x = nz.any(dim=2)  # (B, C, W) column has fg
    any_y = nz.any(dim=3)  # (B, C, H) row has fg
    xs = torch.arange(w, dtype=torch.float32, device=masks.device)
    ys = torch.arange(h, dtype=torch.float32, device=masks.device)
    x1 = torch.where(any_x, xs, INF).amin(dim=-1)
    x2 = torch.where(any_x, xs, -INF).amax(dim=-1)
    y1 = torch.where(any_y, ys, INF).amin(dim=-1)
    y2 = torch.where(any_y, ys, -INF).amax(dim=-1)
    empty = ~any_x.any(dim=-1)
    x1 = torch.where(empty, 0.0, x1)
    y1 = torch.where(empty, 0.0, y1)
    x2 = torch.where(empty, float(w), x2)
    y2 = torch.where(empty, float(h), y2)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def compute_locations(shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
                      device=None) -> List[torch.Tensor]:
    """Per-level (H*W, 2) grids of (x, y) = index*stride + stride//2
    (`graph_matching.py:621-635`), with the reference's stride table even
    where the FPN's real strides differ (reference quirk)."""
    out = []
    for (h, w), s in zip(shapes, strides):
        sx = torch.arange(w, dtype=torch.float32, device=device) * s + s // 2
        sy = torch.arange(h, dtype=torch.float32, device=device) * s + s // 2
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        out.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=1))
    return out


def fcos_labels(locations: torch.Tensor, boxes: torch.Tensor,
                soi: Tuple[float, float]) -> torch.Tensor:
    """FCOS assignment of one level's locations (HW, 2) to per-image boxes
    (B, K, 4): (B, HW) labels = index of the min-area containing box whose
    largest regression distance lies in the size-of-interest range, else 0
    (`graph_matching.py:913-959`)."""
    xs = locations[:, 0][None, :, None]
    ys = locations[:, 1][None, :, None]
    x1 = boxes[:, None, :, 0]
    y1 = boxes[:, None, :, 1]
    x2 = boxes[:, None, :, 2]
    y2 = boxes[:, None, :, 3]
    reg = torch.stack([xs - x1, ys - y1, x2 - xs, y2 - ys], dim=-1)  # (B, HW, K, 4)
    in_box = reg.amin(dim=-1) > 0
    max_reg = reg.amax(dim=-1)
    cared = (max_reg >= soi[0]) & (max_reg <= soi[1])
    area = ((y2 - y1) * (x2 - x1)).expand(in_box.shape)
    area = torch.where(in_box & cared, area, INF)
    min_area, label = area.min(dim=-1)
    return torch.where(min_area >= INF, 0, label)


def _evenly_spaced_select(mask_flat: torch.Tensor, budget: int,
                          count_override: Optional[torch.Tensor] = None,
                          linspace_mode: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to `budget` evenly spaced True positions of `mask_flat`, in flat
    order. Returns (indices (budget,), valid (budget,)).

    linspace_mode=False: ranks k*n // budget (stride subsample);
    linspace_mode=True: ranks floor(k*(n-2) / (count-1)) (the reference's
    np.linspace background sampling, `graph_matching.py:1001`).
    `count_override` caps the number of valid slots."""
    n_total = mask_flat.shape[0]
    counts = torch.cumsum(mask_flat.to(torch.int64), 0)
    n = counts[-1]
    k = torch.arange(budget, device=mask_flat.device)
    count = n.clamp(max=budget)
    if count_override is not None:
        count = torch.minimum(count, count_override)
    if linspace_mode:
        denom = (count - 1).clamp_min(1)
        # float32, as the JAX package divides (exact for these magnitudes)
        ranks = torch.floor(k.float() * (n - 2).clamp_min(0).float()
                            / denom.float()).long()
    else:
        ranks = torch.where(n > budget, (k * n) // budget, k)
    ranks = torch.minimum(ranks.clamp_min(0), (n - 1).clamp_min(0))
    # the (rank+1)-th True sits where the cumsum first reaches rank+1
    idx = torch.searchsorted(counts, ranks + 1, side="left")
    idx = idx.clamp(max=n_total - 1)
    return idx, k < count


def sample_nodes(features: Sequence[torch.Tensor], boxes: torch.Tensor,
                 cfg: NodeSamplerConfig) -> NodeSet:
    """Sample a fixed-budget node set from NCHW feature maps (the pre-smooth
    p2..p5) given per-image boxes (B, K, 4). N = n_levels·(pos + bg budget)."""
    P = cfg.pos_budget_per_level
    NB = cfg.bg_budget_per_level
    shapes = [tuple(f.shape[-2:]) for f in features]
    locations = compute_locations(shapes, cfg.fpn_strides, boxes.device)

    pts, labs, vals = [], [], []
    for lvl, (feat, locs) in enumerate(zip(features, locations)):
        b, c, h, w = feat.shape
        labels = fcos_labels(locs, boxes, cfg.sizes_of_interest[lvl])
        flat_feat = feat.permute(0, 2, 3, 1).reshape(b * h * w, c)
        flat_lab = labels.reshape(-1)

        pos_idx, pos_valid = _evenly_spaced_select(flat_lab > 0, P)
        n_pos_taken = pos_valid.sum()
        bg_idx, bg_valid = _evenly_spaced_select(
            flat_lab == 0, NB, count_override=n_pos_taken // cfg.bg_ratio,
            linspace_mode=True)

        # background first, then positives — reference concat order (`:1010`)
        idx = torch.cat([bg_idx, pos_idx])
        vals.append(torch.cat([bg_valid, pos_valid]))
        labs.append(torch.cat([torch.zeros_like(bg_idx), flat_lab[pos_idx] * pos_valid]))
        pts.append(flat_feat[idx])

    points = torch.cat(pts)
    labels = torch.cat(labs)
    valid = torch.cat(vals)
    points = points * valid[:, None]
    return NodeSet(points=points, labels=labels, weights=valid.float(), valid=valid)
