"""FPN encoder–decoder segmenter (NCHW), port of `graphecho_tpu/models/fpn.py`.

Reference `models/fpnseg.py:309-444`:

  * backbone (ResNet50-quirk, VGG16 or Pyramid ViG-S) → 5 levels c1..c5;
  * top-down pyramid: `toplayer` 1x1 on c5, three lateral 1x1 convs merged with
    align-corners bilinear `upsample_add`;
  * `features_map = [p2, p3, p4, p5]` taken BEFORE the smooth convs
    (`fpnseg.py:415-418`); these taps feed the GModule and discriminators;
  * 3x3 smooth convs on p4/p3/p2;
  * semantic branch with SHARED convs: `conv2` is applied twice on the p5
    path and once on p4; `semantic_branch` on all four paths; the GroupNorms
    gn2 / gn1 (one group per channel) are shared likewise;
  * head: 1x1 conv to classes, then a 4x align-corners upsample.

gn1/gn2 use eps 1e-6: the JAX package leaves flax's default there
(`fpn.py:72-75`); torch's and the reference's default is 1e-5.

`back_bone="pvig_s"` is the Pyramid ViG-S of `models/vig.py` at its
published widths (`pvig_s_224_gelu`, no stochastic graph, no drop-path), its
position embedding sized for `img_size` frames; it has no remat. Its c1 is
the stem's map, unused as the other backbones' c1 is.

`dtype=torch.bfloat16` is the JAX FPN's `dtype=jnp.bfloat16` with f32
parameters: convs compute in bf16, the BatchNorms and GroupNorms in f32 with
a bf16 output, the resizes and adds in bf16, and the logits are bf16
(`models/backbones.py::set_compute_dtype`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from graphecho_torch.models.backbones import VGG16, GroupNorm, ResNet50, conv2d, set_compute_dtype
from graphecho_torch.models.vig import PVIG_S, PyramidViG
from graphecho_torch.ops.resize import resize_bilinear_align_corners, upsample_add

FLAX_GN_EPS = 1e-6


class FPN(nn.Module):
    def __init__(self, num_classes: int = 1, back_bone: str = "resnet",
                 fpn_channels: int = 256, semantic_channels: int = 128,
                 in_channels: int = 1,
                 vgg_spec: Optional[Tuple[Tuple[int, int], ...]] = None,
                 remat: bool = False, dtype: Optional[torch.dtype] = None,
                 img_size: int = 256):
        super().__init__()
        self.dtype = dtype
        if back_bone == "resnet":
            self.back_bone = ResNet50(in_channels, remat=remat, dtype=dtype)
        elif back_bone == "VGG16":
            self.back_bone = VGG16(in_channels, block_spec=vgg_spec, remat=remat, dtype=dtype)
        elif back_bone == "pvig_s":
            if remat:
                raise ValueError("remat: the Pyramid ViG backbone has none")
            self.back_bone = PyramidViG(**PVIG_S, img_size=img_size, in_channels=in_channels)
        else:
            raise ValueError(f"unknown backbone {back_bone!r}")
        _, c2, c3, c4, c5 = self.back_bone.out_channels
        c, s = fpn_channels, semantic_channels
        self.toplayer = conv2d(c5, c, 1)
        self.latlayer1 = conv2d(c4, c, 1)
        self.latlayer2 = conv2d(c3, c, 1)
        self.latlayer3 = conv2d(c2, c, 1)
        self.smooth1 = conv2d(c, c, 3, padding=1)
        self.smooth2 = conv2d(c, c, 3, padding=1)
        self.smooth3 = conv2d(c, c, 3, padding=1)
        self.conv2 = conv2d(c, c, 3, padding=1)
        self.semantic_branch = conv2d(c, s, 3, padding=1)
        self.conv3 = conv2d(s, num_classes, 1)
        self.gn1 = GroupNorm(s, s, eps=FLAX_GN_EPS)
        self.gn2 = GroupNorm(c, c, eps=FLAX_GN_EPS)
        set_compute_dtype(self, dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x: (B, C_in, H, W). Returns (logits (B, num_classes, H, W),
        [p2, p3, p4, p5] pre-smooth features)."""
        return self.head(self.back_bone(x))

    def head(self, feats: List[torch.Tensor]) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """Pyramid + semantic head on backbone features [c1..c5], callable on
        its own (the int8 path of a later slice runs its own backbone)."""
        _, c2, c3, c4, c5 = feats
        p5 = self.toplayer(c5)
        p4 = upsample_add(p5, self.latlayer1(c4))
        p3 = upsample_add(p4, self.latlayer2(c3))
        p2 = upsample_add(p3, self.latlayer3(c2))
        features_map = [p2, p3, p4, p5]

        p4 = self.smooth1(p4)
        p3 = self.smooth2(p3)
        p2 = self.smooth3(p2)

        h, w = p2.shape[-2:]

        def up(t):
            return resize_bilinear_align_corners(t, h, w)

        s5 = up(F.relu(self.gn2(self.conv2(p5))))
        s5 = up(F.relu(self.gn2(self.conv2(s5))))
        s5 = up(F.relu(self.gn1(self.semantic_branch(s5))))

        s4 = up(F.relu(self.gn2(self.conv2(p4))))
        s4 = up(F.relu(self.gn1(self.semantic_branch(s4))))

        s2 = F.relu(self.gn1(self.semantic_branch(p2)))
        # s2 + s3 in one pass: the resize of s3 with s2 as its addend
        s23 = upsample_add(F.relu(self.gn1(self.semantic_branch(p3))), s2)

        logits = self.conv3(s23 + s4 + s5)
        logits = resize_bilinear_align_corners(logits, 4 * h, 4 * w)
        return logits, features_map


class FPNHead(nn.Module):
    """The FPN's pyramid and semantic head without its backbone, sharing the
    FPN's modules: what the int8 backbone's features go through
    (`quant/ptq.py`), as `fpn.apply(..., method=FPN.head)` in the JAX package."""

    def __init__(self, fpn: FPN):
        super().__init__()
        for name, child in fpn.named_children():
            if name != "back_bone":
                self.add_module(name, child)

    forward = FPN.head


def masks_nhwc(logits: torch.Tensor, threshold: float) -> torch.Tensor:
    """σ(logits) > threshold, computed in the logits' own dtype as the JAX
    package does (in bf16 that is not logits > 0), as (B, H, W, C) int8."""
    return (torch.sigmoid(logits) > threshold).to(torch.int8).permute(0, 2, 3, 1)


class FPNMasks(nn.Module):
    """(B, H, W, C_in) float frames -> (B, H, W, classes) int8 masks through
    the float FPN: the inference function a Predictor serves and exports."""

    def __init__(self, fpn: FPN, threshold: float = 0.5):
        super().__init__()
        self.fpn = fpn
        self.threshold = threshold

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        logits, _ = self.fpn(x.permute(0, 3, 1, 2))
        return masks_nhwc(logits, self.threshold)
