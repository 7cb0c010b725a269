"""FPN encoder–decoder segmenter (NCHW), port of `graphecho_tpu/models/fpn.py`.

Reference `models/fpnseg.py:309-444`:

  * backbone (ResNet50-quirk or VGG16) → 5 levels c1..c5;
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
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from graphecho_torch.models.backbones import VGG16, ResNet50, conv2d
from graphecho_torch.ops.resize import resize_bilinear_align_corners, upsample_add

FLAX_GN_EPS = 1e-6


class FPN(nn.Module):
    def __init__(self, num_classes: int = 1, back_bone: str = "resnet",
                 fpn_channels: int = 256, semantic_channels: int = 128,
                 in_channels: int = 1,
                 vgg_spec: Optional[Tuple[Tuple[int, int], ...]] = None):
        super().__init__()
        if back_bone == "resnet":
            self.back_bone = ResNet50(in_channels)
        elif back_bone == "VGG16":
            self.back_bone = VGG16(in_channels, block_spec=vgg_spec)
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
        self.gn1 = nn.GroupNorm(s, s, eps=FLAX_GN_EPS)
        self.gn2 = nn.GroupNorm(c, c, eps=FLAX_GN_EPS)

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

        s3 = up(F.relu(self.gn1(self.semantic_branch(p3))))
        s2 = F.relu(self.gn1(self.semantic_branch(p2)))

        logits = self.conv3(s2 + s3 + s4 + s5)
        logits = resize_bilinear_align_corners(logits, 4 * h, 4 * w)
        return logits, features_map
