"""Convolutional backbones (NCHW) of the reference model, in float32.

VGG16-BN (5 conv blocks, each output kept) and the Bottleneck ResNet with
the reference's [3, 4, 5, 3] stage quirk (GraphEcho `models/fpnseg.py`).
BatchNorm folds the batch mean and the BIASED batch variance into its
running statistics with momentum 0.1, the rule of the system under test.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_VGG16_SPEC = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

Conv2d = nn.Conv2d
Linear = nn.Linear
LayerNorm = nn.LayerNorm
GroupNorm = nn.GroupNorm


class BatchNorm2d(nn.Module):
    """Train mode: batch statistics, running stats moved by the biased
    variance; eval mode: running stats."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


def conv2d(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
           bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding, bias=bias)


class VGG16(nn.Module):
    """5-block VGG16-BN encoder; the 5 post-pool levels at strides 2..32."""

    def __init__(self, in_channels: int = 1,
                 block_spec: Optional[Tuple[Tuple[int, int], ...]] = None):
        super().__init__()
        self.block_spec = tuple(block_spec or _VGG16_SPEC)
        prev = in_channels
        for bi, (width, n_convs) in enumerate(self.block_spec):
            layers: List[nn.Module] = []
            for _ in range(n_convs):
                layers += [conv2d(prev, width, 3, padding=1), BatchNorm2d(width), nn.ReLU()]
                prev = width
            layers.append(nn.MaxPool2d(2, 2))
            setattr(self, f"block_{bi + 1}", nn.Sequential(*layers))

    @property
    def out_channels(self) -> Tuple[int, ...]:
        return tuple(w for w, _ in self.block_spec)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for bi in range(len(self.block_spec)):
            x = getattr(self, f"block_{bi + 1}")(x)
            feats.append(x)
        return feats


class Bottleneck(nn.Module):
    """ResNet bottleneck (expansion 4); every conv pads k//2."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = conv2d(planes, out, 1, bias=False)
        self.bn3 = BatchNorm2d(out)
        self.downsample = (nn.Sequential(conv2d(inplanes, out, 1, stride, bias=False),
                                         BatchNorm2d(out)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """Bottleneck ResNet returning the post-maxpool stem and the 4 stages."""

    def __init__(self, layers: Sequence[int] = (3, 4, 5, 3), in_channels: int = 1):
        super().__init__()
        self.conv1 = conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for si, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if si == 0 else 2
            stage = []
            for bi in range(blocks):
                s = stride if bi == 0 else 1
                down = bi == 0 and (s != 1 or inplanes != planes * 4)
                stage.append(Bottleneck(inplanes, planes, s, down))
                inplanes = planes * 4
            setattr(self, f"layer{si + 1}", nn.Sequential(*stage))

    out_channels = (64, 256, 512, 1024, 2048)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        feats = [x]
        for si in range(4):
            x = getattr(self, f"layer{si + 1}")(x)
            feats.append(x)
        return feats


def ResNet50(in_channels: int = 1) -> ResNet:
    """The reference's `ResNet50`: stage sizes [3, 4, 5, 3]."""
    return ResNet((3, 4, 5, 3), in_channels)
