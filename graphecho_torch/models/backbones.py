"""Convolutional backbones (NCHW), port of `graphecho_tpu/models/backbones.py`.

  * VGG16 — 5 conv blocks with BN+ReLU+MaxPool, returning all 5 block outputs
    (reference `models/fpnseg.py:18-166`);
  * ResNet (Bottleneck) — conv7x7/s2 + maxpool/s2 + 4 stages, returning the
    post-maxpool stem and the 4 stage outputs (`fpnseg.py:177-306`).

Parameter names follow the reference torch modules (`block_{b}.{pos}` for
VGG, torchvision's `conv1`/`layer{i}.{j}.conv1`/`downsample.0` for ResNet), so
a reference state dict loads by name. The reference's `ResNet50` builds stage
sizes [3, 4, 5, 3], not [3, 4, 6, 3] (`fpnseg.py:295`); the quirk is kept.

`dtype` is flax's `dtype`: with `torch.bfloat16` every conv casts its input,
weight and bias to bf16 and returns bf16, and every BatchNorm computes in f32
and returns bf16; the parameters stay f32 (`set_compute_dtype`). None leaves
every op in its input's dtype. `torch.autocast` is not used: its per-op policy
is not flax's.

`BatchNorm2d` computes what flax's BatchNorm in the JAX package computes,
which is not what `torch.nn.BatchNorm2d` computes: the running variance takes
the BIASED batch variance (torch folds in the unbiased one). Momentum 0.1 here
is flax's 0.9.

With `remat`, each VGG block and each Bottleneck runs under
`torch.utils.checkpoint` (the JAX package's per-block `nn.remat`): its
activations are recomputed in the backward instead of kept. The recompute
leaves the BatchNorm running stats alone, so they move once per forward as
under flax's remat.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from graphecho_torch.models.initializers import set_init

_VGG16_SPEC = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
_stats_frozen = False  # set while a checkpointed block is recomputed


@contextlib.contextmanager
def _frozen_running_stats():
    global _stats_frozen
    prev, _stats_frozen = _stats_frozen, True
    try:
        yield
    finally:
        _stats_frozen = prev


def _recompute_contexts():
    return contextlib.nullcontext(), _frozen_running_stats()


def remat(block: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """`block(x)`, its activations recomputed in the backward; the recompute
    does not fold BatchNorm statistics in a second time. Runs `block`
    directly where no gradient is recorded."""
    if not torch.is_grad_enabled():
        return block(x)
    return checkpoint(block, x, use_reentrant=False, context_fn=_recompute_contexts)


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` with flax's `dtype`: input, weight and bias cast to
    `dtype`, which the output keeps."""

    dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return self._conv_forward(x.to(self.dtype), self.weight.to(self.dtype), bias)


class BatchNorm2d(nn.Module):
    """BatchNorm over NCHW with flax's running-statistics update.

    Train mode normalizes with the batch statistics and folds the batch mean
    and the biased batch variance into the running stats, by hand, with
    momentum 0.1 (flax 0.9); eval mode uses the running stats. With a
    `dtype`, the statistics and the affine are computed in f32 and the
    output is cast to `dtype`, as flax's `_normalize` does."""

    dtype: Optional[torch.dtype] = None

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is not None:
            return self._normalize(x.float()).to(self.dtype)
        return self._normalize(x)

    def _normalize(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if not _stats_frozen:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class GroupNorm(nn.GroupNorm):
    """`nn.GroupNorm` with flax's `dtype`: computed in f32, cast to `dtype`."""

    dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return super().forward(x)
        return super().forward(x.float()).to(self.dtype)


def conv2d(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
           bias: bool = True, init="lecun") -> Conv2d:
    return set_init(Conv2d(cin, cout, k, stride, padding, bias=bias), init)


def set_compute_dtype(module: nn.Module, dtype: Optional[torch.dtype]) -> None:
    """Give every conv and norm under `module` the compute `dtype` (None:
    compute in the input's dtype)."""
    for m in module.modules():
        if isinstance(m, (Conv2d, BatchNorm2d, GroupNorm)):
            m.dtype = dtype


class VGG16(nn.Module):
    """5-block VGG16-BN encoder; returns the 5 post-pool levels at strides
    2/4/8/16/32. `block_spec` overrides (width, n_convs) per block."""

    def __init__(self, in_channels: int = 1,
                 block_spec: Optional[Tuple[Tuple[int, int], ...]] = None,
                 remat: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.remat = remat
        self.block_spec = tuple(block_spec or _VGG16_SPEC)
        prev = in_channels
        for bi, (width, n_convs) in enumerate(self.block_spec):
            layers: List[nn.Module] = []
            for _ in range(n_convs):
                # conv / BN / ReLU at positions 3j, 3j+1, 3j+2 (`fpnseg.py:18-145`)
                layers += [conv2d(prev, width, 3, padding=1, init="he"),
                           BatchNorm2d(width), nn.ReLU()]
                prev = width
            layers.append(nn.MaxPool2d(2, 2))
            setattr(self, f"block_{bi + 1}", nn.Sequential(*layers))
        set_compute_dtype(self, dtype)

    @property
    def out_channels(self) -> Tuple[int, ...]:
        return tuple(w for w, _ in self.block_spec)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for bi in range(len(self.block_spec)):
            block = getattr(self, f"block_{bi + 1}")
            x = remat(block, x) if self.remat else block(x)
            feats.append(x)
        return feats


class Bottleneck(nn.Module):
    """ResNet bottleneck (expansion 4), `fpnseg.py:177-212`. Every conv pads
    k//2 on each side, as the reference's `padding=1` does at stride 2."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = conv2d(inplanes, planes, 1, bias=False, init="he")
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = conv2d(planes, planes, 3, stride, 1, bias=False, init="he")
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = conv2d(planes, out, 1, bias=False, init="he")
        self.bn3 = BatchNorm2d(out)
        self.downsample = (nn.Sequential(
            conv2d(inplanes, out, 1, stride, bias=False, init="he"),
            BatchNorm2d(out)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """Bottleneck ResNet returning 5 levels: the post-maxpool stem (stride 4)
    and the 4 stage outputs (strides 4/8/16/32), `fpnseg.py:251-266`."""

    def __init__(self, layers: Sequence[int] = (3, 4, 5, 3), in_channels: int = 1,
                 remat: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.remat = remat
        self.conv1 = conv2d(in_channels, 64, 7, 2, 3, bias=False, init="he")
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
        set_compute_dtype(self, dtype)

    out_channels = (64, 256, 512, 1024, 2048)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x)))
        # 3x3/s2 max-pool over a -inf border of 1 (`backbones.py:142-143`):
        # max_pool2d pads with -inf itself
        x = F.max_pool2d(x, 3, 2, padding=1)
        feats = [x]
        for si in range(4):
            for block in getattr(self, f"layer{si + 1}"):
                x = remat(block, x) if self.remat else block(x)
            feats.append(x)
        return feats


def ResNet50(in_channels: int = 1, remat: bool = False,
             dtype: Optional[torch.dtype] = None) -> ResNet:
    """Reference `ResNet50` quirk: stage sizes [3,4,5,3] (`fpnseg.py:295`)."""
    return ResNet((3, 4, 5, 3), in_channels, remat, dtype)


def ResNet101(in_channels: int = 1, remat: bool = False,
              dtype: Optional[torch.dtype] = None) -> ResNet:
    return ResNet((3, 4, 23, 3), in_channels, remat, dtype)
