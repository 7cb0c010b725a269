"""ViG (Vision GNN) graph convolutions and the standalone DeepGCN classifier,
port of `graphecho_tpu/models/vig.py` (reference `models/vig.py`, credited to
ViG / Efficient-AI-Backbones).

Layout: feature maps are NCHW. A map becomes a node set by flattening (H, W)
row-major, as the JAX package's `reshape(b, -1, c)` of NHWC does, so a node
index (and with it the relative-position bias) means the same in both. The
kNN graph and the neighbour gather take nodes as (B, N, C), the JAX layout;
the grouped 1x1 convs (`BasicConv`) run channel-first on (B, C, N).

Module attribute names are the flax names (`stem.conv1`,
`grapher_0.graph_conv.gc.gconv.nn.conv_0`, `ffn_3.bn2`, `pred_conv1`, ...),
so `graphecho_torch.convert.vig_state_dict` maps a flax tree by walking it.

As in the JAX package (and unlike upstream's exact `nn.GELU()`), "gelu" is
the tanh approximation, flax's `nn.gelu` default. BatchNorm is the port's
flax-rule `BatchNorm2d` (biased running variance, momentum 0.1 = flax 0.9).
Train mode is `module.train()`; drop-path, the head's dropout and the
stochastic graph draw from the `torch.Generator` passed to `forward`.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from graphecho_torch.device import resolve_device
from graphecho_torch.models.attention import dropout
from graphecho_torch.models.backbones import BatchNorm2d, conv2d
from graphecho_torch.models.initializers import initialize, set_init
from graphecho_torch.ops.knn import dilated_knn_graph, gather_neighbors


# ------------------------------------------------------------ pos embeddings
def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """(grid_size², embed_dim) sin-cos embedding (`vig.py:38-85`)."""
    def _1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64)
        omega = 1.0 / 10000 ** (omega / (dim / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(grid_w, grid_h), axis=0)
    emb_h = _1d(embed_dim // 2, grid[0])
    emb_w = _1d(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)


def get_2d_relative_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """(N, N) relative position bias from sincos embeddings (`vig.py:21-29`)."""
    pos = get_2d_sincos_pos_embed(embed_dim, grid_size)
    return 2 * (pos @ pos.T) / pos.shape[1]


@functools.lru_cache(maxsize=None)
def relative_pos_buffer(channels: int, n: int, n_reduced: int,
                        device: torch.device) -> torch.Tensor:
    """The Grapher's (1, n, n_reduced) distance bias: minus the relative
    position embedding, resized by bicubic interpolation as upstream does
    (`vig.py:406-412`). Computed once per (channels, n, n_reduced, device), on
    the CPU so that every device gets the same values, and shared read-only."""
    rel = torch.from_numpy(np.float32(get_2d_relative_pos_embed(channels, int(n ** 0.5))))
    rel = F.interpolate(rel[None, None], size=(n, n_reduced), mode="bicubic",
                        align_corners=False)
    return (-rel[:, 0]).to(device)


# ------------------------------------------------------------- basic layers
def _act(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {"relu": F.relu,
            "gelu": functools.partial(F.gelu, approximate="tanh"),
            "leakyrelu": functools.partial(F.leaky_relu, negative_slope=0.2),
            "hswish": F.hardswish}[name.lower()]


def drop_path(x: torch.Tensor, rate: float, train: bool,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stochastic depth on the batch dim (timm DropPath): keep a sample with
    probability 1 - rate and scale it by 1/(1 - rate)."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def grouped_pointwise(x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
    """`conv(x)` for a grouped 1x1 `nn.Conv1d` on (B, C, L), as one batched
    matrix product per group. The same sums as the convolution; on an H100
    cuDNN's grouped kernel wraps each call in layout transposes and takes
    ~14x as long at the pvig_s widths (PERF.md)."""
    b, cin, length = x.shape
    g = conv.groups
    w = conv.weight.reshape(g, -1, cin // g)  # (g, Cout/g, Cin/g)
    out = torch.matmul(w, x.reshape(b, g, cin // g, length)).reshape(b, -1, length)
    return out if conv.bias is None else out + conv.bias[:, None]


class BasicConv(nn.Module):
    """Grouped 1x1 convs (groups 4, He init) + optional BatchNorm + act on
    (B, C, L) (`vig.py:476-500`). The weights are `nn.Conv1d`'s; the product
    is `grouped_pointwise`."""

    def __init__(self, in_channels: int, channels: Sequence[int], act: str = "relu",
                 norm: Optional[str] = None, bias: bool = True, groups: int = 4):
        super().__init__()
        self.n_layers = len(channels)
        self.act = _act(act) if act else None
        self.has_bn = norm == "batch"
        prev = in_channels
        for i, ch in enumerate(channels):
            setattr(self, f"conv_{i}", set_init(
                nn.Conv1d(prev, ch, 1, groups=groups, bias=bias), "he"))
            if self.has_bn:
                setattr(self, f"bn_{i}", BatchNorm2d(ch))
            prev = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = grouped_pointwise(x, getattr(self, f"conv_{i}"))
            if self.has_bn:  # BatchNorm2d on a (B, C, L, 1) view
                x = getattr(self, f"bn_{i}")(x.unsqueeze(-1)).squeeze(-1)
            if self.act is not None:
                x = self.act(x)
        return x


# ------------------------------------------------------------- graph convs
# Each takes x (B, N, C) and nn_idx (B, N, k) into y (B, M, C), y defaulting
# to x, and returns (B, out_channels, N).
class MRConv(nn.Module):
    """Max-Relative graph conv (`vig.py:88-105`). The concat keeps upstream's
    channel interleave [x_c0, agg_c0, x_c1, agg_c1, ...] (`vig.py:104`),
    which matters because the following conv is grouped."""

    def __init__(self, in_channels: int, out_channels: int, act: str = "relu",
                 norm: Optional[str] = None, bias: bool = True):
        super().__init__()
        self.nn = BasicConv(2 * in_channels, [out_channels], act, norm, bias)

    def forward(self, x: torch.Tensor, nn_idx: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_j = gather_neighbors(x if y is None else y, nn_idx)  # (B, N, k, C)
        agg = torch.amax(x_j - x.unsqueeze(2), dim=2)
        b, n, c = x.shape
        mixed = torch.stack([x, agg], dim=-1).reshape(b, n, 2 * c)
        return self.nn(mixed.transpose(1, 2))


class EdgeConv(nn.Module):
    """Edge conv with max aggregation (`vig.py:108-123`)."""

    def __init__(self, in_channels: int, out_channels: int, act: str = "relu",
                 norm: Optional[str] = None, bias: bool = True):
        super().__init__()
        self.nn = BasicConv(2 * in_channels, [out_channels], act, norm, bias)

    def forward(self, x: torch.Tensor, nn_idx: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_j = gather_neighbors(x if y is None else y, nn_idx)
        x_i = x.unsqueeze(2).expand_as(x_j)
        b, n, k, c = x_j.shape
        h = torch.cat([x_i, x_j - x_i], dim=-1).reshape(b, n * k, 2 * c)
        h = self.nn(h.transpose(1, 2))
        return torch.amax(h.reshape(b, -1, n, k), dim=-1)


class GraphSAGE(nn.Module):
    """GraphSAGE conv (`vig.py:126-141`)."""

    def __init__(self, in_channels: int, out_channels: int, act: str = "relu",
                 norm: Optional[str] = None, bias: bool = True):
        super().__init__()
        self.nn1 = BasicConv(in_channels, [in_channels], act, norm, bias)
        self.nn2 = BasicConv(2 * in_channels, [out_channels], act, norm, bias)

    def forward(self, x: torch.Tensor, nn_idx: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_j = gather_neighbors(x if y is None else y, nn_idx)
        b, n, k, c = x_j.shape
        h = self.nn1(x_j.reshape(b, n * k, c).transpose(1, 2))
        h = torch.amax(h.reshape(b, -1, n, k), dim=-1)
        return self.nn2(torch.cat([x.transpose(1, 2), h], dim=1))


class GINConv(nn.Module):
    """GIN conv (`vig.py:144-160`) with a learned eps, zero at init."""

    def __init__(self, in_channels: int, out_channels: int, act: str = "relu",
                 norm: Optional[str] = None, bias: bool = True):
        super().__init__()
        self.nn = BasicConv(in_channels, [out_channels], act, norm, bias)
        self.eps = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor, nn_idx: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_j = torch.sum(gather_neighbors(x if y is None else y, nn_idx), dim=2)
        return self.nn(((1 + self.eps) * x + x_j).transpose(1, 2))


_GRAPH_CONVS = {"mr": MRConv, "edge": EdgeConv, "sage": GraphSAGE, "gin": GINConv}


class GraphConv(nn.Module):
    """Dispatcher (`vig.py:163-181`)."""

    def __init__(self, in_channels: int, out_channels: int, conv: str = "edge",
                 act: str = "relu", norm: Optional[str] = None, bias: bool = True):
        super().__init__()
        self.gconv = _GRAPH_CONVS[conv](in_channels, out_channels, act, norm, bias)

    def forward(self, x: torch.Tensor, nn_idx: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.gconv(x, nn_idx, y)


class DyGraphConv(nn.Module):
    """Dynamic graph conv over a kNN graph built on the fly, the keys
    avg-pooled r x r when r > 1 (`vig.py:184-206`). NCHW in and out."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 9,
                 dilation: int = 1, conv: str = "edge", act: str = "relu",
                 norm: Optional[str] = None, bias: bool = True, stochastic: bool = False,
                 r: int = 1):
        super().__init__()
        self.kernel_size, self.dilation = kernel_size, dilation
        self.stochastic, self.r = stochastic, r
        self.gc = GraphConv(in_channels, out_channels, conv, act, norm, bias)

    def forward(self, x: torch.Tensor, relative_pos: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, _, h, w = x.shape
        y = None
        if self.r > 1:
            y = F.avg_pool2d(x, self.r, self.r).flatten(2).transpose(1, 2).contiguous()
        # (B, N, C), row-major over (H, W); contiguous for the gathers and the kernel
        nodes = x.flatten(2).transpose(1, 2).contiguous()
        nn_idx = dilated_knn_graph(nodes, y, self.kernel_size, self.dilation, relative_pos,
                                   stochastic=self.stochastic and self.training,
                                   generator=generator)
        return self.gc(nodes, nn_idx, y).reshape(b, -1, h, w)


class Grapher(nn.Module):
    """fc1 -> dynamic graph conv -> fc2 with a drop-path residual
    (`vig.py:384-430`)."""

    def __init__(self, in_channels: int, kernel_size: int = 9, dilation: int = 1,
                 conv: str = "edge", act: str = "relu", norm: Optional[str] = None,
                 bias: bool = True, stochastic: bool = False, r: int = 1,
                 drop_path_rate: float = 0.0, relative_pos: bool = False):
        super().__init__()
        self.in_channels, self.r = in_channels, r  # the bias follows the input's n
        self.drop_path_rate, self.relative_pos = drop_path_rate, relative_pos
        self.fc1 = conv2d(in_channels, in_channels, 1)
        self.bn1 = BatchNorm2d(in_channels)
        self.graph_conv = DyGraphConv(in_channels, in_channels * 2, kernel_size, dilation,
                                      conv, act, norm, bias, stochastic, r)
        self.fc2 = conv2d(in_channels * 2, in_channels, 1)
        self.bn2 = BatchNorm2d(in_channels)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        shortcut = x
        x = self.bn1(self.fc1(x))
        rel = None
        if self.relative_pos:
            n = x.shape[2] * x.shape[3]
            rel = relative_pos_buffer(self.in_channels, n, n // (self.r * self.r), x.device)
        x = self.graph_conv(x, rel, generator)
        x = self.bn2(self.fc2(x))
        return drop_path(x, self.drop_path_rate, self.training, generator) + shortcut


class FFN(nn.Module):
    """1x1-conv MLP with a drop-path residual (`vig.py:524-546`)."""

    def __init__(self, in_channels: int, hidden: int, out: int, act: str = "relu",
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.act, self.drop_path_rate = _act(act), drop_path_rate
        self.fc1 = conv2d(in_channels, hidden, 1)
        self.bn1 = BatchNorm2d(hidden)
        self.fc2 = conv2d(hidden, out, 1)
        self.bn2 = BatchNorm2d(out)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        shortcut = x
        x = self.bn2(self.fc2(self.act(self.bn1(self.fc1(x)))))
        return drop_path(x, self.drop_path_rate, self.training, generator) + shortcut


class Stem(nn.Module):
    """Two stride-2 3x3 convs and a stride-1 one, each padded 1 on every side
    as the reference's `padding=1` (`vig.py:549-568`)."""

    def __init__(self, in_channels: int, out_dim: int, act: str = "relu"):
        super().__init__()
        self.act = _act(act)
        self.conv1 = conv2d(in_channels, out_dim // 2, 3, 2, 1)
        self.bn1 = BatchNorm2d(out_dim // 2)
        self.conv2 = conv2d(out_dim // 2, out_dim, 3, 2, 1)
        self.bn2 = BatchNorm2d(out_dim)
        self.conv3 = conv2d(out_dim, out_dim, 3, 1, 1)
        self.bn3 = BatchNorm2d(out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act(self.bn1(self.conv1(x)))
        x = self.act(self.bn2(self.conv2(x)))
        return self.bn3(self.conv3(x))


class Downsample(nn.Module):
    """Stride-2 3x3 conv, padding 1, + BatchNorm (`vig.py:571-583`)."""

    def __init__(self, in_channels: int, out_dim: int):
        super().__init__()
        self.conv = conv2d(in_channels, out_dim, 3, 2, 1)
        self.bn = BatchNorm2d(out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class DeepGCN(nn.Module):
    """Pyramid ViG classifier (`vig.py:586-651`): NCHW images -> (B, n_classes)
    logits. The Grapher of global index `idx` in stage i reduces its keys by
    [4, 2, 1, 1][i] and dilates by min(idx // 4 + 1, 49 // k)."""

    def __init__(self, blocks: Sequence[int] = (2, 2, 6, 2),
                 channels: Sequence[int] = (48, 96, 240, 384), k: int = 9,
                 conv: str = "mr", act: str = "gelu", norm: str = "batch", bias: bool = True,
                 stochastic: bool = False, drop_path_rate: float = 0.0,
                 dropout: float = 0.0, n_classes: int = 1000, img_size: int = 224,
                 in_channels: int = 3):
        super().__init__()
        self.blocks = tuple(blocks)
        self.act, self.p_dropout = _act(act), dropout
        dpr = np.linspace(0, drop_path_rate, sum(blocks))
        max_dilation = 49 // k
        reduce_ratios = [4, 2, 1, 1]

        self.stem = Stem(in_channels, channels[0], act)
        hw = img_size // 4
        self.pos_embed = nn.Parameter(torch.zeros(1, channels[0], hw, hw))
        idx = 0
        for i, (n_blk, ch) in enumerate(zip(blocks, channels)):
            if i > 0:
                setattr(self, f"down_{i}", Downsample(channels[i - 1], ch))
            for _ in range(n_blk):
                setattr(self, f"grapher_{idx}", Grapher(
                    ch, k, min(idx // 4 + 1, max_dilation), conv, act, norm, bias,
                    stochastic, reduce_ratios[i], drop_path_rate=float(dpr[idx]),
                    relative_pos=True))
                setattr(self, f"ffn_{idx}", FFN(ch, ch * 4, ch, act, float(dpr[idx])))
                idx += 1
        self.pred_conv1 = conv2d(channels[-1], 1024, 1)
        self.pred_bn = BatchNorm2d(1024)
        self.pred_conv2 = conv2d(1024, n_classes, 1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.stem(x) + self.pos_embed
        idx = 0
        for i, n_blk in enumerate(self.blocks):
            if i > 0:
                x = getattr(self, f"down_{i}")(x)
            for _ in range(n_blk):
                x = getattr(self, f"grapher_{idx}")(x, generator)
                x = getattr(self, f"ffn_{idx}")(x, generator)
                idx += 1
        x = torch.mean(x, dim=(2, 3), keepdim=True)  # adaptive avg pool
        x = self.act(self.pred_bn(self.pred_conv1(x)))
        x = dropout(x, self.p_dropout, self.training, generator)
        return self.pred_conv2(x)[:, :, 0, 0]


def _build(blocks, channels, device, seed: int, **kw) -> DeepGCN:
    device = resolve_device(device)  # without a card, raise before building
    model = DeepGCN(blocks=blocks, channels=channels, **kw)
    initialize(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def pvig_ti(device=None, seed: int = 0, **kw) -> DeepGCN:
    """`pvig_ti_224_gelu` (`vig.py:655-676`), random weights from `seed`, on
    CUDA unless `device` names another."""
    return _build((2, 2, 6, 2), (48, 96, 240, 384), device, seed, **kw)


def pvig_s(device=None, seed: int = 0, **kw) -> DeepGCN:
    """`pvig_s_224_gelu` (`vig.py:680-701`)."""
    return _build((2, 2, 6, 2), (80, 160, 400, 640), device, seed, **kw)


def pvig_m(device=None, seed: int = 0, **kw) -> DeepGCN:
    """`pvig_m_224_gelu` (`vig.py:705-726`)."""
    return _build((2, 2, 16, 2), (96, 192, 384, 768), device, seed, **kw)


def pvig_b(device=None, seed: int = 0, **kw) -> DeepGCN:
    """`pvig_b_224_gelu` (`vig.py:730-751`)."""
    return _build((2, 2, 18, 2), (128, 256, 512, 1024), device, seed, **kw)
