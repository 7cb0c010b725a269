"""Pyramid ViG-S (Vision GNN) as an FPN backbone, in plain float32 PyTorch.

"Vision GNN: An Image is Worth Graph of Nodes" (arXiv:2206.00272),
`pvig_s_224_gelu` of huawei-noah/Efficient-AI-Backbones
(`vig_pytorch/pyramid_vig.py`, `gcn_lib/torch_vertex.py`,
`gcn_lib/torch_edge.py`), as upstream GraphEcho vendors it in
`models/vig.py`. A stem of three 3x3 convolutions (strides 2, 2, 1) plus a
position embedding, then four stages of Grapher and FFN blocks with a
stride-2 3x3 downsample before stages 2 to 4. A Grapher is a 1x1 conv and
BatchNorm, a dynamic graph convolution and a 1x1 conv and BatchNorm, with a
residual. The graph convolution takes every node's k·d nearest keys by the
L2-normalised squared distance plus a relative-position bias, keeps every
d-th (d = min(idx // 4 + 1, 49 // k) for the Grapher of global index idx),
and mixes each node with its max-relative feature max_j(x_j - x_i) by a
grouped (4 groups) 1x1 conv, BatchNorm and GELU. Keys are average-pooled
4x4 in stage 1 and 2x2 in stage 2. The FFN is a 1x1 conv to 4x the width,
BatchNorm, GELU, a 1x1 conv back and BatchNorm, with a residual.

The module returns [stem map, stage 1, 2, 3, 4 maps] (strides 4, 4, 8,
16, 32), the five levels the reference FPN takes, and gives their widths as
`out_channels`.

Departures from upstream:

  * GELU is the tanh approximation, as in the system under test and the JAX
    package it was ported from; upstream uses exact `nn.GELU()`;
  * the benchmark's frames are 1-channel at 256x256 and the position
    embedding is (256 / 4)², where the published model takes 3 channels at
    224x224 with a 56² embedding; the bias is computed for the frame's own
    node count;
  * the kNN graph is a stable sort of the distances, so ties go to the
    lowest column (upstream's `torch.topk` leaves their order open, and
    the dilation picks by rank); a builder may pass another `graph` that
    breaks near ties otherwise (`benchmark/vig_graphs.py`);
  * no stochastic graph and no drop-path (`pvig_s_224_gelu`'s defaults:
    `use_stochastic=False`, `drop_path_rate=0.0`), and no classifier head;
  * the grouped 1x1 convs hold `nn.Conv1d` weights over the flattened nodes
    (the same numbers as upstream's `nn.Conv2d` of kernel 1);
  * BatchNorm folds the biased batch variance into its running statistics
    (`uda/backbones.py`), the rule of the system under test;
  * the relative-position bias is computed from the widths, never stored:
    upstream keeps it as a frozen parameter of the same value.

Leaf names and shapes are those of the system under test, so
`benchmark/weights.py` gives both the same values. Builds on the meta
device (`benchmark/work.py` counts its FLOPs there).
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.uda.backbones import BatchNorm2d, conv2d
from benchmark.reference.uda.knn import gather_neighbors, l2_normalize, pairwise_sq_distance

# the published Pyramid ViG-S (`pvig_s_224_gelu`)
PVIG_S = {"blocks": (2, 2, 6, 2), "channels": (80, 160, 400, 640), "k": 9}
REDUCE = (4, 2, 1, 1)  # the keys' average pooling, by stage
GROUPS = 4
Graph = Callable[[torch.Tensor, int, int], torch.Tensor]  # (dist, k, dilation) -> (B, N, k)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def sincos_pos_embed(dim: int, grid: int) -> np.ndarray:
    """(grid², dim) 2-D sine-cosine embedding (MAE's `get_2d_sincos_pos_embed`)."""
    def one_axis(d, pos):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    ax = np.arange(grid, dtype=np.float32)
    gw, gh = np.meshgrid(ax, ax)
    return np.concatenate([one_axis(dim // 2, gw), one_axis(dim // 2, gh)], axis=1)


@functools.lru_cache(maxsize=None)
def relative_pos(channels: int, n: int, n_keys: int, device: torch.device) -> torch.Tensor:
    """The (1, n, n_keys) bias added to a Grapher's distances: minus
    2 e_i·e_j / channels of the sine-cosine embeddings of the n nodes,
    bicubically resized over the keys' axis to the pooled key count."""
    pos = sincos_pos_embed(channels, int(round(n ** 0.5)))
    rel = torch.from_numpy(np.float32(2 * (pos @ pos.T) / pos.shape[1]))
    rel = F.interpolate(rel[None, None], size=(n, n_keys), mode="bicubic", align_corners=False)
    return (-rel[:, 0]).to(device)


def graph_distances(x: torch.Tensor, y: Optional[torch.Tensor],
                    bias: torch.Tensor) -> torch.Tensor:
    """(B, N, M): the squared distance of each x-row to each y-row (y = x
    when None), both L2-normalised, plus `bias`; no gradient."""
    x = l2_normalize(x.detach().float())
    y = x if y is None else l2_normalize(y.detach().float())
    return pairwise_sq_distance(x, y) + bias


def dilated_knn_graph(dist: torch.Tensor, k: int, dilation: int) -> torch.Tensor:
    """(B, N, k) int32: every `dilation`-th of each row's k·dilation nearest
    keys by `dist`, ascending, ties to the lowest column."""
    order = torch.sort(dist, dim=-1, stable=True).indices
    return order[..., :k * dilation:dilation].to(torch.int32)


class BasicConv(nn.Module):
    """Grouped 1x1 conv, BatchNorm and GELU over (B, C, N)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv_0 = nn.Conv1d(cin, cout, 1, groups=GROUPS)
        self.bn_0 = BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.conv1d(x, self.conv_0.weight, self.conv_0.bias, groups=GROUPS)
        return gelu(self.bn_0(x[..., None])[..., 0])


class MRConv(nn.Module):
    """Max-relative graph conv: [x_i, max_j (x_j - x_i)] interleaved channel
    by channel, then `BasicConv`."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.nn = BasicConv(2 * cin, cout)

    def forward(self, x: torch.Tensor, idx: torch.Tensor,
                y: Optional[torch.Tensor]) -> torch.Tensor:
        x_j = gather_neighbors(x if y is None else y, idx)  # (B, N, k, C)
        agg = (x_j - x[:, :, None]).amax(dim=2)
        b, n, c = x.shape
        mixed = torch.stack([x, agg], dim=-1).reshape(b, n, 2 * c)
        return self.nn(mixed.transpose(1, 2))


class GraphConv(nn.Module):
    """Holds the graph conv as `gconv`: the system's leaf names."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.gconv = MRConv(cin, cout)


class DyGraphConv(nn.Module):
    """The kNN graph over the map's nodes (keys pooled r x r) and the
    max-relative conv over it; NCHW in and out. `graph(dist, k, dilation)`
    makes the graph from the distances (`dilated_knn_graph`)."""

    def __init__(self, cin: int, cout: int, k: int, dilation: int, r: int,
                 graph: Graph = dilated_knn_graph):
        super().__init__()
        self.k, self.dilation, self.r = k, dilation, r
        self.graph = graph
        self.gc = GraphConv(cin, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        nodes = x.flatten(2).transpose(1, 2)  # (B, N, C), row-major over (H, W)
        y = None
        if self.r > 1:
            y = F.avg_pool2d(x, self.r, self.r).flatten(2).transpose(1, 2)
        n = h * w
        bias = relative_pos(c, n, n // (self.r * self.r), x.device)
        idx = self.graph(graph_distances(nodes, y, bias), self.k, self.dilation)
        return self.gc.gconv(nodes, idx, y).reshape(b, -1, h, w)


class Grapher(nn.Module):
    def __init__(self, ch: int, k: int, dilation: int, r: int, graph: Graph):
        super().__init__()
        self.fc1 = conv2d(ch, ch, 1)
        self.bn1 = BatchNorm2d(ch)
        self.graph_conv = DyGraphConv(ch, 2 * ch, k, dilation, r, graph)
        self.fc2 = conv2d(2 * ch, ch, 1)
        self.bn2 = BatchNorm2d(ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn2(self.fc2(self.graph_conv(self.bn1(self.fc1(x))))) + x


class FFN(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.fc1 = conv2d(ch, 4 * ch, 1)
        self.bn1 = BatchNorm2d(4 * ch)
        self.fc2 = conv2d(4 * ch, ch, 1)
        self.bn2 = BatchNorm2d(ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn2(self.fc2(gelu(self.bn1(self.fc1(x))))) + x


class Stem(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = conv2d(cin, cout // 2, 3, 2, 1)
        self.bn1 = BatchNorm2d(cout // 2)
        self.conv2 = conv2d(cout // 2, cout, 3, 2, 1)
        self.bn2 = BatchNorm2d(cout)
        self.conv3 = conv2d(cout, cout, 3, 1, 1)
        self.bn3 = BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = gelu(self.bn1(self.conv1(x)))
        x = gelu(self.bn2(self.conv2(x)))
        return self.bn3(self.conv3(x))


class Downsample(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = conv2d(cin, cout, 3, 2, 1)
        self.bn = BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class PyramidViG(nn.Module):
    def __init__(self, blocks: Sequence[int], channels: Sequence[int], k: int,
                 img_size: int, in_channels: int = 1, graph: Graph = dilated_knn_graph):
        super().__init__()
        self.blocks = tuple(blocks)
        self.out_channels = (channels[0], *channels)
        self.stem = Stem(in_channels, channels[0])
        self.pos_embed = nn.Parameter(torch.zeros(1, channels[0], img_size // 4, img_size // 4))
        idx = 0
        for i, (n_blk, ch) in enumerate(zip(blocks, channels)):
            if i > 0:
                setattr(self, f"down_{i}", Downsample(channels[i - 1], ch))
            for _ in range(n_blk):
                setattr(self, f"grapher_{idx}",
                        Grapher(ch, k, min(idx // 4 + 1, 49 // k), REDUCE[i], graph))
                setattr(self, f"ffn_{idx}", FFN(ch))
                idx += 1

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem(x) + self.pos_embed
        maps = [x]
        idx = 0
        for i, n_blk in enumerate(self.blocks):
            if i > 0:
                x = getattr(self, f"down_{i}")(x)
            for _ in range(n_blk):
                x = getattr(self, f"ffn_{idx}")(getattr(self, f"grapher_{idx}")(x))
                idx += 1
            maps.append(x)
        return maps


def pvig_s(img_size: int, in_channels: int = 1, graph: Graph = dilated_knn_graph) -> PyramidViG:
    return PyramidViG(**PVIG_S, img_size=img_size, in_channels=in_channels, graph=graph)
