"""Dense kNN graph construction, port of `graphecho_tpu/ops/knn.py` and of the
Pallas kernel `graphecho_tpu/ops/pallas/knn_kernel.py::pallas_knn`.

Nodes keep the JAX package's layout, (B, N, C). The ViG graph builders
(reference `models/vig.py:232-381`) compute squared distances under
stop-gradient, keep the k nearest keys of every query, and take every
`dilation`-th of k*dilation candidates.

Order matters beyond the neighbour set, because `idx[..., ::dilation]` picks
by rank: neighbours come in ascending distance with ties to the lowest
column, as `jax.lax.top_k` of the negated distances and the Pallas passes
give them. `torch.topk` promises no order for ties, so the plain selection
here is a stable sort.

`dilated_knn_graph` runs the hand-written kernel of `csrc/knn.cu` for a CUDA
tensor, at every size, and the plain version below for a CPU tensor. There is
no fallback from one to the other: a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from graphecho_torch.ops import cuda_build

# launches of the kernel entry point since the last `reset_launch_counts()`
LAUNCHES: Dict[str, int] = {"knn": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ----------------------------------------------------------------- plain version
def pairwise_sq_distance(x: torch.Tensor, y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, N, C), y: (B, M, C) -> (B, N, M) squared Euclidean distances,
    without gradient like the reference's `torch.no_grad()` (`vig.py:240,270`).

    The dtypes are the JAX package's: the squared norms in the input dtype,
    the inner product accumulated in f32 (`preferred_element_type`) on the
    inputs' exact f32 values, so bf16 inputs give an f32 matrix."""
    x = x.detach()
    y = x if y is None else y.detach()
    x_sq = torch.sum(x * x, dim=-1, keepdim=True)
    y_sq = torch.sum(y * y, dim=-1, keepdim=True)
    acc = torch.promote_types(torch.promote_types(x.dtype, y.dtype), torch.float32)
    inner = torch.bmm(x.to(acc), y.to(acc).transpose(1, 2))
    return x_sq - 2.0 * inner + y_sq.transpose(-2, -1)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """`F.normalize(p=2)` semantics: x / max(||x||, eps)."""
    norm = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp_min(norm, eps)


def _smallest(dist: torch.Tensor, k: int) -> torch.Tensor:
    """Columns of the k smallest entries of each row, ascending, ties to the
    lowest column."""
    if k > dist.shape[-1]:
        raise ValueError(f"k={k} neighbours asked of {dist.shape[-1]} keys")
    return torch.sort(dist, dim=-1, stable=True).indices[..., :k].to(torch.int32)


def dense_knn(x: torch.Tensor, y: Optional[torch.Tensor] = None, k: int = 16,
              relative_pos: Optional[torch.Tensor] = None,
              n_part: int = 10000) -> torch.Tensor:
    """kNN indices of each x-node among the y-nodes (y defaults to x).

    x: (B, N, C), y: (B, M, C) -> (B, N, k) int32. Beyond `n_part` queries
    the distances are computed in query chunks, with the matching slice of
    `relative_pos` (the reference's `part_pairwise_distance`,
    `vig.py:288-301`); the bias keeps its own leading dimension."""
    n = x.shape[1]
    if n > n_part:
        rp = None
        if relative_pos is not None:
            rp = relative_pos[None] if relative_pos.dim() == 2 else relative_pos
        chunks = []
        for s in range(0, n, n_part):
            dist = pairwise_sq_distance(x[:, s:s + n_part], x if y is None else y)
            if rp is not None:
                dist = dist + rp[:, s:s + n_part]
            chunks.append(_smallest(dist, k))
        return torch.cat(chunks, dim=1)
    dist = pairwise_sq_distance(x, y)
    if relative_pos is not None:
        dist = dist + relative_pos
    return _smallest(dist, k)


def knn_reference(x: torch.Tensor, y: Optional[torch.Tensor] = None, k: int = 9,
                  normalize: bool = True,
                  relative_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of the kernel: optional L2 normalization, then
    `dense_knn`. (B, N, k) int32."""
    if normalize:
        x = l2_normalize(x.detach())
        y = None if y is None else l2_normalize(y.detach())
    return dense_knn(x, y, k, relative_pos)


def knn_tie_gap(x: torch.Tensor, y: Optional[torch.Tensor],
                relative_pos: Optional[torch.Tensor], normalize: bool, got: torch.Tensor,
                want: torch.Tensor) -> Tuple[int, float]:
    """(rows where the neighbours `got` differ from `want`, the largest gap
    between the float64 distances of the two picks at a position where they
    differ). A gap near 0 means the two orders differ only at a near tie."""
    diff = got != want
    rows = int(diff.any(-1).sum())
    if rows == 0:
        return 0, 0.0
    bi, ni, _ = diff.nonzero(as_tuple=True)
    xs = x.double()
    ys = xs if y is None else y.double()
    if normalize:
        xs, ys = l2_normalize(xs), l2_normalize(ys)

    def dist(cols):
        cols = cols.long()
        d = ((xs[bi, ni] - ys[bi, cols]) ** 2).sum(-1)
        if relative_pos is not None:
            d = d + relative_pos.double()[bi if relative_pos.shape[0] > 1 else 0, ni, cols]
        return d

    return rows, (dist(got[diff]) - dist(want[diff])).abs().max().item()


# -------------------------------------------------------------------- the kernel
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("knn")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.knn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    lib.knn.restype = ctypes.c_int
    lib.knn_max_k.argtypes = []
    lib.knn_max_k.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _max_k() -> int:
    """The largest k the kernel's k-best lists hold (64; pvig needs 45)."""
    return _lib().knn_max_k()


def _check_inputs(x: torch.Tensor, y: torch.Tensor, k: int,
                  relative_pos: Optional[torch.Tensor]) -> Tuple[int, int, int, int, int]:
    tensors = (x, y) if relative_pos is None else (x, y, relative_pos)
    dev = x.get_device()  # -1 on the CPU; an int compares faster than a torch.device
    for t in tensors:
        if (dev < 0 or t.get_device() != dev or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError("the knn kernel takes contiguous float32 tensors on one CUDA "
                             f"device, got {t.dtype} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
    if x.dim() != 3 or y.dim() != 3 or y.shape[0] != x.shape[0] or y.shape[2] != x.shape[2]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, y {tuple(y.shape)}")
    b, n, c = x.shape
    m = y.shape[1]
    if min(b, n, m, c) < 1:
        raise ValueError(f"empty input: x {tuple(x.shape)}, y {tuple(y.shape)}")
    max_k = _max_k()
    if not 1 <= k <= min(m, max_k):
        raise ValueError(f"the knn kernel takes 1 <= k <= min(M={m}, {max_k}), got k={k}")
    rel_batch = 0
    if relative_pos is not None:
        if relative_pos.dim() != 3 or relative_pos.shape[1:] != (n, m) \
                or relative_pos.shape[0] not in (1, b):
            raise ValueError(f"relative_pos {tuple(relative_pos.shape)} is not (1|{b}, {n}, {m})")
        rel_batch = relative_pos.shape[0]
    return b, n, m, c, rel_batch


def launch_knn(x: torch.Tensor, y: Optional[torch.Tensor] = None, k: int = 9,
               normalize: bool = True,
               relative_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, N, k) int32 neighbour indices on the card; y=None is the self graph.
    `relative_pos`: optional (1|B, N, M) additive distance bias."""
    y = x if y is None else y
    b, n, m, c, rel_batch = _check_inputs(x, y, k, relative_pos)
    out = torch.empty((b, n, k), device=x.device, dtype=torch.int32)
    rel_ptr = None if relative_pos is None else relative_pos.data_ptr()
    # the raw handle of the current stream, without building a torch.cuda.Stream
    # (a sixth of the wrapper's host time at small shapes)
    stream = torch._C._cuda_getCurrentRawStream(x.get_device())
    err = _lib().knn(x.data_ptr(), y.data_ptr(), rel_ptr, out.data_ptr(),
                     b, n, m, c, k, rel_batch, int(normalize), stream)
    cuda_build.check(err, "knn")
    LAUNCHES["knn"] += 1
    return out


# ---------------------------------------------------------------------- the graph
def dilated_knn_graph(x: torch.Tensor, y: Optional[torch.Tensor] = None, k: int = 9,
                      dilation: int = 1, relative_pos: Optional[torch.Tensor] = None,
                      stochastic: bool = False,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """L2-normalize, take the k*dilation nearest keys, keep every
    `dilation`-th (`DenseDilatedKnnGraph`, `vig.py:357-381`). With
    `stochastic`, keep k of the k*dilation candidates picked by one random
    permutation for the whole batch instead (`DenseDilated`, `:344-351`).

    The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    kd = k * dilation
    if x.is_cuda:
        def prep(t):
            return None if t is None else t.detach().float().contiguous()

        if relative_pos is not None and relative_pos.dim() == 2:
            relative_pos = relative_pos[None]
        idx = launch_knn(prep(x), prep(y), kd, True, prep(relative_pos))
    else:
        idx = knn_reference(x, y, kd, True, relative_pos)
    if stochastic:
        gen_device = generator.device if generator is not None else idx.device
        perm = torch.randperm(kd, generator=generator, device=gen_device)[:k]
        return idx[..., perm.to(idx.device)]
    return idx[..., ::dilation]


def gather_neighbors(y: torch.Tensor, nn_idx: torch.Tensor) -> torch.Tensor:
    """y: (B, M, C), nn_idx: (B, N, k) -> (B, N, k, C) neighbour features
    (`batched_index_select`, `vig.py:209-229`), as one row gather over the
    (B*M, C) view."""
    b, m, c = y.shape
    _, n, k = nn_idx.shape
    base = (torch.arange(b, device=nn_idx.device) * m)[:, None, None]
    flat = (nn_idx.long() + base).reshape(-1)
    return y.reshape(b * m, c).index_select(0, flat).reshape(b, n, k, c)


def knn_edges_reference_format(x: torch.Tensor, y: Optional[torch.Tensor],
                               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nn_idx, center_idx) in the reference's stack layout (`vig.py:308-309`)."""
    nn_idx = dense_knn(x, y, k)
    b, n, _ = nn_idx.shape
    center = torch.arange(n, dtype=torch.int32, device=x.device)[None, :, None].expand(b, n, k)
    return nn_idx, center
