"""Fused pairwise-concat MLP, the affinity hot op; port of
`graphecho_tpu/ops/pairwise_mlp.py` and of the Pallas kernel
`graphecho_tpu/ops/pallas/pairwise_mlp_kernel.py::pallas_pairwise_mlp`.

The reference `Affinity` (`models/affinity_layer.py:52-73`) pushes an
(N1, N2, 2C) concat-expand through Linear + ReLU + Linear. Splitting the first
Linear into its X and Y halves gives

    M[i, j] = w2 · relu(a_i + b_j) + b2      with  a = X Wx + b1,  b = Y Wy

so only the pairwise ReLU-reduce is quadratic. On a CUDA tensor that reduce
and its backward run in the hand-written kernels of `csrc/pairwise_mlp.cu`
(`PairwiseMLPFunction`), at every size; on a CPU tensor the plain version
below runs instead. There is no fallback from one to the other: a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from graphecho_torch.ops import cuda_build

# launches of each kernel entry point since the last `reset_launch_counts()`
LAUNCHES: Dict[str, int] = {"pairwise_mlp_fwd": 0, "pairwise_mlp_bwd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ----------------------------------------------------------------- plain version
def _relu(t: torch.Tensor) -> torch.Tensor:
    """relu, NaN kept, whose gradient is 1[t > 0] as `jax.nn.relu`'s is: 0
    at NaN, where `torch.relu`'s backward (masking only t <= 0) lets it
    through."""
    return torch.where(t > 0, t, torch.relu(t.detach()))


def pairwise_mlp(a: torch.Tensor, b: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor, block: int = 128) -> torch.Tensor:
    """M[i,j] = sum_k w2[k]*relu(a[i,k]+b[j,k]) + b2, in plain PyTorch.

    a: (N1, K), b: (N2, K), w2: (K,), b2: scalar -> (N1, N2). Blocked over
    rows of `a` so the (block, N2, K) broadcast stays bounded, as the JAX
    package's XLA path is."""
    rows = [torch.sum(_relu(a[s:s + block, None, :] + b[None, :, :]) * w2, dim=-1)
            for s in range(0, a.shape[0], block)]
    return torch.cat(rows, dim=0) + b2


pairwise_mlp_reference = pairwise_mlp


def _plain_bwd_da(a, b, w2, g, block: int = 128):
    """dA, dw2 and db2 of the pairwise MLP from their formulas."""
    da, dw2 = [], torch.zeros_like(w2)
    for s in range(0, a.shape[0], block):
        t = a[s:s + block, None, :] + b[None, :, :]
        gb = g[s:s + block]
        da.append(w2 * torch.einsum("ij,ijk->ik", gb, (t > 0).to(t.dtype)))
        dw2 = dw2 + torch.einsum("ij,ijk->k", gb, torch.relu(t))
    return torch.cat(da, dim=0), dw2, g.sum()


def _plain_bwd_db(a, b, w2, g, block: int = 128):
    """dB of the pairwise MLP from its formula."""
    db = []
    for s in range(0, b.shape[0], block):
        t = a[:, None, :] + b[None, s:s + block, :]
        db.append(w2 * torch.einsum("ij,ijk->jk", g[:, s:s + block],
                                    (t > 0).to(t.dtype)))
    return torch.cat(db, dim=0)


def pairwise_mlp_backward_reference(a: torch.Tensor, b: torch.Tensor,
                                    w2: torch.Tensor, g: torch.Tensor
                                    ) -> Tuple[torch.Tensor, ...]:
    """(dA, dB, dw2, db2) for the cotangent `g` (N1, N2):
    dA[i,k] = w2[k]·Σ_j g·1[a+b>0], dB[j,k] = w2[k]·Σ_i g·1[a+b>0],
    dw2[k] = Σ_ij g·relu(a+b), db2 = Σ g."""
    da, dw2, db2 = _plain_bwd_da(a, b, w2, g)
    return da, _plain_bwd_db(a, b, w2, g), dw2, db2


# ------------------------------------------------------------------ the kernels
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("pairwise_mlp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pairwise_mlp_fwd.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.pairwise_mlp_fwd.restype = ctypes.c_int
    lib.pairwise_mlp_fwd_plan.argtypes = [i, i, i]
    lib.pairwise_mlp_fwd_plan.restype = ctypes.c_int
    lib.pairwise_mlp_bwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, p]
    lib.pairwise_mlp_bwd.restype = ctypes.c_int
    lib.pairwise_mlp_bwd_scratch_floats.argtypes = [i, i, i]
    lib.pairwise_mlp_bwd_scratch_floats.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=None)
def _scratch_floats(n1: int, n2: int, k: int) -> int:
    """Floats of scratch the backward entry point needs at this shape."""
    return _lib().pairwise_mlp_bwd_scratch_floats(n1, n2, k)


def _check_inputs(a, b, w2, g=None) -> Tuple[int, int, int]:
    tensors = (a, b, w2) if g is None else (a, b, w2, g)
    dev = a.get_device()  # -1 on the CPU; an int compares faster than a torch.device
    for t in tensors:
        if (dev < 0 or t.get_device() != dev or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError("pairwise_mlp kernels take contiguous float32 tensors on "
                             f"one CUDA device, got {t.dtype} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
    n1, k = a.shape
    n2 = b.shape[0]
    if b.shape != (n2, k) or w2.shape != (k,):
        raise ValueError(f"shape mismatch: a {tuple(a.shape)}, b {tuple(b.shape)}, "
                         f"w2 {tuple(w2.shape)}")
    if g is not None and g.shape != (n1, n2):
        raise ValueError(f"cotangent shape {tuple(g.shape)} != {(n1, n2)}")
    return n1, n2, k


def _stream(t: torch.Tensor) -> int:
    # the raw handle of the current stream, without building a torch.cuda.Stream
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def launch_fwd(a: torch.Tensor, b: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor
               ) -> torch.Tensor:
    """(N1, N2) = Σ_k w2[k]·relu(a[i,k]+b[j,k]) + b2 on the card, in one
    launch; `b2` is a one-element float32 tensor on the same card, read
    there and never on the host."""
    n1, n2, k = _check_inputs(a, b, w2)
    if b2.get_device() != a.get_device() or b2.dtype != torch.float32 or b2.numel() != 1:
        raise ValueError("pairwise_mlp_fwd takes b2 as one float32 on the inputs' CUDA "
                         f"device, got {tuple(b2.shape)} {b2.dtype} on {b2.device}")
    out = a.new_empty((n1, n2))
    err = _lib().pairwise_mlp_fwd(a.data_ptr(), b.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                                  out.data_ptr(), n1, n2, k, _stream(a))
    cuda_build.check(err, "pairwise_mlp_fwd")
    LAUNCHES["pairwise_mlp_fwd"] += 1
    return out


def launch_bwd(a: torch.Tensor, b: torch.Tensor, w2: torch.Tensor, g: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dA, dB, dw2, db2) on the card for the cotangent `g` (N1, N2); db2 has
    shape (1,). dA, dB and the scratch are views of one buffer, dw2 and db2 of
    another (a small one, so a `.grad` that keeps it holds nothing else)."""
    n1, n2, k = _check_inputs(a, b, w2, g)
    nk1, nk2 = n1 * k, n2 * k
    big = a.new_empty((nk1 + nk2 + _scratch_floats(n1, n2, k),))
    small = a.new_empty((k + 1,))
    da, db = big.as_strided((n1, k), (k, 1)), big.as_strided((n2, k), (k, 1), nk1)
    dw2, db2 = small.as_strided((k,), (1,)), small.as_strided((1,), (1,), k)
    ptr, sptr = big.data_ptr(), small.data_ptr()  # addresses in bytes, 4 a float
    err = _lib().pairwise_mlp_bwd(
        a.data_ptr(), b.data_ptr(), w2.data_ptr(), g.data_ptr(), ptr, ptr + 4 * nk1, sptr,
        sptr + 4 * k, ptr + 4 * (nk1 + nk2), n1, n2, k, _stream(a))
    cuda_build.check(err, "pairwise_mlp_bwd")
    LAUNCHES["pairwise_mlp_bwd"] += 1
    return da, db, dw2, db2


class PairwiseMLPFunction(torch.autograd.Function):
    """M = pairwise_mlp(a, b, w2) + b2 with the fused CUDA forward (b2 added
    in its epilogue: one launch) and backward (the JAX package's `custom_vjp`
    around the Pallas kernels)."""

    @staticmethod
    def forward(ctx, a, b, w2, b2):
        a, b, w2 = a.contiguous(), b.contiguous(), w2.contiguous()
        ctx.save_for_backward(a, b, w2)
        ctx.b2_shape = b2.shape
        return launch_fwd(a, b, w2, b2)

    @staticmethod
    def backward(ctx, g):
        a, b, w2 = ctx.saved_tensors
        da, db, dw2, db2 = launch_bwd(a, b, w2, g.contiguous())
        return da, db, dw2, db2.reshape(ctx.b2_shape)


def pairwise_mlp_auto(a: torch.Tensor, b: torch.Tensor, w2: torch.Tensor,
                      b2: torch.Tensor) -> torch.Tensor:
    """The kernel for a CUDA tensor, at every size; the plain version for a
    CPU tensor."""
    if a.is_cuda:
        return PairwiseMLPFunction.apply(a, b, w2, b2)
    return pairwise_mlp(a, b, w2, b2)
