"""On-device spectral clustering for the seed memory bank, port of
`graphecho_tpu/ops/spectral.py`.

The reference calls sklearn's `SpectralClustering(2,
affinity='nearest_neighbors', n_neighbors=n//2)` on the CPU inside the train
step (`models/graph_matching.py:539-543`). As in the JAX package the same
pipeline runs on the device with static shapes:

  1. kNN connectivity graph (k = n_valid // 2) from pairwise distances,
     symmetrized 0.5*(A + A^T) like sklearn;
  2. symmetric normalized Laplacian, invalid rows pushed up the spectrum;
  3. Fiedler vector by a deflated Lanczos solve (`solver="lanczos"`, the
     default) or a dense `torch.linalg.eigh` (`solver="eigh"`);
  4. 1-D 2-means on the Fiedler embedding.

The Lanczos solve deflates the known null vector D^{1/2}·1, reports the
Paige residual of the selected Ritz pair against `ritz_tol`, and runs a short
probe from a second start vector in the complement of the explored space
(`missed_lower`); either failing marks the solve not-ok, and callers fall
back to the plain mean. See the JAX module for the full argument.

Every function takes a leading batch axis (one row per class, the JAX
package's `vmap`), or none.

For a CUDA tensor, everything after the Laplacian build of
`solver="lanczos"` (steps 3-4) is the hand-written kernel of
`csrc/spectral.cu`: one launch a call, no host synchronisation. The plain
version below runs for a CPU tensor, and for `solver="eigh"`. There is no
fallback from one to the other: a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from graphecho_torch.ops import cuda_build
from graphecho_torch.utils.profiling import annotate

_BIG_RITZ = 1e3  # dead Krylov slots are parked above the spectrum

# launches of the kernel entry point since the last `reset_launch_counts()`
LAUNCHES: Dict[str, int] = {"spectral": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    sq = (x * x).sum(-1)
    d = sq[:, :, None] - 2.0 * (x @ x.transpose(1, 2)) + sq[:, None, :]
    return d.clamp_min(0.0)


def _bdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x * y).sum(-1)


def _project_out(basis: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """w - basisᵀ (basis w) for basis (B, m, n), w (B, n)."""
    return w - torch.einsum("bmn,bm->bn", basis, torch.einsum("bmn,bn->bm", basis, w))


def _hash_vector(n: int, mul: float, add: float, scale: float,
                 like: torch.Tensor) -> torch.Tensor:
    """frac(sin(i·mul + add)·scale) − 0.5 in f32, the deterministic start
    vectors of the JAX package (`spectral.py:99-101,150-151`)."""
    i = torch.arange(n, dtype=like.dtype, device=like.device)
    x = torch.sin(i * mul + add) * scale
    return x - torch.floor(x) - 0.5


def _lanczos(lap, v0, q1, alive0, m: int, exclude: Optional[torch.Tensor] = None):
    """m Lanczos steps with full reorthogonalization against v0, the basis so
    far and `exclude`. Returns (basis (B, m, n), alphas, betas)."""
    bsz, n = q1.shape
    q_mat = q1.new_zeros(bsz, m, n)
    alphas = q1.new_full((bsz, m), _BIG_RITZ)
    betas = q1.new_zeros(bsz, m)
    q, q_prev = q1, torch.zeros_like(q1)
    beta_prev = q1.new_zeros(bsz)
    alive = alive0
    for j in range(m):
        q_mat[:, j] = q
        w = (lap @ q[:, :, None])[:, :, 0]
        alpha = _bdot(q, w)
        w = w - alpha[:, None] * q - beta_prev[:, None] * q_prev
        w = w - _bdot(v0, w)[:, None] * v0
        if exclude is not None:
            w = _project_out(exclude, w)
        w = _project_out(q_mat, w)
        beta = torch.linalg.vector_norm(w, dim=-1)
        next_alive = alive & (beta > 1e-6)
        alphas[:, j] = torch.where(alive, alpha, _BIG_RITZ)
        betas[:, j] = torch.where(next_alive, beta, 0.0)
        q_next = torch.where(next_alive[:, None], w / beta.clamp_min(1e-12)[:, None], 0.0)
        q_prev, q = q, q_next
        beta_prev = torch.where(next_alive, beta, 0.0)
        alive = next_alive
    return q_mat, alphas, betas


def _tridiag(alphas: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    off = betas[:, :-1]
    return (torch.diag_embed(alphas) + torch.diag_embed(off, 1)
            + torch.diag_embed(off, -1))


def _fiedler_lanczos(lap: torch.Tensor, deg: torch.Tensor, fvalid: torch.Tensor,
                     m: int = 24, probe_margin: float = 0.05
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fiedler vectors of (B, n, n) symmetric normalized Laplacians by m-step
    Lanczos with the analytic null vector deflated. Returns (fiedler (B, n),
    Paige residual (B,), missed_lower (B,) bool)."""
    n = lap.shape[-1]
    v0 = deg.clamp_min(0.0).sqrt() * fvalid
    v0 = v0 / torch.linalg.vector_norm(v0, dim=-1, keepdim=True).clamp_min(1e-12)

    x = _hash_vector(n, 12.9898, 78.233, 43758.5453, lap) * fvalid
    x = x - _bdot(v0, x)[:, None] * v0
    norm0 = torch.linalg.vector_norm(x, dim=-1)
    q1 = torch.where((norm0 > 1e-12)[:, None], x / norm0.clamp_min(1e-12)[:, None], 0.0)
    q_mat, alphas, betas = _lanczos(lap, v0, q1, norm0 > 1e-12, m)

    vals, s = torch.linalg.eigh(_tridiag(alphas, betas))
    residual = betas[:, m - 1].abs() * s[:, m - 1, 0].abs()
    theta = vals[:, 0]

    # probe: a short Lanczos run confined to the complement of the primary
    # basis; a Ritz value below theta there proves the primary solve missed
    # a lower eigenpair
    z = _hash_vector(n, 7.5625, 17.341, 24681.357, lap) * fvalid
    z = z - _bdot(v0, z)[:, None] * v0
    z = _project_out(q_mat, z)
    nz = torch.linalg.vector_norm(z, dim=-1)
    probe_live = nz > 1e-6
    z1 = torch.where(probe_live[:, None], z / nz.clamp_min(1e-12)[:, None], 0.0)
    _, alphas2, betas2 = _lanczos(lap, v0, z1, probe_live, 6, exclude=q_mat)
    theta2 = torch.linalg.eigh(_tridiag(alphas2, betas2))[0][:, 0]
    missed_lower = probe_live & (theta2 < theta - probe_margin)
    return torch.einsum("bmn,bm->bn", q_mat, s[:, :, 0]), residual, missed_lower


def _laplacian(points: torch.Tensor, valid: torch.Tensor, fvalid: torch.Tensor,
               k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lap (B, n, n), deg (B, n)): the symmetrized kNN graph's normalized
    Laplacian, invalid rows pushed up the spectrum."""
    n = points.shape[1]
    eye = torch.eye(n, dtype=torch.bool, device=points.device)
    pair_valid = valid[:, :, None] & valid[:, None, :]
    d = torch.where(pair_valid, _pairwise_sq_dists(points), 1e9)
    d = torch.where(eye, 1e9, d)  # exclude self from the kNN
    # rank-based kNN via a double stable argsort, as the JAX package does
    order = torch.argsort(d, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    a = ((rank < k[:, None, None]) & pair_valid).to(points.dtype)
    a = 0.5 * (a + a.transpose(1, 2))

    deg = a.sum(-1)
    inv_sqrt = torch.where(deg > 0, deg.clamp_min(1e-12).rsqrt(), 0.0)
    lap = eye.to(points.dtype) - inv_sqrt[:, :, None] * a * inv_sqrt[:, None, :]
    return lap + torch.diag_embed(10.0 * (1.0 - fvalid)), deg


def _two_means(fiedler: torch.Tensor, valid: torch.Tensor, iters: int) -> torch.Tensor:
    """1-D 2-means on the Fiedler values of the valid entries, from (min,
    max): (B, n) in {0, 1}, -1 on invalid rows."""
    vmin = torch.where(valid, fiedler, float("inf")).amin(-1)
    vmax = torch.where(valid, fiedler, float("-inf")).amax(-1)
    centers = torch.stack([vmin, vmax], dim=-1)
    for _ in range(iters):
        assign = (fiedler[:, :, None] - centers[:, None, :]).abs().argmin(-1)
        member = [(assign == c) & valid for c in (0, 1)]
        sums = torch.stack([torch.where(mb, fiedler, 0.0).sum(-1) for mb in member], -1)
        cnts = torch.stack([mb.to(fiedler.dtype).sum(-1) for mb in member], -1)
        centers = torch.where(cnts > 0, sums / cnts.clamp_min(1.0), centers)
    assign = (fiedler[:, :, None] - centers[:, None, :]).abs().argmin(-1)
    return torch.where(valid, assign, -1)


# -------------------------------------------------------------------- the kernel
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("spectral")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.spectral_bipartition.argtypes = [p, p, p, p, p, p, i, i, i, i, ctypes.c_float, p]
    lib.spectral_bipartition.restype = ctypes.c_int
    for name in ("spectral_max_n", "spectral_max_steps", "spectral_detail_width"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _limits() -> Tuple[int, int, int]:
    """(the most rows n, the most Lanczos steps m, the detail's width per row)
    of the kernel."""
    lib = _lib()
    return lib.spectral_max_n(), lib.spectral_max_steps(), lib.spectral_detail_width()


def launch_spectral(lap: torch.Tensor, deg: torch.Tensor, fvalid: torch.Tensor, m: int,
                    kmeans_iters: int = 10, ritz_tol: float = 0.05, detail: bool = False):
    """The kernel of `csrc/spectral.cu` on (B, n, n) Laplacians with their
    degrees and validity (B, n), all contiguous float32 on one card: m
    Lanczos steps, the probe, the Ritz vector and `kmeans_iters` rounds of
    2-means, in one launch on the current stream, with no synchronisation.
    Returns (assign (B, n) int64, -1 on invalid rows; solve_ok (B,) bool),
    as the plain path of `spectral_bipartition` does. With `detail`, also
    the Ritz vector (B, n) and, per row, (theta, residual, the probe's
    theta, probe live, missed lower, live steps) (B, 6) float32."""
    dev = lap.get_device()  # -1 on the CPU
    for t in (lap, deg, fvalid):
        if (dev < 0 or t.get_device() != dev or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError("the spectral kernel takes contiguous float32 tensors on one CUDA "
                             f"device, got {t.dtype} on {t.device} "
                             f"(contiguous={t.is_contiguous()})")
    if lap.dim() != 3 or lap.shape[1] != lap.shape[2] or deg.shape != lap.shape[:2] \
            or fvalid.shape != lap.shape[:2]:
        raise ValueError(f"shape mismatch: lap {tuple(lap.shape)}, deg {tuple(deg.shape)}, "
                         f"fvalid {tuple(fvalid.shape)}")
    b, n = deg.shape
    max_n, max_m, width = _limits()
    if not (1 <= n <= max_n and 1 <= m <= max_m and b >= 1 and kmeans_iters >= 0):
        raise ValueError(f"the spectral kernel takes 1 <= n <= {max_n}, 1 <= m <= {max_m}, "
                         f"B >= 1, kmeans_iters >= 0; got B={b}, n={n}, m={m}, "
                         f"kmeans_iters={kmeans_iters}")
    assign = torch.empty((b, n), dtype=torch.int64, device=lap.device)
    solve_ok = torch.empty(b, dtype=torch.bool, device=lap.device)
    extra = None
    if detail:
        extra = torch.empty((b, n + width), dtype=torch.float32, device=lap.device)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    err = _lib().spectral_bipartition(lap.data_ptr(), deg.data_ptr(), fvalid.data_ptr(),
                                      assign.data_ptr(), solve_ok.data_ptr(),
                                      None if extra is None else extra.data_ptr(), b, n, m,
                                      kmeans_iters, ritz_tol, stream)
    cuda_build.check(err, "spectral_bipartition")
    LAUNCHES["spectral"] += 1
    if detail:
        return assign, solve_ok, extra[:, :n], extra[:, n:]
    return assign, solve_ok


def spectral_bipartition(points: torch.Tensor, valid: torch.Tensor,
                         kmeans_iters: int = 10, solver: str = "lanczos",
                         k: Optional[torch.Tensor] = None,
                         with_quality: bool = False, ritz_tol: float = 0.05,
                         lanczos_steps: int = 24):
    """Split `points` ([B,] N, C) in two; returns ([B,] N) int in {0, 1}, with
    -1 on invalid rows. `k` is the kNN graph's neighbour count (default
    n_valid // 2). With `with_quality`, also a bool that is True when the
    Fiedler solve can be trusted (always for 'eigh')."""
    unbatched = points.dim() == 2
    if unbatched:
        points, valid = points[None], valid[None]
        k = None if k is None else torch.as_tensor(k, device=points.device).reshape(1)
    points = points.float()
    bsz, n, _ = points.shape
    fvalid = valid.to(points.dtype)
    if k is None:
        k = fvalid.sum(-1).to(torch.int64) // 2
    k = k.clamp_min(1)

    with annotate("step.gm.laplacian"):
        lap, deg = _laplacian(points, valid, fvalid, k)

    m = min(lanczos_steps, max(n - 1, 1))
    if solver == "lanczos" and points.is_cuda:
        # the solve and the 2-means in one kernel launch, no host sync
        with annotate("step.gm.fiedler"):
            assign, solve_ok = launch_spectral(lap, deg, fvalid.contiguous(), m, kmeans_iters,
                                               ritz_tol)
    else:
        # on a CUDA card `torch.linalg.eigh` synchronises the host with it:
        # once for "eigh", twice for "lanczos"
        with annotate("step.gm.fiedler"):
            if solver == "lanczos":
                fiedler, residual, missed_lower = _fiedler_lanczos(
                    lap, deg, fvalid, m=m, probe_margin=ritz_tol)
                solve_ok = (residual <= ritz_tol) & ~missed_lower
            elif solver == "eigh":
                fiedler = torch.linalg.eigh(lap)[1][:, :, 1]  # second-smallest
                solve_ok = torch.ones(bsz, dtype=torch.bool, device=points.device)
            else:
                raise ValueError(f"unknown spectral solver {solver!r}")
        with annotate("step.gm.kmeans"):
            assign = _two_means(fiedler, valid, kmeans_iters)
    if unbatched:
        assign, solve_ok = assign[0], solve_ok[0]
    return (assign, solve_ok) if with_quality else assign


def seed_consistent_mean(seed: torch.Tensor, nodes: torch.Tensor,
                         valid: torch.Tensor, solver: str = "lanczos",
                         lanczos_steps: int = 24
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster [seed; nodes] in two and average the nodes that land in the
    seed's cluster (reference `update_seed`, `graph_matching.py:539-545`).

    seed ([B,] C), nodes ([B,] N, C), valid ([B,] N). Returns (mean, ok):
    ok is False when the seed's cluster is empty or the Lanczos solve is not
    trusted, and the caller then takes the plain mean."""
    unbatched = seed.dim() == 1
    if unbatched:
        seed, nodes, valid = seed[None], nodes[None], valid[None]
    seed, nodes = seed.float(), nodes.float()
    pts = torch.cat([seed[:, None, :], nodes], dim=1)
    val = torch.cat([torch.ones_like(valid[:, :1]), valid], dim=1)
    # n_neighbors counts the class NODES only, not the prepended seed row
    k = valid.to(torch.int64).sum(-1) // 2
    assign, solve_ok = spectral_bipartition(pts, val, solver=solver, k=k,
                                            with_quality=True,
                                            lanczos_steps=lanczos_steps)
    keep = (assign[:, 1:] == assign[:, :1]) & valid
    cnt = keep.to(nodes.dtype).sum(-1)
    mean = torch.where(keep[:, :, None], nodes, 0.0).sum(1) / cnt.clamp_min(1.0)[:, None]
    ok = (cnt > 0) & solve_ok
    return (mean[0], ok[0]) if unbatched else (mean, ok)
