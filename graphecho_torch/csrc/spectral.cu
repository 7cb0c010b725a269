// The GModule's spectral seed split for Hopper (sm_90a): for each batch row
// (one class) of a symmetric normalized Laplacian L (n x n), the deflated
// Lanczos solve for its Fiedler vector and the 1-D 2-means on it, as
// graphecho_torch/ops/spectral.py computes them after the Laplacian build
// (`_fiedler_lanczos` and the 2-means loop of `spectral_bipartition`):
//
//   v0      = sqrt(max(deg, 0)) * valid, normalized (the null vector deflated)
//   q1      = the hash start vector, valid rows only, v0 projected out
//   m steps of Lanczos with full reorthogonalization (classical Gram-Schmidt
//           against v0 and the basis so far); a step whose beta <= 1e-6
//           ends the run, later slots are dead: alpha = 1e3, beta = 0
//   theta,s = the smallest eigenpair of the m x m tridiagonal matrix
//   residual= |beta_m| |s_m| (Paige)
//   probe   = 6 Lanczos steps from a second hash vector in the complement of
//           v0 and the primary basis; missed_lower when it is live (norm >
//           1e-6) and its smallest Ritz value lies below theta - ritz_tol
//   f       = the Ritz vector, sum_j s_j q_j
//   assign  = 2-means on f over the valid rows from (min, max), kmeans_iters
//           rounds, -1 on invalid rows; ok = residual <= ritz_tol and not
//           missed_lower
//
// It replaces no TPU kernel: the JAX package computes this in plain jnp
// under vmap (graphecho_tpu/ops/spectral.py), left to XLA. It was added
// because the plain PyTorch version issues ~660 small launches a call and
// two `torch.linalg.eigh` synchronisations at host pace, while the card
// waits (PERF.md, section 5).
//
// What bounds it on an H100: latency. The work is B x n^2 x ~30 multiply-adds
// (B = 5 classes, n = 113: ~2 MFLOP) on a Laplacian of B n^2 floats read once
// (255 KB: 0.08 us at 3.35 TB/s), but each Lanczos step needs the previous
// one, so one call is a chain of ~30 dependent matrix-vector products, each
// followed by a handful of block-wide reductions.
//
// What the design does about it:
//  * One block of 512 threads per batch row; one launch a call, no host
//    synchronisation and no scratch in device memory. L lives in shared
//    memory while it fits (n up to ~220 at the port's 24 steps; 51 KB at
//    n = 113), else it is read from L2 by the same code (the template flag
//    LAP_IN_SMEM, chosen on n by the entry point). The bases (m + 6 rows),
//    v0, w and f always live in shared memory.
//  * Matrix-vector products: a warp per 4 rows, lanes on consecutive columns,
//    each lane summing its columns in increasing order, then a butterfly of
//    shuffles. Dot products: each thread its elements, a warp butterfly, the
//    warps' partials summed in warp order by every thread. No atomics: the
//    order is fixed and two runs are bit-identical.
//  * The tridiagonal eigenpairs in float64 in one warp: 33-point Sturm
//    multisection for the smallest eigenvalue (all 32 lanes each count one
//    point), then inverse iteration with partial pivoting in one lane.
//    Everything else is float32, as the plain version computes it.
//  * The hash start vectors repeat the plain version's float32 operations one
//    by one (no fused multiply-add), since their scale of 4e4 magnifies a
//    rounding step into the third digit.
//
// Plain C interface, loaded with ctypes. The entry point launches one kernel
// on the given stream, allocates nothing, and returns a CUDA error code.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 4;           // rows of L a warp multiplies at once
constexpr int MAX_M = 64;         // Lanczos steps the kernel holds
constexpr int PROBE = 6;          // the probe's steps, as in the plain version
constexpr int MAX_N = 1024;       // rows a batch item may have
constexpr int DETAIL = 6;         // theta, residual, theta2, probe live, missed, live steps
constexpr int SECTIONS = 14;      // rounds of the 33-point multisection: 33^14 ~ 1.7e21
constexpr int INVERSE_ITERS = 3;
constexpr float BIG_RITZ = 1e3f;  // dead Krylov slots are parked above the spectrum

// shared memory, in this order: doubles, then floats
constexpr int N_DOUBLE = 8 * MAX_M;  // a, b^2, u0, u1, u2, l, y, pivots of the tridiagonal solves
// alphas, betas, the probe's alphas and betas, dot products, reductions,
// the Ritz vector's coefficients, scalars
constexpr int N_FIXED = 2 * MAX_M + 2 * 8 + MAX_M + 2 * WARPS * 4 + MAX_M + 16;

__host__ __device__ inline size_t smem_bytes(int n, int m, bool lap_in_smem) {
  const size_t floats = N_FIXED + (size_t)(3 + m + PROBE) * n +
                        (lap_in_smem ? (size_t)n * n : 0);
  return sizeof(double) * N_DOUBLE + sizeof(float) * floats;
}

__device__ __forceinline__ float warp_sum(float v) {
  // a butterfly: every lane ends with the same bits (addition commutes)
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums each of v[0..K) over the block; every thread gets the same bits. The
// two halves of `red` alternate, so one barrier a reduction is enough.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red, int& slot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  float* r = red + slot * (WARPS * 4);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) r[k * WARPS + warp] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
    for (int i = 0; i < WARPS; ++i) s += r[k * WARPS + i];
    v[k] = s;
  }
  slot ^= 1;
}

// The block's min and max of v: exact, so any order gives the same bits.
__device__ __forceinline__ void block_minmax(float& lo, float& hi, float* red, int& slot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  float* r = red + slot * (WARPS * 4);
  if (lane == 0) {
    r[warp] = lo;
    r[WARPS + warp] = hi;
  }
  __syncthreads();
  for (int i = 0; i < WARPS; ++i) {
    lo = fminf(lo, r[i]);
    hi = fmaxf(hi, r[WARPS + i]);
  }
  slot ^= 1;
}

// frac(sin(i * mul + add) * scale) - 0.5, each operation rounded as the
// plain version's separate float32 tensor operations round it
__device__ __forceinline__ float hash_value(int i, float mul, float add, float scale) {
  const float x = __fmul_rn(sinf(__fadd_rn(__fmul_rn(static_cast<float>(i), mul), add)), scale);
  return __fsub_rn(__fsub_rn(x, floorf(x)), 0.5f);
}

// w = L q: a warp per ROWS rows, lanes over the columns in increasing order
__device__ __forceinline__ void matvec(const float* __restrict__ lap, const float* q, float* w,
                                       int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r0 = warp * ROWS; r0 < n; r0 += WARPS * ROWS) {
    float acc[ROWS];
#pragma unroll
    for (int t = 0; t < ROWS; ++t) acc[t] = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float qj = q[j];
#pragma unroll
      for (int t = 0; t < ROWS; ++t) {
        if (r0 + t < n) acc[t] += lap[(size_t)(r0 + t) * n + j] * qj;
      }
    }
#pragma unroll
    for (int t = 0; t < ROWS; ++t) acc[t] = warp_sum(acc[t]);
    if (lane == 0) {
#pragma unroll
      for (int t = 0; t < ROWS; ++t) {
        if (r0 + t < n) w[r0 + t] = acc[t];
      }
    }
  }
}

// w -= basis^T (basis w) over `rows` rows of the basis (classical
// Gram-Schmidt, as the plain version's `_project_out`); barriers on both
// sides of the subtraction
__device__ __forceinline__ void project_out(const float* basis, int rows, float* w, float* coef,
                                            int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += WARPS) {
    float acc = 0.f;
    for (int j = lane; j < n; j += 32) acc += basis[r * n + j] * w[j];
    acc = warp_sum(acc);
    if (lane == 0) coef[r] = acc;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += THREADS) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += coef[r] * basis[r * n + k];
    w[k] -= s;
  }
  __syncthreads();
}

// `steps` Lanczos steps from the unit vector in basis row 0, each row of
// the basis written before the step that multiplies it; `exclude` (rows of
// another basis, or null) is projected out too. Writes alpha and beta of
// every step (dead slots: BIG_RITZ and 0) and returns the live steps.
__device__ int lanczos(const float* __restrict__ lap, const float* v0, float* basis, int steps,
                       const float* exclude, int exclude_rows, bool alive, float* alphas,
                       float* betas, float* w, float* coef, float* red, int& slot, int n) {
  float beta_prev = 0.f;
  int live = 0;
  for (int j = 0; j < steps; ++j) {
    const float* q = basis + j * n;
    const float* q_prev = basis + (j > 0 ? j - 1 : 0) * n;
    matvec(lap, q, w, n);
    __syncthreads();
    float v[1] = {0.f};
    for (int k = threadIdx.x; k < n; k += THREADS) v[0] += q[k] * w[k];
    block_sum(v, red, slot);
    const float alpha = v[0];
    float u[1] = {0.f};
    for (int k = threadIdx.x; k < n; k += THREADS) {
      const float x = (w[k] - alpha * q[k]) - beta_prev * (j > 0 ? q_prev[k] : 0.f);
      w[k] = x;
      u[0] += v0[k] * x;
    }
    block_sum(u, red, slot);
    for (int k = threadIdx.x; k < n; k += THREADS) w[k] -= u[0] * v0[k];
    __syncthreads();
    if (exclude != nullptr) project_out(exclude, exclude_rows, w, coef, n);
    project_out(basis, j + 1, w, coef, n);
    float s2[1] = {0.f};
    for (int k = threadIdx.x; k < n; k += THREADS) s2[0] += w[k] * w[k];
    block_sum(s2, red, slot);
    const float beta = sqrtf(s2[0]);
    const bool next = alive && beta > 1e-6f;
    if (threadIdx.x == 0) {
      alphas[j] = alive ? alpha : BIG_RITZ;
      betas[j] = next ? beta : 0.f;
    }
    live += alive ? 1 : 0;
    if (j + 1 < steps) {
      const float scale = fmaxf(beta, 1e-12f);
      for (int k = threadIdx.x; k < n; k += THREADS) {
        basis[(j + 1) * n + k] = next ? w[k] / scale : 0.f;
      }
    }
    beta_prev = next ? beta : 0.f;
    alive = next;
    __syncthreads();  // the next row and this step's alpha, beta are written
  }
  return live;
}

// Number of eigenvalues of the tridiagonal (a, b) at or below x (Sturm
// sequence; LAPACK's dlaebz rule for a pivot near 0).
__device__ __forceinline__ int count_below(const double* a, const double* b2, int m, double x) {
  constexpr double PIVMIN = 1e-290;
  int count = 0;
  double d = a[0] - x;
  if (fabs(d) < PIVMIN) d = -PIVMIN;
  count += d <= 0.0;
  for (int i = 1; i < m; ++i) {
    d = (a[i] - x) - b2[i - 1] / d;
    if (fabs(d) < PIVMIN) d = -PIVMIN;
    count += d <= 0.0;
  }
  return count;
}

// The smallest eigenvalue of the m x m tridiagonal matrix with diagonal
// `alphas` and off-diagonal `betas` [0, m-1), in float64, by warp 0; with
// `s` non-null also its unit eigenvector in float32 (lane 0, inverse
// iteration). `dbl` holds N_DOUBLE doubles of scratch.
__device__ double smallest_eigenpair(const float* alphas, const float* betas, int m, double* dbl,
                                     float* s) {
  const int lane = threadIdx.x & 31;
  double* a = dbl;
  double* b2 = dbl + MAX_M;
  for (int i = lane; i < m; i += 32) {
    a[i] = alphas[i];
    const double b = i + 1 < m ? static_cast<double>(betas[i]) : 0.0;
    b2[i] = b * b;
  }
  __syncwarp();
  double lo = INFINITY, hi = -INFINITY;
  for (int i = 0; i < m; ++i) {
    const double r = (i > 0 ? fabs(static_cast<double>(betas[i - 1])) : 0.0) +
                     (i + 1 < m ? fabs(static_cast<double>(betas[i])) : 0.0);
    lo = fmin(lo, a[i] - r);
    hi = fmax(hi, a[i] + r);
  }
  const double norm = fmax(fabs(lo), fabs(hi));
  for (int it = 0; it < SECTIONS; ++it) {
    const double step = (hi - lo) / 33.0;
    const int below = count_below(a, b2, m, lo + step * (lane + 1));
    const unsigned mask = __ballot_sync(0xffffffffu, below >= 1);
    const int first = mask ? __ffs(mask) - 1 : 32;
    const double new_lo = lo + step * first;
    hi = first < 32 ? lo + step * (first + 1) : hi;
    lo = new_lo;
  }
  const double theta = 0.5 * (lo + hi);
  if (s != nullptr && lane == 0) {
    // inverse iteration on T - theta I: LU with partial pivoting of the
    // tridiagonal (U has two superdiagonals), pivots kept off 0
    double* u0 = dbl + 2 * MAX_M;
    double* u1 = dbl + 3 * MAX_M;
    double* u2 = dbl + 4 * MAX_M;
    double* l = dbl + 5 * MAX_M;
    double* y = dbl + 6 * MAX_M;
    double* piv = dbl + 7 * MAX_M;
    const double tiny = 2.220446049250313e-16 * fmax(norm, 1e-300);
    auto floor_pivot = [tiny](double p) { return fabs(p) < tiny ? (p < 0 ? -tiny : tiny) : p; };
    double p0 = a[0] - theta;
    double p1 = m > 1 ? static_cast<double>(betas[0]) : 0.0;
    for (int i = 0; i + 1 < m; ++i) {
      const double sub = betas[i];
      const double nd = a[i + 1] - theta;
      const double nb = i + 2 < m ? static_cast<double>(betas[i + 1]) : 0.0;
      if (fabs(p0) >= fabs(sub)) {
        p0 = floor_pivot(p0);
        l[i] = sub / p0;
        u0[i] = p0;
        u1[i] = p1;
        u2[i] = 0.0;
        piv[i] = 0.0;
        p0 = nd - l[i] * p1;
        p1 = nb;
      } else {
        l[i] = p0 / sub;
        u0[i] = sub;
        u1[i] = nd;
        u2[i] = nb;
        piv[i] = 1.0;
        p0 = p1 - l[i] * nd;
        p1 = -l[i] * nb;
      }
    }
    u0[m - 1] = floor_pivot(p0);
    for (int i = 0; i < m; ++i) y[i] = 1.0;
    for (int it = 0; it < INVERSE_ITERS; ++it) {
      for (int i = 0; i + 1 < m; ++i) {
        if (piv[i] != 0.0) {
          const double t = y[i];
          y[i] = y[i + 1];
          y[i + 1] = t;
        }
        y[i + 1] -= l[i] * y[i];
      }
      for (int i = m - 1; i >= 0; --i) {
        double t = y[i];
        if (i + 1 < m) t -= u1[i] * y[i + 1];
        if (i + 2 < m) t -= u2[i] * y[i + 2];
        y[i] = t / u0[i];
      }
      double big = 0.0;
      for (int i = 0; i < m; ++i) big = fmax(big, fabs(y[i]));
      double ss = 0.0;
      for (int i = 0; i < m; ++i) {
        y[i] /= big;
        ss += y[i] * y[i];
      }
      const double inv = 1.0 / sqrt(ss);
      for (int i = 0; i < m; ++i) y[i] *= inv;
    }
    for (int i = 0; i < m; ++i) s[i] = static_cast<float>(y[i]);
  }
  __syncwarp();
  return theta;
}

template <bool LAP_IN_SMEM>
__global__ void __launch_bounds__(THREADS)
    spectral_bipartition_kernel(const float* __restrict__ lap_g, const float* __restrict__ deg,
                                const float* __restrict__ fvalid, long long* __restrict__ assign,
                                unsigned char* __restrict__ ok, float* __restrict__ detail, int n,
                                int m, int kmeans_iters, float ritz_tol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* dbl = reinterpret_cast<double*>(smem_raw);
  float* fl = reinterpret_cast<float*>(dbl + N_DOUBLE);
  float* alphas = fl;                 // MAX_M
  float* betas = alphas + MAX_M;      // MAX_M
  float* alphas2 = betas + MAX_M;     // 8
  float* betas2 = alphas2 + 8;        // 8
  float* coef = betas2 + 8;           // MAX_M
  float* red = coef + MAX_M;          // 2 * WARPS * 4
  float* sf = red + 2 * WARPS * 4;    // MAX_M: the Ritz vector's coefficients
  float* scal = sf + MAX_M;           // 16
  float* v0 = scal + 16;
  float* w = v0 + n;
  float* f = w + n;
  float* qb = f + n;                  // m rows: the primary basis
  float* pb = qb + (size_t)m * n;     // PROBE rows: the probe's basis
  float* lap_s = pb + (size_t)PROBE * n;

  const int row = blockIdx.x;
  const float* lap_row = lap_g + (size_t)row * n * n;
  const float* dg = deg + (size_t)row * n;
  const float* fv = fvalid + (size_t)row * n;
  int slot = 0;

  if (LAP_IN_SMEM) {
    for (int i = threadIdx.x; i < n * n; i += THREADS) lap_s[i] = lap_row[i];
  }
  const float* lap = LAP_IN_SMEM ? lap_s : lap_row;

  // v0: the analytic null vector, normalized
  {
    float v[1] = {0.f};
    for (int k = threadIdx.x; k < n; k += THREADS) {
      const float x = sqrtf(fmaxf(dg[k], 0.f)) * fv[k];
      v0[k] = x;
      v[0] += x * x;
    }
    block_sum(v, red, slot);
    const float norm = fmaxf(sqrtf(v[0]), 1e-12f);
    for (int k = threadIdx.x; k < n; k += THREADS) v0[k] = v0[k] / norm;
  }
  __syncthreads();

  // the primary start vector
  bool alive;
  {
    float v[1] = {0.f};
    for (int k = threadIdx.x; k < n; k += THREADS) {
      const float x = hash_value(k, 12.9898f, 78.233f, 43758.5453f) * fv[k];
      w[k] = x;
      v[0] += v0[k] * x;
    }
    block_sum(v, red, slot);
    float u[1] = {0.f};
    for (int k = threadIdx.x; k < n; k += THREADS) {
      const float x = w[k] - v[0] * v0[k];
      w[k] = x;
      u[0] += x * x;
    }
    block_sum(u, red, slot);
    const float norm0 = sqrtf(u[0]);
    alive = norm0 > 1e-12f;
    const float scale = fmaxf(norm0, 1e-12f);
    for (int k = threadIdx.x; k < n; k += THREADS) qb[k] = alive ? w[k] / scale : 0.f;
  }
  __syncthreads();
  const int live = lanczos(lap, v0, qb, m, nullptr, 0, alive, alphas, betas, w, coef, red, slot, n);

  // the smallest Ritz pair and the Paige residual
  if (threadIdx.x < 32) {
    const double theta = smallest_eigenpair(alphas, betas, m, dbl, sf);
    if (threadIdx.x == 0) {
      scal[0] = static_cast<float>(theta);
      scal[1] = fabsf(betas[m - 1]) * fabsf(sf[m - 1]);
    }
  }
  __syncthreads();

  // the probe: a second start in the complement of v0 and the primary basis
  bool probe_live;
  {
    float v[1] = {0.f};
    for (int k = threadIdx.x; k < n; k += THREADS) {
      const float z = hash_value(k, 7.5625f, 17.341f, 24681.357f) * fv[k];
      w[k] = z;
      v[0] += v0[k] * z;
    }
    block_sum(v, red, slot);
    for (int k = threadIdx.x; k < n; k += THREADS) w[k] -= v[0] * v0[k];
    __syncthreads();
    project_out(qb, m, w, coef, n);
    float u[1] = {0.f};
    for (int k = threadIdx.x; k < n; k += THREADS) u[0] += w[k] * w[k];
    block_sum(u, red, slot);
    const float nz = sqrtf(u[0]);
    probe_live = nz > 1e-6f;
    const float scale = fmaxf(nz, 1e-12f);
    for (int k = threadIdx.x; k < n; k += THREADS) pb[k] = probe_live ? w[k] / scale : 0.f;
  }
  __syncthreads();
  lanczos(lap, v0, pb, PROBE, qb, m, probe_live, alphas2, betas2, w, coef, red, slot, n);
  if (threadIdx.x < 32) {
    const double theta2 = smallest_eigenpair(alphas2, betas2, PROBE, dbl, nullptr);
    if (threadIdx.x == 0) scal[2] = static_cast<float>(theta2);
  }
  __syncthreads();
  const float theta = scal[0], residual = scal[1], theta2 = scal[2];
  const bool missed = probe_live && theta2 < theta - ritz_tol;
  const bool solve_ok = residual <= ritz_tol && !missed;

  // the Ritz vector and the 2-means on it, from (min, max) of the valid rows
  float lo = INFINITY, hi = -INFINITY;
  for (int k = threadIdx.x; k < n; k += THREADS) {
    float x = 0.f;
    for (int j = 0; j < m; ++j) x += sf[j] * qb[j * n + k];
    f[k] = x;
    if (fv[k] != 0.f) {
      lo = fminf(lo, x);
      hi = fmaxf(hi, x);
    }
  }
  block_minmax(lo, hi, red, slot);
  float c0 = lo, c1 = hi;
  for (int it = 0; it < kmeans_iters; ++it) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};  // sum 0, sum 1, count 0, count 1
    for (int k = threadIdx.x; k < n; k += THREADS) {
      if (fv[k] == 0.f) continue;
      const float x = f[k];
      if (fabsf(x - c1) < fabsf(x - c0)) {  // ties and NaN to 0, as argmin
        v[1] += x;
        v[3] += 1.f;
      } else {
        v[0] += x;
        v[2] += 1.f;
      }
    }
    block_sum(v, red, slot);
    c0 = v[2] > 0.f ? v[0] / fmaxf(v[2], 1.f) : c0;
    c1 = v[3] > 0.f ? v[1] / fmaxf(v[3], 1.f) : c1;
  }
  long long* out = assign + (size_t)row * n;
  for (int k = threadIdx.x; k < n; k += THREADS) {
    const float x = f[k];
    out[k] = fv[k] == 0.f ? -1 : (fabsf(x - c1) < fabsf(x - c0) ? 1 : 0);
  }
  if (threadIdx.x == 0) ok[row] = solve_ok ? 1 : 0;
  if (detail != nullptr) {
    float* d = detail + (size_t)row * (n + DETAIL);
    for (int k = threadIdx.x; k < n; k += THREADS) d[k] = f[k];
    if (threadIdx.x == 0) {
      d[n] = theta;
      d[n + 1] = residual;
      d[n + 2] = theta2;
      d[n + 3] = probe_live ? 1.f : 0.f;
      d[n + 4] = missed ? 1.f : 0.f;
      d[n + 5] = static_cast<float>(live);
    }
  }
}

constexpr int MAX_DEVICES = 64;

template <bool LAP_IN_SMEM>
int launch(const float* lap, const float* deg, const float* fvalid, long long* assign,
           unsigned char* ok, float* detail, int b, int n, int m, int kmeans_iters,
           float ritz_tol, int dev, cudaStream_t stream) {
  const size_t smem = smem_bytes(n, m, LAP_IN_SMEM);
  static size_t granted[MAX_DEVICES] = {};  // shared memory granted per device, host side
  if (smem > 48 * 1024 && (dev >= MAX_DEVICES || smem > granted[dev])) {
    const cudaError_t err = cudaFuncSetAttribute(spectral_bipartition_kernel<LAP_IN_SMEM>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < MAX_DEVICES) granted[dev] = smem;
  }
  spectral_bipartition_kernel<LAP_IN_SMEM><<<b, THREADS, smem, stream>>>(
      lap, deg, fvalid, assign, ok, detail, n, m, kmeans_iters, ritz_tol);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int spectral_max_n() { return MAX_N; }

int spectral_max_steps() { return MAX_M; }

int spectral_detail_width() { return DETAIL; }

// lap (b, n, n), deg and fvalid (b, n) float32; assign (b, n) int64, ok (b,)
// bytes; detail null or (b, n + DETAIL) float32: the Ritz vector, then theta,
// the residual, the probe's theta, probe live, missed lower, live steps.
int spectral_bipartition(const float* lap, const float* deg, const float* fvalid,
                         long long* assign, unsigned char* ok, float* detail, int b, int n, int m,
                         int kmeans_iters, float ritz_tol, void* stream) {
  if (b < 1 || n < 1 || n > MAX_N || m < 1 || m > MAX_M || kmeans_iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  static int optin[MAX_DEVICES] = {};
  int limit = dev < MAX_DEVICES ? optin[dev] : 0;
  if (limit == 0) {
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < MAX_DEVICES) optin[dev] = limit;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the Laplacian in shared memory while it fits, else read from L2
  if (smem_bytes(n, m, true) <= static_cast<size_t>(limit)) {
    return launch<true>(lap, deg, fvalid, assign, ok, detail, b, n, m, kmeans_iters, ritz_tol,
                        dev, s);
  }
  if (smem_bytes(n, m, false) <= static_cast<size_t>(limit)) {
    return launch<false>(lap, deg, fvalid, assign, ok, detail, b, n, m, kmeans_iters, ritz_tol,
                         dev, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
