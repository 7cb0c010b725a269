// Fused kNN graph for Hopper (sm_90a): for every query row q of x and every
// key row k of y (y = x for a self graph),
//
//   q, k   <- q / max(|q|, 1e-12), k / max(|k|, 1e-12)     (if normalize)
//   d[q,k]  = |q|^2 - 2 q.k + |k|^2  (+ relative_pos[q,k])
//   out[q]  = the k_sel columns of smallest d, ascending, ties to the lowest column
//
// Replaces the Pallas TPU kernel graphecho_tpu/ops/pallas/knn_kernel.py
// (`_knn_kernel`, launched by `pallas_knn`). Pallas normalizes by
// x * rsqrt(max(sum x^2, 1e-24)); here a row is multiplied by
// 1 / max(sqrt(sum x^2), 1e-12), computed once per row. Both are the plain
// version's `F.normalize` up to rounding.
//
// What bounds it on an H100: operations. The distance products are 2*N*M*C
// per batch item against (N + M)*C inputs; at the ViG widths (C = 80..640,
// M = 196) that is far above the card's ridge point, so the FP32 CUDA-core
// rate (67 TFLOP/s) sets the floor. Only at the last pvig stage (N = M = 49,
// C = 640) do the bytes come close to it. The products may not go to the
// tensor cores: TF32 rounds the distances far enough to reorder near-tied
// neighbours.
//
// What the design does about it:
//  * The (N, M) distance matrix never reaches device memory; the plain
//    version writes it and sorts every row of it. One block owns BQ queries
//    of one batch item and walks over the keys in tiles of BK, staging
//    BQ x CC and BK x CC slices of the normalized rows in shared memory for
//    each CC-wide chunk of C, so C is not limited. The next chunk's loads are
//    in flight while the current one is multiplied. Each thread keeps a 4 x 4
//    block of dot products in registers and reads 4 queries and 4 keys as one
//    16-byte load each: 16 FMAs per 2 shared loads.
//  * The distance is formed as (q_sq - 2*dot) + k_sq, then + relative_pos,
//    the plain version's order of operations.
//  * Selection keeps a sorted k-best list per query. After each key tile a
//    warp takes one query at a time, holds its list across the lanes, and
//    merges the tile's keys with ballots and shuffles: the keys below the
//    current k-th distance enter in increasing column order, each after every
//    entry that is not greater. Ties thus keep the lowest column, the order
//    of `jax.lax.top_k` on -d and of a stable sort.
//  * Ragged N, M and C are masked (zeros in the products, +inf distances for
//    missing keys), never padded. No atomics: repeated runs are bit-identical.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// given stream, allocates nothing, and returns a CUDA error code.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BQ = 64;          // queries per block
constexpr int BK = 64;          // keys per tile
constexpr int CC = 32;          // channels per staged chunk
constexpr int TX = 16;          // threads along the keys of a tile, 4 keys each
constexpr int TY = 16;          // threads along the queries of a tile, 4 queries each
constexpr int THREADS = TX * TY;
constexpr int WARPS = THREADS / 32;
constexpr int QP = BQ + 4;      // padded rows of the staged tiles (16-byte aligned)
constexpr int KP = BK + 4;
constexpr int LOADS = BQ * CC / THREADS;  // staged values per thread and chunk (= BK * CC / THREADS)
constexpr int MAX_K = 64;       // largest k the k-best lists take (two entries per lane)
// q_s[CC][QP] and k_s[CC][KP] while the products run, then dist_s[BQ][KP]
constexpr int TILE_FLOATS = (CC * QP + CC * KP) > (BQ * KP) ? (CC * QP + CC * KP) : (BQ * KP);
constexpr int STATS_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

static_assert(BQ * CC == BK * CC && BQ * CC % THREADS == 0, "tile loads split evenly");

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// One warp per row: the factor that normalizes the row, 1 / max(|row|, 1e-12)
// (1 without normalization), and the squared norm of the normalized row.
__global__ void row_stats_kernel(const float* __restrict__ v, float* __restrict__ scale,
                                 float* __restrict__ sq, int rows, int c, int normalize) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // uniform across the warp
  const float* r = v + (size_t)row * c;
  float s = 0.f;
  for (int i = lane; i < c; i += 32) s = fmaf(r[i], r[i], s);
  s = warp_sum(s);
  const float f = normalize ? 1.f / fmaxf(sqrtf(s), 1e-12f) : 1.f;
  float s2 = 0.f;
  for (int i = lane; i < c; i += 32) {
    const float t = r[i] * f;
    s2 = fmaf(t, t, s2);
  }
  s2 = warp_sum(s2);
  if (lane == 0) {
    scale[row] = f;
    sq[row] = s2;
  }
}

// Rows [r0, r0 + BQ) of a (rows, c) matrix, channels [c0, c0 + CC), times the
// row's scale, into registers: value i of thread t is row (t + i*THREADS) / CC.
__device__ __forceinline__ void load_chunk(const float* __restrict__ v,
                                           const float* __restrict__ scale, int rows, int c,
                                           int r0, int c0, float (&reg)[LOADS]) {
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = r0 + e / CC, ch = c0 + e % CC;
    reg[i] = (r < rows && ch < c) ? v[(size_t)r * c + ch] * scale[r] : 0.f;
  }
}

__device__ __forceinline__ void store_chunk(float* __restrict__ tile, int pitch,
                                            const float (&reg)[LOADS]) {
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    tile[(e % CC) * pitch + e / CC] = reg[i];
  }
}

__global__ void __launch_bounds__(THREADS, 3)  // 3 blocks per SM: 80 registers, no spills
knn_kernel(const float* __restrict__ x, const float* __restrict__ y,
           const float* __restrict__ rel, const float* __restrict__ x_scale,
           const float* __restrict__ x_sq, const float* __restrict__ y_scale,
           const float* __restrict__ y_sq, int* __restrict__ out, int n, int m, int c, int k,
           int rel_batched) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* q_s = smem;
  float* k_s = smem + CC * QP;
  float* dist_s = smem;  // aliases q_s/k_s once the products of a tile are done
  float* best_d = smem + TILE_FLOATS;                     // [BQ][k]
  int* best_i = reinterpret_cast<int*>(best_d + k * BQ);  // [BQ][k]

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int lane = tid % 32, warp = tid / 32;
  const float* xb = x + (size_t)b * n * c;
  const float* yb = y + (size_t)b * m * c;
  const float* xsb = x_scale + (size_t)b * n;
  const float* ysb = y_scale + (size_t)b * m;
  const float* relb = rel == nullptr ? nullptr : rel + (rel_batched ? (size_t)b * n * m : 0);

  for (int e = tid; e < k * BQ; e += THREADS) {
    best_d[e] = CUDART_INF_F;
    best_i[e] = -1;
  }
  float qsq[4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int qi = q0 + ty * 4 + ii;
    qsq[ii] = qi < n ? x_sq[(size_t)b * n + qi] : 0.f;
  }

  const int chunks = (c + CC - 1) / CC;
  const int steps = ((m + BK - 1) / BK) * chunks;
  float q_reg[LOADS], k_reg[LOADS];
  load_chunk(xb, xsb, n, c, q0, 0, q_reg);
  load_chunk(yb, ysb, m, c, 0, 0, k_reg);
  float acc[4][4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = 0.f;

  for (int step = 0; step < steps; ++step) {
    const int j0 = (step / chunks) * BK;
    __syncthreads();  // the last readers of this region (products or selection) are done
    store_chunk(q_s, QP, q_reg);
    store_chunk(k_s, KP, k_reg);
    __syncthreads();
    if (step + 1 < steps) {  // the next chunk's loads overlap this chunk's products
      const int nj0 = ((step + 1) / chunks) * BK, nc0 = ((step + 1) % chunks) * CC;
      load_chunk(xb, xsb, n, c, q0, nc0, q_reg);
      load_chunk(yb, ysb, m, c, nj0, nc0, k_reg);
    }
#pragma unroll 8
    for (int cc = 0; cc < CC; ++cc) {
      const float4 qv = *reinterpret_cast<const float4*>(q_s + cc * QP + ty * 4);
      const float4 kv = *reinterpret_cast<const float4*>(k_s + cc * KP + tx * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = fmaf(qa[ii], ka[jj], acc[ii][jj]);
    }
    if ((step + 1) % chunks != 0) continue;

    // the key tile is complete: distances into dist_s, then the k-best lists
    __syncthreads();  // every thread is done with q_s/k_s: the region becomes dist_s
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int r = ty * 4 + ii, qi = q0 + r;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = tx * 4 + jj, kj = j0 + col;
        float d = CUDART_INF_F;
        if (qi < n && kj < m) {
          d = (qsq[ii] - 2.f * acc[ii][jj]) + y_sq[(size_t)b * m + kj];
          if (relb != nullptr) d += relb[(size_t)qi * m + kj];
        }
        dist_s[r * KP + col] = d;
        acc[ii][jj] = 0.f;
      }
    }
    __syncthreads();
    // One warp per query merges the tile into the query's sorted list, held
    // across the lanes while it is merged: entry p in lane p % 32, register
    // p / 32. Candidates below the k-th distance are taken in column order;
    // each goes after every entry that is not greater.
    for (int q = warp; q < BQ && q0 + q < n; q += WARPS) {
      float* bd = best_d + q * k;
      int* bi = best_i + q * k;
      float l0 = lane < k ? bd[lane] : CUDART_INF_F;
      int i0 = lane < k ? bi[lane] : -1;
      float l1 = lane + 32 < k ? bd[lane + 32] : CUDART_INF_F;
      int i1 = lane + 32 < k ? bi[lane + 32] : -1;
      float worst = __shfl_sync(FULL, k <= 32 ? l0 : l1, (k - 1) % 32);
      const float d0 = lane < BK ? dist_s[q * KP + lane] : CUDART_INF_F;
      const float d1 = lane + 32 < BK ? dist_s[q * KP + lane + 32] : CUDART_INF_F;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float dh = half ? d1 : d0;
        unsigned pending = __ballot_sync(FULL, dh < worst);
        while (pending != 0u) {
          const int src = __ffs(pending) - 1;
          pending &= pending - 1;
          const float d = __shfl_sync(FULL, dh, src);
          if (!(d < worst)) continue;  // uniform: the list moved since the ballot
          const int col = j0 + half * 32 + src;
          const int pos = __popc(__ballot_sync(FULL, l0 <= d)) +
                          __popc(__ballot_sync(FULL, l1 <= d));
          const float up0 = __shfl_up_sync(FULL, l0, 1);
          const int up0i = __shfl_up_sync(FULL, i0, 1);
          const float up1 = __shfl_up_sync(FULL, l1, 1);
          const int up1i = __shfl_up_sync(FULL, i1, 1);
          const float carry = __shfl_sync(FULL, l0, 31);
          const int carryi = __shfl_sync(FULL, i0, 31);
          if (lane == pos) {
            l0 = d;
            i0 = col;
          } else if (lane > pos) {
            l0 = up0;
            i0 = up0i;
          }
          if (lane + 32 == pos) {
            l1 = d;
            i1 = col;
          } else if (lane + 32 > pos) {
            l1 = lane == 0 ? carry : up1;
            i1 = lane == 0 ? carryi : up1i;
          }
          worst = __shfl_sync(FULL, k <= 32 ? l0 : l1, (k - 1) % 32);
        }
      }
      if (lane < k) {
        bd[lane] = l0;
        bi[lane] = i0;
      }
      if (lane + 32 < k) {
        bd[lane + 32] = l1;
        bi[lane + 32] = i1;
      }
    }
  }
  __syncthreads();
  // the block's rows of `out` are contiguous
  for (int e = tid; e < BQ * k; e += THREADS) {
    if (q0 + e / k < n) out[((size_t)b * n + q0) * k + e] = best_i[e];
  }
}

}  // namespace

extern "C" {

int knn_max_k() { return MAX_K; }

// x (b, n, c), y (b, m, c) and rel (rel_batch, n, m) with rel_batch 0 (no
// bias), 1 or b; out (b, n, k) int32; scratch holds 2*b*(n + m) floats.
int knn(const float* x, const float* y, const float* rel, int* out, float* scratch, int b,
        int n, int m, int c, int k, int rel_batch, int normalize, void* stream) {
  if (k < 1 || k > MAX_K || k > m || n < 1 || c < 1 || b < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* x_scale = scratch;
  float* x_sq = x_scale + (size_t)b * n;
  float* y_scale = x_sq + (size_t)b * n;
  float* y_sq = y_scale + (size_t)b * m;
  const int warps_per_block = STATS_THREADS / 32;
  const int xrows = b * n, yrows = b * m;
  row_stats_kernel<<<(xrows + warps_per_block - 1) / warps_per_block, STATS_THREADS, 0, s>>>(
      x, x_scale, x_sq, xrows, c, normalize);
  row_stats_kernel<<<(yrows + warps_per_block - 1) / warps_per_block, STATS_THREADS, 0, s>>>(
      y, y_scale, y_sq, yrows, c, normalize);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t smem = sizeof(float) * TILE_FLOATS + (sizeof(float) + sizeof(int)) * (size_t)k * BQ;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + BQ - 1) / BQ, b);
  knn_kernel<<<grid, THREADS, smem, s>>>(x, y, rel_batch ? rel : nullptr, x_scale, x_sq,
                                         y_scale, y_sq, out, n, m, c, k, rel_batch > 1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
