// Fused pairwise-MLP affinity, forward and backward, for Hopper (sm_90a).
//
//   M[i,j]  = sum_k w2[k] * relu(a[i,k] + b[j,k])          (+ b2 outside)
//   dA[i,k] = w2[k] * S_A[i,k],   S_A[i,k] = sum_j g[i,j] * 1[a_ik + b_jk > 0]
//   dB[j,k] = w2[k] * S_B[j,k],   S_B[j,k] = sum_i g[i,j] * 1[a_ik + b_jk > 0]
//   dw2[k]  = sum_ij g[i,j] * relu(a_ik + b_jk)
//           = sum_i a_ik * S_A[i,k] + sum_j b_jk * S_B[j,k]   (relu(t) = t * 1[t > 0])
//   db2     = sum_ij g[i,j]
//
// Replaces the Pallas TPU kernels of
// graphecho_tpu/ops/pallas/pairwise_mlp_kernel.py: `_fwd_kernel` (via
// `_forward`) with `fwd_kernel`, and both `_bwd_da_kernel` and
// `_bwd_db_kernel` (via `_backward`) with the one backward entry point
// `pairwise_mlp_bwd`: `pairwise_bwd_kernel`, then `pairwise_finish_kernel`.
//
// What bounds the backward on an H100: FP32 operations that cannot use the
// tensor cores. Each (i, j, k) needs an add, a comparison and one
// accumulation each into S_A and S_B: 4 * N1 * N2 * K = 642 Mop at the
// cardiac shape (560 x 560 x 512) against a few MB of inputs, far above the
// card's ridge point. The comparison sits between the add and the sums, so no
// part of it is a matrix product, and adds and comparisons run at one per lane
// per clock: half the FMA-counted 67 TFLOP/s. Here a triple costs three instruction
// slots: the compiler folds a + b > 0 into one comparison a > -b (exact:
// rounding never changes the sign of a sum) and adds g into S_A and S_B under
// its predicate. So the floor is 3 * 160.6 M / (132 SMs * 128 lanes *
// 1.98 GHz) = 14 us at 560^2.
//
// What the design does about it:
//  * Register tiles. A block owns BK = 64 columns of k (two per lane), TI = 32
//    rows of i and one part of the j axis. Every thread keeps a[i,k] of its 32
//    rows and 2 columns, and their S_A sums, in registers. Its warp walks its
//    share of the part four j rows at a time: b[j,k] comes from shared
//    memory, and g from one float4 broadcast read that serves 8 triples of
//    every lane.
//  * One pass. S_A and S_B accumulate together. S_B of four j rows is complete
//    over the block's 32 rows when the warp leaves them and goes to scratch as
//    the tile's partial; S_A is summed over the block's four warps in shared
//    memory at the end and goes to scratch as the part's partial. The j axis
//    is cut into as many parts as bring the grid near four blocks an SM.
//  * Staging overlaps the sums: the g tile (32 x 32) and the b tile (32 x 64)
//    of the next j rows are copied into a second shared-memory stage with
//    `cp.async` while the current one is summed.
//  * dw2 leaves the triple loop: by the identity above each block adds
//    a * S_A and b * S_B of its own partial sums, from the registers that hold
//    them, unscaled, so a zero in w2 loses nothing; db2 is summed from the g
//    values the block stages.
//  * No atomics. `pairwise_finish_kernel` adds the partials in a fixed order,
//    one thread per output across the whole card, scales by w2, and sums the
//    blocks' dw2 and db2 partials; repeated runs give identical bits. Ragged
//    rows and a ragged K are zero-filled: a zero of g adds nothing and a
//    masked column is never written.
//
// Measured (`python -m graphecho_torch.pairwise_bench`, NVIDIA H100 80GB HBM3,
// 700.00 W): at 560^2 the main pass takes 0.047 ms and the finishing pass
// 0.009 ms, against 0.206 ms for the three kernels it replaces. Without the
// triple loop the main pass still takes 0.019 ms: staging, 26 MB of partial
// sums, and each block's first loads and epilogue at two blocks an SM (212
// registers a thread). Tried and slower, in one call against 0.059 ms for
// this design: S_A and S_B in two passes (0.096 ms, against 0.073 for the
// same code fused, one column a lane: commit f8871d4); S_B summed across a
// thread-block cluster in distributed shared memory (0.080 ms, commit
// 3f1c2de: the cluster's blocks wait for each other); several i tiles a
// block, S_B summed in shared memory (0.066 ms, commit e7e27d1: 240 blocks
// leave SMs idle). In other calls: 16-row tiles at four blocks an SM (0.077
// against 0.060 ms: twice the S_B partials); three blocks an SM by launch
// bounds (0.069 against 0.059 ms: 168 registers and spills); grids of about
// three or six blocks an SM (0.061, 0.064 ms); masks from `set.gt` with
// FFMAs in place of predicated adds (1-2% slower).
//
// Plain C interface, loaded with ctypes. Every entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int FT = 16;   // forward output tile: FT x FT threads, one output each
constexpr int FKC = 64;  // forward K-chunk staged in shared memory

__global__ void fwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                           const float* __restrict__ w2, float* __restrict__ out,
                           int n1, int n2, int k) {
  __shared__ float a_s[FT][FKC + 1];
  __shared__ float b_s[FT][FKC + 1];
  __shared__ float w_s[FKC];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * FT + tx;
  const int i0 = blockIdx.y * FT, j0 = blockIdx.x * FT;
  float acc = 0.f;
  for (int k0 = 0; k0 < k; k0 += FKC) {
    // FT*FKC values of a and of b per chunk, FT*FT threads: FKC/FT loads each
    for (int e = tid; e < FT * FKC; e += FT * FT) {
      const int r = e / FKC, c = e % FKC;
      const bool kin = k0 + c < k;
      a_s[r][c] = (i0 + r < n1 && kin) ? a[(size_t)(i0 + r) * k + k0 + c] : 0.f;
      b_s[r][c] = (j0 + r < n2 && kin) ? b[(size_t)(j0 + r) * k + k0 + c] : 0.f;
    }
    if (tid < FKC) w_s[tid] = (k0 + tid < k) ? w2[k0 + tid] : 0.f;
    __syncthreads();
#pragma unroll 16
    for (int c = 0; c < FKC; ++c) {
      acc = fmaf(w_s[c], fmaxf(a_s[ty][c] + b_s[tx][c], 0.f), acc);
    }
    __syncthreads();
  }
  const int i = i0 + ty, j = j0 + tx;
  if (i < n1 && j < n2) out[(size_t)i * n2 + j] = acc;
}


constexpr int BK = 64;   // backward: k columns per block, two per lane (lane, lane + 32)
constexpr int TI = 32;   // backward: i rows per block, all held by every thread
constexpr int WJ = 4;    // backward: warps per block, each taking its own j rows
constexpr int NT = WJ * 32;      // backward: threads per block
constexpr int RJ = 4;            // backward: j rows a warp takes at once (one float4 of g)
constexpr int SJ = 2 * WJ * RJ;  // backward: j rows staged in shared memory at once
constexpr int GS = SJ + 4;       // row stride of the staged g tile (keeps float4 reads aligned)
constexpr int STAGE = TI * GS + SJ * BK;  // floats of one stage: the g tile, then the b tile
constexpr int TARGET_BLOCKS = 4 * 132;  // about four blocks for each SM of an H100
constexpr int FIN = 256;  // threads per block of the finishing pass

// How the backward cuts its work: `kt` column tiles of BK, `tiles` tiles of TI
// rows of i, and the j axis in `splits` parts of `span` rows (a multiple of
// SJ), as many parts as bring the grid near TARGET_BLOCKS.
struct Plan {
  int kt, tiles, splits, span;
};

Plan plan(int n1, int n2, int k) {
  Plan p;
  p.kt = (k + BK - 1) / BK;
  p.tiles = (n1 + TI - 1) / TI;
  const long long base = (long long)p.kt * p.tiles;
  const int stages = (n2 + SJ - 1) / SJ;
  const int want = (int)std::max(1LL, std::min((long long)stages,
                                               (TARGET_BLOCKS + base - 1) / base));
  p.span = (stages + want - 1) / want * SJ;
  p.splits = (n2 + p.span - 1) / p.span;
  return p;
}

// 4-byte asynchronous copy from device to shared memory; zero-fills when !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

// Block (column tile kt, i tile it, j part s). Writes
//   part_a[s, i, k]  = sum over the part's j of g * 1[a_ik + b_jk > 0]
//   part_b[it, j, k] = sum over the tile's i of the same
//   dw_part[it * splits + s, k] = sum_i a * part_a + sum_j b * part_b
//   g_part[it * splits + s]     = sum of the block's g tile (column tile 0)
__global__ void __launch_bounds__(NT)
pairwise_bwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ g, float* __restrict__ part_a,
                    float* __restrict__ part_b, float* __restrict__ dw_part,
                    float* __restrict__ g_part, int n1, int n2, int k, int splits,
                    int span) {
  // two stages, double-buffered; after the loop the same memory holds `red`
  __shared__ __align__(16) float smem[2 * STAGE];
  __shared__ float gsum_s[NT];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int kt = blockIdx.x, it = blockIdx.y, s = blockIdx.z;
  const int k0 = kt * BK;
  const bool kin[2] = {k0 + lane < k, k0 + 32 + lane < k};
  const int i0 = it * TI;
  const int jb = s * span, je = min(n2, jb + span);
  const bool sum_g = kt == 0;

  // copies the g tile (TI x SJ) and the b tile (SJ x BK) of rows j0.. into
  // stage `buf`, zero past the edges
  auto stage = [&](int buf, int j0) {
    float* gs = smem + buf * STAGE;
    float* bs = gs + TI * GS;
    for (int e = tid; e < TI * SJ; e += NT) {
      const int r = e / SJ, c = e % SJ;
      const bool in = i0 + r < n1 && j0 + c < je;
      cp_async4(gs + r * GS + c, in ? g + (size_t)(i0 + r) * n2 + j0 + c : g, in);
    }
    for (int e = tid; e < SJ * BK; e += NT) {
      const int c = e / BK, col = k0 + e % BK;
      const bool in = j0 + c < je && col < k;
      cp_async4(bs + e, in ? b + (size_t)(j0 + c) * k + col : b, in);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float av[2][TI], sa[2][TI];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int r = 0; r < TI; ++r) {
      av[h][r] = (kin[h] && i0 + r < n1) ? a[(size_t)(i0 + r) * k + k0 + 32 * h + lane] : 0.f;
      sa[h][r] = 0.f;
    }
  }
  float dw[2] = {0.f, 0.f}, gsum = 0.f;

  stage(0, jb);
  for (int j0 = jb, buf = 0; j0 < je; j0 += SJ, buf ^= 1) {
    if (j0 + SJ < je) {
      stage(buf ^ 1, j0 + SJ);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const float* gs = smem + buf * STAGE;
    const float* bs = gs + TI * GS;
    if (sum_g) {
      for (int e = tid; e < TI * SJ; e += NT) gsum += gs[(e / SJ) * GS + e % SJ];
    }
#pragma unroll
    for (int u = 0; u < SJ / (WJ * RJ); ++u) {
      const int c = (u * WJ + w) * RJ;
      float bv[2][RJ], sbq[2][RJ];  // b, and the S_B sums over the block's rows
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int q = 0; q < RJ; ++q) {
          bv[h][q] = bs[(c + q) * BK + 32 * h + lane];
          sbq[h][q] = 0.f;
        }
      }
#pragma unroll
      for (int r = 0; r < TI; ++r) {
        const float4 gv = *reinterpret_cast<const float4*>(gs + r * GS + c);
        const float gq[RJ] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int q = 0; q < RJ; ++q) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (av[h][r] + bv[h][q] > 0.f) {
              sa[h][r] += gq[q];
              sbq[h][q] += gq[q];
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < RJ; ++q) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = j0 + c + q, col = k0 + 32 * h + lane;
          if (j < je && col < k) part_b[((size_t)it * n2 + j) * k + col] = sbq[h][q];
          dw[h] = fmaf(bv[h][q], sbq[h][q], dw[h]);
        }
      }
    }
    __syncthreads();
  }

  // a * S_A by linearity: each warp adds a times its own partial sums
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int r = 0; r < TI; ++r) dw[h] = fmaf(av[h][r], sa[h][r], dw[h]);
  }
  // S_A of the part: the warps' sums of each (row, column) in warp order, one
  // half of the columns at a time through red[WJ][TI][32]
  float* red = smem;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int r = 0; r < TI; ++r) red[(w * TI + r) * 32 + lane] = sa[h][r];
    __syncthreads();
    const int col = k0 + 32 * h + lane;
#pragma unroll
    for (int m = 0; m < TI / WJ; ++m) {
      const int r = m * WJ + w, i = i0 + r;
      float sum = 0.f;
#pragma unroll
      for (int v = 0; v < WJ; ++v) sum += red[(v * TI + r) * 32 + lane];
      if (kin[h] && i < n1) part_a[((size_t)s * n1 + i) * k + col] = sum;
    }
    __syncthreads();
  }
  red[w * BK + lane] = dw[0];
  red[w * BK + 32 + lane] = dw[1];
  gsum_s[tid] = gsum;
  __syncthreads();
  const int blk = it * splits + s;
  if (w < 2 && k0 + tid < k) {
    float sum = 0.f;
#pragma unroll
    for (int v = 0; v < WJ; ++v) sum += red[v * BK + tid];
    dw_part[(size_t)blk * k + k0 + tid] = sum;
  }
  if (sum_g) {
    for (int h = NT / 2; h > 0; h >>= 1) {
      if (tid < h) gsum_s[tid] += gsum_s[tid + h];
      __syncthreads();
    }
    if (tid == 0) g_part[blk] = gsum_s[0];
  }
}

// Threads [0, (n1 + n2) * k): dA = w2 * (sum of the a_parts partials), then dB
// likewise, partials in order. The last blocks: dw2[k] = sum of the dw_parts
// partials, and thread 0 of them db2 = sum of the g_parts partials.
__global__ void __launch_bounds__(FIN)
pairwise_finish_kernel(const float* __restrict__ pa, int a_parts, int n1,
                       float* __restrict__ da, const float* __restrict__ pb, int b_parts,
                       int n2, float* __restrict__ db, const float* __restrict__ w2,
                       const float* __restrict__ dw_part, int dw_parts,
                       float* __restrict__ dw2, const float* __restrict__ g_part,
                       float* __restrict__ db2, int k, int elem_blocks) {
  if ((int)blockIdx.x < elem_blocks) {
    const size_t nak = (size_t)n1 * k, nbk = (size_t)n2 * k;
    size_t e = (size_t)blockIdx.x * FIN + threadIdx.x;
    const float* p = pa;
    float* out = da;
    int parts = a_parts;
    size_t stride = nak;
    if (e >= nak) {
      e -= nak;
      if (e >= nbk) return;
      p = pb, out = db, parts = b_parts, stride = nbk;
    }
    float sum = 0.f;
    for (int q = 0; q < parts; ++q) sum += p[q * stride + e];
    out[e] = w2[e % k] * sum;
    return;
  }
  const int col = (blockIdx.x - elem_blocks) * FIN + threadIdx.x;
  if (col < k) {
    float sum = 0.f;
    for (int q = 0; q < dw_parts; ++q) sum += dw_part[(size_t)q * k + col];
    dw2[col] = sum;
  }
  if (col == 0) {
    float sum = 0.f;
    for (int q = 0; q < dw_parts; ++q) sum += g_part[q];
    db2[0] = sum;
  }
}

}  // namespace

extern "C" {

int pairwise_mlp_fwd(const float* a, const float* b, const float* w2, float* out,
                     int n1, int n2, int k, void* stream) {
  const dim3 block(FT, FT);
  const dim3 grid((n2 + FT - 1) / FT, (n1 + FT - 1) / FT);
  fwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a, b, w2, out,
                                                                   n1, n2, k);
  return static_cast<int>(cudaGetLastError());
}

// Floats of scratch `pairwise_mlp_bwd` needs: the S_A partials of each j part,
// the S_B partials of each i tile, and each block's dw2 and db2 partials.
long long pairwise_mlp_bwd_scratch_floats(int n1, int n2, int k) {
  const Plan p = plan(n1, n2, k);
  const long long blocks = (long long)p.tiles * p.splits;
  return ((long long)p.splits * n1 + (long long)p.tiles * n2 + blocks) * k + blocks;
}

// dA (n1, k), dB (n2, k), dw2 (k) and db2 (1) from a (n1, k), b (n2, k),
// w2 (k) and the cotangent g (n1, n2): the fused pass, then the fixed-order
// finishing pass.
int pairwise_mlp_bwd(const float* a, const float* b, const float* w2, const float* g,
                     float* da, float* db, float* dw2, float* db2, float* scratch,
                     int n1, int n2, int k, void* stream) {
  if (n1 < 1 || n2 < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = plan(n1, n2, k);
  float* part_a = scratch;
  float* part_b = part_a + (size_t)p.splits * n1 * k;
  float* dw_part = part_b + (size_t)p.tiles * n2 * k;
  float* g_part = dw_part + (size_t)p.tiles * p.splits * k;

  pairwise_bwd_kernel<<<dim3(p.kt, p.tiles, p.splits), NT, 0, s>>>(
      a, b, g, part_a, part_b, dw_part, g_part, n1, n2, k, p.splits, p.span);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long elems = (long long)(n1 + n2) * k;
  const int elem_blocks = (int)((elems + FIN - 1) / FIN);
  pairwise_finish_kernel<<<elem_blocks + (k + FIN - 1) / FIN, FIN, 0, s>>>(
      part_a, p.splits, n1, da, part_b, p.tiles, n2, db, w2, dw_part, p.tiles * p.splits,
      dw2, g_part, db2, k, elem_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
