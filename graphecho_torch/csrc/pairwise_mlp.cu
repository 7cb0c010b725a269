// Fused pairwise-MLP affinity, forward and backward, for Hopper (sm_90a).
//
//   M[i,j]  = sum_k w2[k] * relu(a[i,k] + b[j,k]) + b2
//   dA[i,k] = w2[k] * S_A[i,k],   S_A[i,k] = sum_j g[i,j] * 1[a_ik + b_jk > 0]
//   dB[j,k] = w2[k] * S_B[j,k],   S_B[j,k] = sum_i g[i,j] * 1[a_ik + b_jk > 0]
//   dw2[k]  = sum_ij g[i,j] * relu(a_ik + b_jk)
//           = sum_i a_ik * S_A[i,k] + sum_j b_jk * S_B[j,k]   (relu(t) = t * 1[t > 0])
//   db2     = sum_ij g[i,j]
//
// Replaces the Pallas TPU kernels of
// graphecho_tpu/ops/pallas/pairwise_mlp_kernel.py: `_fwd_kernel` (via
// `_forward`) with the entry point `pairwise_mlp_fwd` (`pairwise_fwd_kernel`),
// and both `_bwd_da_kernel` and `_bwd_db_kernel` (via `_backward`) with the
// one backward entry point `pairwise_mlp_bwd`: `pairwise_bwd_kernel`, then
// `pairwise_finish_kernel`.
//
// What bounds the forward on an H100: FP32 operations off the tensor cores
// (a max sits inside the sum). The function is 4 * N1 * N2 * K operations
// (add, max, multiply, add): 9.6 us at 67 TFLOP/s at 560 x 560 x 512, against
// 2.3 MB of inputs. Issued as instructions, the direct form is three a triple
// (add, max, FMA): 3 * 160.6 M / (132 SMs * 128 lanes * 1.98 GHz) = 14.4 us.
// This kernel issues two, by relu(a + b) = max(b, -a) + a (exact: a + b > 0
// exactly when b > -a): M = sum_k w2 * max(b, -a) + d_i + b2 with
// d_i = sum_k w2 * a_ik, one FMA per (i, k) of a thread; the negation folds
// into the max (FMNMX.NAN with a negated operand). Issue floor 9.6 us.
// `max.NaN` keeps a NaN of a or b, as jnp.maximum and torch.relu do (fmaxf
// would drop it): a NaN in a[i, k] makes row i NaN, in b[j, k] column j.
//
// What the design does about it:
//  * Register tiles. A thread holds TM x TN sums (6 x 7 or 2 x 2) and
//    reads, per four columns of k, TM + TN + 1 float4 broadcasts from a
//    k-contiguous stage (rows padded so a warp's rows fall on distinct banks):
//    14 shared loads for 168 triples in the 6 x 7 class.
//  * Staging by `cp.async`, 16 bytes a copy, in a ring of three k-chunks;
//    each thread's copies are fixed rows and one column, so a chunk costs a
//    few instructions a copy. Other k or alignments take 4-byte copies.
//  * A per-shape plan (`fwd_plan`) picks the class with the less estimated
//    time: the busiest SM's instruction slots plus the bytes every block
//    stages from L2. Without the sums the kernel still takes 7.5 us at 560^2
//    in the 48 x 56 class (25 MB staged from L2 at ~3.3 TB/s) and 15 us in the
//    32 x 16 class (60 MB): the traffic, not the card's fill, set the tile.
//    At 560^2 48 x 56 tiles give 120 blocks, one an SM; at 112^2 16 x 8 tiles
//    give 98 blocks and k is split over the 8 warps of a block.
//  * No atomics: the warps' partial sums meet in shared memory and are added
//    in a fixed order, so repeats are bit-identical. b2 is read on the device
//    and added in the same epilogue, which stores along j.
//
// Measured (`python -m graphecho_torch.pairwise_bench`, NVIDIA H100 80GB HBM3,
// 700.00 W): 0.024 ms of device time at 560^2 and 0.0037 ms at 112^2, against
// 0.066 and 0.013 ms for the one-output-a-thread kernel it replaces. Tried
// and slower at 560^2, each in one call against 0.024 ms: 32 x 16 tiles
// (0.031, commit 92fb435), 16 x 8 (0.041), the direct add, max and FMA
// (0.027), 56 x 56 (0.029), 48 x 64 (0.027), 40 x 56 (0.037), the 48 x 56
// class with 16 warps (0.026); a 2-, 4- or 6-deep ring or 128-column chunks
// gained nothing. Against 0.025 ms for 32 x 16: 32 x 32 tiles with two or
// three blocks an SM (0.029-0.031, spills at three); k split over a cluster
// of 8 blocks with 64 x 64 tiles, the sums added in distributed shared
// memory (0.033, commit 0ab5254: 0.013 ms without the sums).
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

// 4-byte asynchronous copy from device to shared memory; zero-fills when !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

// 16-byte asynchronous copy (both addresses 16-byte aligned); zero-fills when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

// max(x, y) that returns NaN when either is NaN, as jnp.maximum and torch.relu
// do; fmaxf would return the other operand.
__device__ __forceinline__ float max_nan(float x, float y) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(x), "f"(y));
  return r;
}

// One forward shape class. A block owns BM = TM * TI rows of i and
// BN = TN * TJ rows of j; its threads form S groups of TI x TJ, group s
// taking columns [s * KG, (s + 1) * KG) of every staged chunk of KC = S * KG
// columns of k; a thread holds TM x TN sums, rows ti + m * TI, columns
// tj + n * TJ of the tile. NS chunks are in flight in a ring.
template <int TM_, int TN_, int TI_, int TJ_, int S_, int KG_, int NS_, int MINB_>
struct FwdTile {
  static constexpr int TM = TM_, TN = TN_, TI = TI_, TJ = TJ_, S = S_, KG = KG_;
  static constexpr int NS = NS_, MINB = MINB_;
  static constexpr int BM = TM * TI, BN = TN * TJ, G = TI * TJ, NT = G * S;
  static constexpr int KC = S * KG;
  static constexpr int LD = KC + 4;  // row stride of a staged tile: rows fall on distinct banks
  static constexpr int STAGE = (BM + BN) * LD + KC;  // the a tile, the b tile, then w2
  static constexpr int RS = BN + 1;                  // row stride of the partial sums
  static constexpr int SMEM = NS * STAGE * 4;        // bytes of dynamic shared memory
  // 16-byte copies: a thread copies column c = (tid % CPR) * 4 of rows
  // tid / CPR + p * RSTEP (p < PA of the a tile, p < PB of the b tile), the
  // same in every chunk
  static constexpr int CPR = KC / 4, RSTEP = NT / CPR;
  static constexpr int PA = (BM + RSTEP - 1) / RSTEP, PB = (BN + RSTEP - 1) / RSTEP;
  static_assert(KG % 4 == 0, "columns are read as float4");
  static_assert(NT % CPR == 0 && PA <= 32 && PB <= 32, "copies of whole 16-byte columns");
  static_assert(S * BM * RS <= NS * STAGE, "the partial sums reuse the stages");
};

// The shape classes the plan picks from (`fwd_plan`).
using FwdBig = FwdTile<6, 7, 8, 8, 4, 16, 3, 1>;    // 48 x 56 outputs, K in 4 warps
using FwdSplit = FwdTile<2, 2, 8, 4, 8, 16, 3, 2>;  // 16 x 8 outputs, K in 8 warps

// M[i, j] = sum_k w2[k] * relu(a[i, k] + b[j, k]) + b2[0] for one tile.
// Each (i, j, k) is one NaN-keeping max and one FMA:
//   relu(a + b) = max(b, -a) + a   (exact: a + b > 0 exactly when b > -a), so
//   M[i, j] = sum_k w2 * max(b_jk, -a_ik) + d_i + b2,  d_i = sum_k w2 * a_ik,
// and d_i costs one FMA per (i, k) of a thread, 1/TN of the triples.
// PAIRWISE_FWD_THREE_OPS builds the direct form (add, max, FMA) instead.
template <class T>
__global__ void __launch_bounds__(T::NT, T::MINB)
pairwise_fwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ w2, const float* __restrict__ b2,
                    float* __restrict__ out, int n1, int n2, int k, int vec) {
  constexpr int TM = T::TM, TN = T::TN, TI = T::TI, TJ = T::TJ, S = T::S, KG = T::KG;
  constexpr int BM = T::BM, BN = T::BN, NT = T::NT, KC = T::KC, LD = T::LD, NS = T::NS;
  constexpr int STAGE = T::STAGE, RS = T::RS, CPR = T::CPR, RSTEP = T::RSTEP;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, s = tid / T::G, t = tid % T::G;
  const int ti = t / TJ, tj = t % TJ;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;

  // this thread's 16-byte copies: rows r0 + p * RSTEP of each tile, column c
  const int c = tid % CPR * 4, r0 = tid / CPR;
  const float* a_src = a + (size_t)(i0 + r0) * k + c;
  const float* b_src = b + (size_t)(j0 + r0) * k + c;
  const size_t step = (size_t)RSTEP * k;
  unsigned a_rows = 0, b_rows = 0;  // bit p: row r0 + p * RSTEP is in the tile and exists
#pragma unroll
  for (int p = 0; p < T::PA; ++p) {
    const int r = r0 + p * RSTEP;
    a_rows |= (unsigned)(r < BM && i0 + r < n1) << p;
  }
#pragma unroll
  for (int p = 0; p < T::PB; ++p) {
    const int r = r0 + p * RSTEP;
    b_rows |= (unsigned)(r < BN && j0 + r < n2) << p;
  }

  // copies columns k0.. of the a tile, the b tile and w2 into stage `buf`,
  // zero past the edges (a zero of w2 adds nothing; masked rows are never
  // stored); a chunk at or past k commits an empty group
  auto stage = [&](int buf, int k0) {
    float* as = smem + buf * STAGE;
    float* bs = as + BM * LD;
    float* ws = bs + BN * LD;
    if (k0 < k && vec) {  // k % 4 == 0 and 16-byte aligned rows
      const bool kin = k0 + c < k;
#pragma unroll
      for (int p = 0; p < T::PA; ++p) {
        const int r = r0 + p * RSTEP;
        const bool in = kin && (a_rows >> p & 1);
        if (r < BM) cp_async16(as + r * LD + c, in ? a_src + p * step + k0 : a, in);
      }
#pragma unroll
      for (int p = 0; p < T::PB; ++p) {
        const int r = r0 + p * RSTEP;
        const bool in = kin && (b_rows >> p & 1);
        if (r < BN) cp_async16(bs + r * LD + c, in ? b_src + p * step + k0 : b, in);
      }
      if (tid < CPR) cp_async16(ws + 4 * tid, kin ? w2 + k0 + c : w2, kin);
    } else if (k0 < k) {  // 4-byte copies, any k and alignment
      for (int e = tid; e < (BM + BN) * KC; e += NT) {
        const int r = e / KC, col = e % KC;
        const int row = r < BM ? i0 + r : j0 + r - BM;
        const bool in = (r < BM ? row < n1 : row < n2) && k0 + col < k;
        const float* src = (r < BM ? a : b) + (size_t)row * k + k0 + col;
        cp_async4(as + r * LD + col, in ? src : a, in);
      }
      for (int e = tid; e < KC; e += NT) {
        const bool in = k0 + e < k;
        cp_async4(ws + e, in ? w2 + k0 + e : w2, in);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[TM][TN], d[TM];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    d[m] = 0.f;
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[m][n] = 0.f;
  }

#pragma unroll
  for (int q = 0; q < NS - 1; ++q) stage(q, q * KC);
  for (int k0 = 0, buf = 0; k0 < k; k0 += KC, buf = buf + 1 == NS ? 0 : buf + 1) {
    stage(buf == 0 ? NS - 1 : buf - 1, k0 + (NS - 1) * KC);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NS - 1));
    __syncthreads();
    const float* as = smem + buf * STAGE;
    const float* bs = as + BM * LD;
    const float* ws = bs + BN * LD;
#pragma unroll
    for (int kk = 0; kk < KG; kk += 4) {
      const int col = s * KG + kk;
      const float4 w4 = *reinterpret_cast<const float4*>(ws + col);
      float4 a4[TM], b4[TN];
#pragma unroll
      for (int m = 0; m < TM; ++m)
        a4[m] = *reinterpret_cast<const float4*>(as + (ti + m * TI) * LD + col);
#pragma unroll
      for (int n = 0; n < TN; ++n)
        b4[n] = *reinterpret_cast<const float4*>(bs + (tj + n * TJ) * LD + col);
      const float wq[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          const float aq = q == 0 ? a4[m].x : q == 1 ? a4[m].y : q == 2 ? a4[m].z : a4[m].w;
#ifndef PAIRWISE_FWD_THREE_OPS
          d[m] = fmaf(wq[q], aq, d[m]);
#endif
#pragma unroll
          for (int n = 0; n < TN; ++n) {
            const float bq = q == 0 ? b4[n].x : q == 1 ? b4[n].y : q == 2 ? b4[n].z : b4[n].w;
#ifdef PAIRWISE_FWD_THREE_OPS
            acc[m][n] = fmaf(wq[q], max_nan(aq + bq, 0.f), acc[m][n]);
#else
            acc[m][n] = fmaf(wq[q], max_nan(bq, -aq), acc[m][n]);
#endif
          }
        }
      }
    }
    __syncthreads();
  }

  // each group's sums to shared memory (the groups still in flight are
  // empty), then every thread adds the S partials of its outputs in group
  // order, adds b2 and stores along j
  float* red = smem;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
#pragma unroll
    for (int n = 0; n < TN; ++n) red[(s * BM + ti + m * TI) * RS + tj + n * TJ] = acc[m][n] + d[m];
  }
  __syncthreads();
  const float bias = *b2;
  for (int e = tid; e < BM * BN; e += NT) {
    const int r = e / BN, col = e % BN, i = i0 + r, j = j0 + col;
    if (i < n1 && j < n2) {
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < S; ++q) sum += red[(q * BM + r) * RS + col];
      out[(size_t)i * n2 + j] = sum + bias;
    }
  }
}

// Which shape class serves (n1, n2, k): the one with the least estimated
// time, in cycles of one SM: the busiest SM's instruction slots,
// ceil(blocks / 132) blocks of BM x BN outputs over all of k, weighted
// by the slots a triple costs in that class (per four columns TM + TN + 1
// float4 loads, 8 TM TN max and FMA, 4 TM FMAs for d_i), over its 128 lanes,
// plus the bytes every block stages from L2, (BM + BN) rows of k, at ~2 KB a
// cycle for the card. PAIRWISE_FWD_CONFIG (0 or 1) forces one for measurement.
constexpr int SMS = 132;

template <class T>
long long fwd_cost(int n1, int n2, int k) {
  const long long blocks = (long long)((n1 + T::BM - 1) / T::BM) * ((n2 + T::BN - 1) / T::BN);
  const long long slots = 8LL * T::TM * T::TN + 4 * T::TM + T::TM + T::TN + 1;  // per 4 k
  const long long issue = (blocks + SMS - 1) / SMS * T::BM * T::BN * k * slots /
                          (4LL * T::TM * T::TN * 128);
  const long long bytes = blocks * (T::BM + T::BN) * 4LL * k;
  return issue + bytes / 2048;
}

int fwd_plan(int n1, int n2, int k) {
#ifdef PAIRWISE_FWD_CONFIG
  return PAIRWISE_FWD_CONFIG;
#else
  return fwd_cost<FwdBig>(n1, n2, k) <= fwd_cost<FwdSplit>(n1, n2, k) ? 0 : 1;
#endif
}

template <class T>
cudaError_t fwd_launch(const float* a, const float* b, const float* w2, const float* b2,
                       float* out, int n1, int n2, int k, int vec, cudaStream_t s) {
  if (T::SMEM > 48 * 1024) {  // once per class, before its first launch
    static const cudaError_t set = cudaFuncSetAttribute(
        pairwise_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (set != cudaSuccess) return set;
  }
  const dim3 grid((n2 + T::BN - 1) / T::BN, (n1 + T::BM - 1) / T::BM);
  pairwise_fwd_kernel<T><<<grid, T::NT, T::SMEM, s>>>(a, b, w2, b2, out, n1, n2, k, vec);
  return cudaGetLastError();
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

// M (n1, n2) = sum_k w2[k] * relu(a[i, k] + b[j, k]) + b2[0] from a (n1, k),
// b (n2, k), w2 (k) and b2 (1, read on the device): one launch.
int pairwise_mlp_fwd(const float* a, const float* b, const float* w2, const float* b2,
                     float* out, int n1, int n2, int k, void* stream) {
  if (n1 < 1 || n2 < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = k % 4 == 0 && ((reinterpret_cast<size_t>(a) | reinterpret_cast<size_t>(b) |
                                  reinterpret_cast<size_t>(w2)) & 15) == 0;
  cudaError_t err;
  switch (fwd_plan(n1, n2, k)) {
    case 0: err = fwd_launch<FwdBig>(a, b, w2, b2, out, n1, n2, k, vec, s); break;
    default: err = fwd_launch<FwdSplit>(a, b, w2, b2, out, n1, n2, k, vec, s); break;
  }
  return static_cast<int>(err);
}

// Which shape class `pairwise_mlp_fwd` launches at (n1, n2, k): 0 for 48 x 56
// tiles, 1 for 16 x 8 tiles with k split over 8 warps.
int pairwise_mlp_fwd_plan(int n1, int n2, int k) { return fwd_plan(n1, n2, k); }

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
