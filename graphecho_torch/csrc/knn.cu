// Fused kNN graph for Hopper (sm_90a): for every query row q of x and every
// key row k of y (y = x for a self graph),
//
//   s_q, s_k = 1 / max(|q|, 1e-12), 1 / max(|k|, 1e-12)   (1 without normalize)
//   d[q,k]   = s_q^2 |q|^2 - 2 (q.k) s_q s_k + s_k^2 |k|^2  (+ relative_pos[q,k])
//   out[q]   = the k_sel columns of smallest d, ascending, ties to the lowest column
//
// Replaces the Pallas TPU kernel graphecho_tpu/ops/pallas/knn_kernel.py
// (`_knn_kernel`, launched by `pallas_knn`). Pallas normalizes the rows first,
// x * rsqrt(max(sum x^2, 1e-24)); here the dot product of the raw rows is
// scaled by s_q s_k, which is the plain version's `F.normalize` followed by
// the product, up to rounding. NaN inputs are outside the contract.
//
// What bounds it on an H100: operations. The distance products are 2*N*M*C
// per batch item against (N + M)*C inputs; at the ViG widths (C = 80..640,
// M = 196) that is far above the card's ridge point, so the FP32 CUDA-core
// rate (67 TFLOP/s) sets the floor. The products stay on the CUDA cores in
// FP32. Plain TF32 rounds far enough to reorder near-tied neighbours. A
// 3xTF32 `mma.sync` version (hi*hi + hi*lo + lo*hi) kept the order within the
// near-tie rule but was slower: 0.242 / 0.133 / 0.118 / 0.118 / 0.060 ms
// against this file's 0.240 / 0.111 / 0.068 / 0.069 / 0.040 ms at the five
// pvig_s Grapher shapes (`python -m graphecho_torch.knn_bench`, NVIDIA H100
// 80GB HBM3, 700.00 W): its chains of three dependent mma wait on latency,
// and splitting every operand into TF32 parts costs ALU work.
// What sets the pace is the sequence of each block's phases (staging, products,
// selection) and the bytes the blocks re-read from L2, not the FMAs.
//
// What the design does about it:
//  * One launch per call, no scratch. A block owns BQ = 4 * RQ queries of one
//    batch item and walks the keys in tiles of MT = 256 (one tile for every
//    pvig shape, M <= 196), so the (N, M) distance matrix never reaches device
//    memory. Every block stages all the keys of its tile, so fewer, larger
//    blocks move fewer bytes: the C entry point takes 32 queries wherever that
//    gives each SM a block, else 16 or 8 while half the SMs get one (4 below).
//  * Staging: each 16-channel chunk of the block's queries and of the tile's
//    keys is copied into a three-stage shared-memory ring with `cp.async`
//    (16 bytes a copy where rows allow it, zero-filled past C), two chunks in
//    flight while one is multiplied. The same shared rows give each row's
//    sum of squares, so the norms cost no second pass and no other kernel:
//    the dot product of the raw rows is scaled by s_q s_k. Only the valid rows
//    of a ragged tile are copied, and warps skip 32-key groups past M: M = 196
//    computes 224 columns, not 256.
//  * Products: warp w takes keys 32 * (2j + w % 2) + lane (j < 4) and RQ
//    queries, an RQ x 4 block of dot products in registers, channels in
//    increasing order. Query loads are broadcast, key loads are 16-byte
//    reads free of bank conflicts. The distances, with the bias, go to shared
//    memory as one row per query.
//  * Selection orders by the pair (distance, column) everywhere, packed into
//    one 64-bit key: the distance's bits mapped to an unsigned order (-0.0
//    first made +0.0, which the stable sort treats as equal) above the
//    column. Keys are unique, so the k smallest are exactly the first k of
//    the plain version's stable sort, whatever order the merges run in. One
//    warp per query holds the row, 8 keys a lane. In the first key tile a
//    threshold, the k-th smallest of each lane's two smallest distances, lets
//    through at least k keys and, at the pvig shapes, rarely more than 64;
//    the survivors are packed into shared memory and sorted across the warp
//    by a bitonic network. Otherwise (more survivors, or a later tile of a
//    large M) the keys not below the running list's k-th are dropped (the
//    whole tile when none is), each lane sorts its survivors, and k - s
//    rounds of a warp minimum merge them with the list (entry p in lane
//    p % 32), where the first s entries are below every survivor and stay.
//  * No atomics: repeated runs are bit-identical.
//
// Plain C interface, loaded with ctypes. The entry point launches one kernel
// on the given stream, allocates nothing, and returns a CUDA error code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MT = 256;          // keys per tile, one per thread for the row sums
constexpr int RK = 4;            // 32-key groups per warp: 2 * RK * 32 = MT
constexpr int KPL = MT / 32;     // keys of a tile row per lane in the selection
constexpr int CC = 16;           // channels per staged chunk
constexpr int CCP = CC + 4;      // padded row of a staged chunk (16-byte aligned)
constexpr int NSTAGE = 3;        // chunks in the shared-memory ring
constexpr int MAX_K = 64;        // largest k: two list entries per lane
constexpr unsigned FULL = 0xffffffffu;
constexpr u64 NONE = ~0ull;      // above every (distance, column) key

static_assert(2 * RK * 32 == MT && MT == THREADS, "tile layout");

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>  // until at most N groups of copies are in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Channels [c0, c0 + CC) of `rows` rows starting at `src` (row length c) into
// dst[row * CCP + ch], zeros past c. Rows past `rows` are left as they are.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int rows, int c, int c0,
                                           bool vec16, int tid) {
  if (vec16) {  // c % 4 == 0 and 16-byte aligned rows
    for (int e = tid; e < rows * (CC / 4); e += THREADS) {
      const int r = e / (CC / 4), ch = c0 + 4 * (e % (CC / 4));
      const int bytes = ch < c ? 16 : 0;
      const float* s = src + (size_t)r * c + (bytes ? ch : 0);
      cp_async16(dst + r * CCP + (ch - c0), s, bytes);
    }
  } else {
    for (int e = tid; e < rows * CC; e += THREADS) {
      const int r = e / CC, ch = c0 + e % CC;
      const int bytes = ch < c ? 4 : 0;
      const float* s = src + (size_t)r * c + (bytes ? ch : 0);
      cp_async4(dst + r * CCP + (ch - c0), s, bytes);
    }
  }
}

__device__ __forceinline__ float sum_sq_chunk(const float* row, float s) {
#pragma unroll
  for (int c4 = 0; c4 < CC / 4; ++c4) {
    const float4 v = *reinterpret_cast<const float4*>(row + 4 * c4);
    s = fmaf(v.x, v.x, s);
    s = fmaf(v.y, v.y, s);
    s = fmaf(v.z, v.z, s);
    s = fmaf(v.w, v.w, s);
  }
  return s;
}

// the distance's bits in an unsigned order; -0.0 ties with +0.0, as in the stable sort
__device__ __forceinline__ unsigned ordered(float d) {
  if (d == 0.f) d = 0.f;
  const unsigned u = __float_as_uint(d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// (distance, column) as one key whose unsigned order is the pair's order
__device__ __forceinline__ u64 pack(unsigned ord, int col) {
  return (static_cast<u64>(ord) << 32) | static_cast<unsigned>(col);
}

__device__ __forceinline__ u64 warp_min(u64 v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const u64 o = __shfl_xor_sync(FULL, v, off);
    v = o < v ? o : v;
  }
  return v;
}

__device__ __forceinline__ u64 bitonic_step(u64 v, int stride, bool keep_min) {
  const u64 o = __shfl_xor_sync(FULL, v, stride);
  return keep_min == (o < v) ? o : v;
}

// keys of lanes [0, width) sorted ascending across them, width 16 or 32
__device__ __forceinline__ u64 sort_warp32(u64 v, int lane, int width) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
    if (size > width) break;  // uniform
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      v = bitonic_step(v, stride, ((lane & stride) == 0) == ((lane & size) == 0));
  }
  return v;
}

// 64 keys, entries lane and lane + 32 in each lane, sorted ascending
__device__ __forceinline__ void sort_warp64(u64& e0, u64& e1, int lane) {
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {  // size 64: both halves in this lane
        const u64 lo = e0 < e1 ? e0 : e1, hi = e0 < e1 ? e1 : e0;
        e0 = lo;
        e1 = hi;
      } else {
        const bool lower = (lane & stride) == 0;
        e0 = bitonic_step(e0, stride, lower == ((lane & size) == 0));
        e1 = bitonic_step(e1, stride, lower == (((lane + 32) & size) == 0));
      }
    }
}

__device__ __forceinline__ void sort_lane(u64 (&v)[KPL]) {  // bitonic network, ascending
#pragma unroll
  for (int size = 2; size <= KPL; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        const int j = i ^ stride;
        if (j > i) {
          const bool up = (i & size) == 0;
          const u64 a = v[i], b = v[j];
          const bool swap = up ? (b < a) : (a < b);
          v[i] = swap ? b : a;
          v[j] = swap ? a : b;
        }
      }
}

// The first k keys of a tile row (kr floats at `row`, nk valid, columns from
// j0), when few enough of them lie at or below a threshold that a warp sort
// of the survivors is cheaper than the merge. The threshold is the k-th
// smallest of the two smallest keys of each lane (k keys lie at or below it).
// Returns false, leaving o0/o1 alone, when more than 64 keys survive.
__device__ __forceinline__ bool select_by_threshold(const float* row, int nk, int j0, int k,
                                                    u64* scratch, int lane, u64& o0, u64& o1) {
  unsigned h[KPL];
  unsigned a = ~0u, a2 = ~0u;  // this lane's two smallest
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int col = lane + 32 * i;
    h[i] = col < nk ? ordered(row[col]) : ~0u;
    if (h[i] < a) {
      a2 = a;
      a = h[i];
    } else if (h[i] < a2) {
      a2 = h[i];
    }
  }
  unsigned t = ~0u;
  for (int p = 0; p < k; ++p) {
    t = __reduce_min_sync(FULL, a);
    if (a == t) {  // lanes that tie all step on: the threshold only grows
      a = a2;
      a2 = ~0u;
    }
  }
  int count = 0;
  __syncwarp();  // the last query's reads of the scratch are done
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    const int col = lane + 32 * i;
    const bool keep = col < nk && h[i] <= t;
    const unsigned ballot = __ballot_sync(FULL, keep);
    const int pos = count + __popc(ballot & ((1u << lane) - 1u));
    if (keep && pos < 64) scratch[pos] = pack(h[i], j0 + col);
    count += __popc(ballot);
  }
  if (count > 64) return false;  // uniform
  __syncwarp();
  if (count <= 32) {
    o0 = sort_warp32(lane < count ? scratch[lane] : NONE, lane, count <= 16 ? 16 : 32);
    o1 = NONE;
  } else {
    u64 e0 = scratch[lane], e1 = lane + 32 < count ? scratch[lane + 32] : NONE;
    sort_warp64(e0, e1, lane);
    o0 = e0;
    o1 = e1;
  }
  return true;
}

template <int RQ>
__global__ void __launch_bounds__(THREADS, 2)
knn_kernel(const float* __restrict__ x, const float* __restrict__ y,
           const float* __restrict__ rel, int* __restrict__ out, int n, int m, int c, int k,
           int kr, int rel_batched, int normalize, int vec16) {
  constexpr int BQ = 4 * RQ;
  const int stage = (BQ + kr) * CCP;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* dist_s = smem;  // [BQ][kr], aliases the staging ring once a tile's products are done
  float* s_q = smem + (NSTAGE * stage > BQ * kr ? NSTAGE * stage : BQ * kr);
  float* sq_q = s_q + BQ;
  float* s_k = sq_q + BQ;
  float* sq_k = s_k + MT;
  u64* scratch = reinterpret_cast<u64*>(sq_k + MT);  // [WARPS][64] survivors
  u64* list_s = scratch + WARPS * 64;                // [BQ][k], only with more than one tile

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, n - q0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int half = warp % 2, group = warp / 2;
  const float* xb = x + ((size_t)b * n + q0) * c;
  const float* yb = y + (size_t)b * m * c;
  const float* relb = rel == nullptr ? nullptr : rel + (rel_batched ? (size_t)b * n * m : 0);
  const int chunks = (c + CC - 1) / CC;
  const int tiles = (m + MT - 1) / MT;

  for (int tile = 0; tile < tiles; ++tile) {
    const int j0 = tile * MT;
    const int nk = min(MT, m - j0);
    const float* yt = yb + (size_t)j0 * c;
    float acc[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) acc[i][j] = 0.f;
    float ssq_k = 0.f, ssq_q = 0.f;

#pragma unroll
    for (int s = 0; s < NSTAGE - 1; ++s) {
      if (s < chunks) {
        stage_rows(smem + s * stage, xb, nq, c, s * CC, vec16, tid);
        stage_rows(smem + s * stage + BQ * CCP, yt, nk, c, s * CC, vec16, tid);
      }
      cp_async_commit();
    }
    for (int ch = 0; ch < chunks; ++ch) {
      cp_async_wait<NSTAGE - 2>();
      __syncthreads();  // chunk ch has landed; nobody still reads chunk ch - 1's stage
      const int next = ch + NSTAGE - 1;
      if (next < chunks) {
        float* st = smem + (next % NSTAGE) * stage;
        stage_rows(st, xb, nq, c, next * CC, vec16, tid);
        stage_rows(st + BQ * CCP, yt, nk, c, next * CC, vec16, tid);
      }
      cp_async_commit();
      const float* q_st = smem + (ch % NSTAGE) * stage;
      const float* k_st = q_st + BQ * CCP;
      if (tid < nk) ssq_k = sum_sq_chunk(k_st + tid * CCP, ssq_k);
      if (tid < nq) ssq_q = sum_sq_chunk(q_st + tid * CCP, ssq_q);
      const int w4 = (min(CC, c - ch * CC) + 3) / 4;
      for (int c4 = 0; c4 < w4; ++c4) {
        float4 kv[RK];
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          const int col = 32 * (2 * j + half);
          if (col < nk)  // uniform across the warp
            kv[j] = *reinterpret_cast<const float4*>(k_st + (col + lane) * CCP + 4 * c4);
        }
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const float4 qv =
              *reinterpret_cast<const float4*>(q_st + (group * RQ + i) * CCP + 4 * c4);
#pragma unroll
          for (int j = 0; j < RK; ++j) {
            if (32 * (2 * j + half) >= nk) continue;
            acc[i][j] = fmaf(qv.x, kv[j].x, acc[i][j]);
            acc[i][j] = fmaf(qv.y, kv[j].y, acc[i][j]);
            acc[i][j] = fmaf(qv.z, kv[j].z, acc[i][j]);
            acc[i][j] = fmaf(qv.w, kv[j].w, acc[i][j]);
          }
        }
      }
    }
    cp_async_wait<0>();

    // row scales and squared norms of the normalized rows
    if (tid < nk) {
      const float f = normalize ? 1.f / fmaxf(sqrtf(ssq_k), 1e-12f) : 1.f;
      s_k[tid] = f;
      sq_k[tid] = normalize ? ssq_k * f * f : ssq_k;
    }
    if (tid < nq) {
      const float f = normalize ? 1.f / fmaxf(sqrtf(ssq_q), 1e-12f) : 1.f;
      s_q[tid] = f;
      sq_q[tid] = normalize ? ssq_q * f * f : ssq_q;
    }
    __syncthreads();  // staging is done: its region becomes dist_s

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int ql = group * RQ + i;
      if (ql >= nq) continue;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int col = 32 * (2 * j + half) + lane;
        if (col >= nk) continue;
        const float t = (acc[i][j] * s_q[ql]) * s_k[col];
        float d = (sq_q[ql] - 2.f * t) + sq_k[col];
        if (relb != nullptr) d += relb[(size_t)(q0 + ql) * m + j0 + col];
        dist_s[ql * kr + col] = d;
      }
    }
    __syncthreads();

    // one warp per query: merge the tile's row into the query's k-best list
    for (int ql = warp; ql < nq; ql += WARPS) {
      const float* row = dist_s + ql * kr;
      u64 o0 = NONE, o1 = NONE;  // the new list, entries lane and lane + 32
      if (tile > 0 || !select_by_threshold(row, nk, j0, k, scratch + warp * 64, lane, o0, o1)) {
        u64 v[KPL];
#pragma unroll
        for (int i = 0; i < KPL; ++i) {
          const int col = lane + 32 * i;
          v[i] = col < nk ? pack(ordered(row[col]), j0 + col) : NONE;
        }
        u64 l0 = NONE, l1 = NONE;  // the old list
        bool merge = true;
        if (tile > 0) {
          l0 = lane < k ? list_s[ql * k + lane] : NONE;
          l1 = lane + 32 < k ? list_s[ql * k + lane + 32] : NONE;
          const u64 worst = __shfl_sync(FULL, k <= 32 ? l0 : l1, (k - 1) % 32);
          bool any = false;
#pragma unroll
          for (int i = 0; i < KPL; ++i) {
            if (v[i] >= worst) v[i] = NONE;
            any |= v[i] != NONE;
          }
          merge = __any_sync(FULL, any);  // else nothing of this tile enters the list
        }
        o0 = l0;  // laid out as the old list
        o1 = l1;
        if (merge) {
          sort_lane(v);
          // list entries below every survivor keep their places
          const u64 lowest = warp_min(v[0]);
          const int keep = __popc(__ballot_sync(FULL, l0 < lowest)) +
                           __popc(__ballot_sync(FULL, l1 < lowest));
          u64 a = l0, a2 = l1;  // this lane's list entries not yet placed
          if (lane + 32 < keep) {
            a = NONE;
            a2 = NONE;
          } else if (lane < keep) {
            a = l1;
            a2 = NONE;
          }
          for (int p = keep; p < k; ++p) {
            const u64 head = v[0] < a ? v[0] : a;
            const u64 mn = warp_min(head);
            if (v[0] == mn) {
#pragma unroll
              for (int i = 0; i + 1 < KPL; ++i) v[i] = v[i + 1];
              v[KPL - 1] = NONE;
            } else if (a == mn) {
              a = a2;
              a2 = NONE;
            }
            if (lane == p % 32) {
              if (p < 32) o0 = mn;
              else o1 = mn;
            }
          }
        }
      }
      if (tile + 1 < tiles) {
        if (lane < k) list_s[ql * k + lane] = o0;
        if (lane + 32 < k) list_s[ql * k + lane + 32] = o1;
      } else {
        int* orow = out + ((size_t)b * n + q0 + ql) * k;
        if (lane < k) orow[lane] = static_cast<int>(o0 & 0xffffffffu);
        if (lane + 32 < k) orow[lane + 32] = static_cast<int>(o1 & 0xffffffffu);
      }
    }
    __syncthreads();  // dist_s and the list are read before the next tile is staged
  }
}

constexpr int MAX_DEVICES = 64;

template <int RQ>
int launch(const float* x, const float* y, const float* rel, int* out, int b, int n, int m,
           int c, int k, int rel_batch, int normalize, int vec16, int dev, cudaStream_t s) {
  constexpr int BQ = 4 * RQ;
  const int kr = m < MT ? (m + 31) / 32 * 32 : MT;  // key rows a tile stages
  const int stage = (BQ + kr) * CCP;
  const int region = NSTAGE * stage > BQ * kr ? NSTAGE * stage : BQ * kr;
  const size_t smem = sizeof(float) * (region + 2 * BQ + 2 * MT) +
                      sizeof(u64) * (WARPS * 64 + (m > MT ? (size_t)BQ * k : 0));
  static size_t granted[MAX_DEVICES] = {};  // shared memory granted per device, host side
  if (smem > 48 * 1024 && (dev >= MAX_DEVICES || smem > granted[dev])) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_kernel<RQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < MAX_DEVICES) granted[dev] = smem;
  }
  const dim3 grid((n + BQ - 1) / BQ, b);
  knn_kernel<RQ><<<grid, THREADS, smem, s>>>(x, y, rel, out, n, m, c, k, kr, rel_batch > 1,
                                            normalize, vec16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int knn_max_k() { return MAX_K; }

// x (b, n, c), y (b, m, c) and rel (rel_batch, n, m) with rel_batch 0 (no
// bias), 1 or b; out (b, n, k) int32.
int knn(const float* x, const float* y, const float* rel, int* out, int b, int n, int m, int c,
        int k, int rel_batch, int normalize, void* stream) {
  if (k < 1 || k > MAX_K || k > m || n < 1 || c < 1 || b < 1 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = rel_batch ? rel : nullptr;
  const int vec16 = c % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(y) % 16 == 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  static int sm_count[MAX_DEVICES] = {};
  int sms = dev < MAX_DEVICES ? sm_count[dev] : 0;
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < MAX_DEVICES) sm_count[dev] = sms;
  }
  // Queries per block: as many as keep the SMs busy. Every block stages all
  // the keys, so fewer, larger blocks move fewer bytes: 32 queries wherever
  // that gives every SM a block, else 16 or 8 while half the SMs get one.
  auto blocks = [&](int bq) { return (long long)b * ((n + bq - 1) / bq); };
  if (blocks(32) >= sms) return launch<8>(x, y, r, out, b, n, m, c, k, rel_batch, normalize, vec16, dev, s);
  if (2 * blocks(16) >= sms) return launch<4>(x, y, r, out, b, n, m, c, k, rel_batch, normalize, vec16, dev, s);
  if (2 * blocks(8) >= sms) return launch<2>(x, y, r, out, b, n, m, c, k, rel_batch, normalize, vec16, dev, s);
  return launch<1>(x, y, r, out, b, n, m, c, k, rel_batch, normalize, vec16, dev, s);
}

}  // extern "C"
