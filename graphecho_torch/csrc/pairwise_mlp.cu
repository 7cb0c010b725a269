// Fused pairwise-MLP affinity, forward and backward, for Hopper (sm_90a).
//
//   M[i,j]  = sum_k w2[k] * relu(a[i,k] + b[j,k])          (+ b2 outside)
//   dA[i,k] = w2[k] * sum_j g[i,j] * 1[a_ik + b_jk > 0]
//   dB[j,k] = w2[k] * sum_i g[i,j] * 1[a_ik + b_jk > 0]
//   dw2[k]  = sum_ij g[i,j] * relu(a_ik + b_jk)
//   db2     = sum_ij g[i,j]
//
// Replaces the Pallas TPU kernels of
// graphecho_tpu/ops/pallas/pairwise_mlp_kernel.py: `_fwd_kernel` (via
// `_forward`), `_bwd_da_kernel` and `_bwd_db_kernel` (via `_backward`).
//
// What bounds it on an H100: operations. Each (i, j, k) costs an add, a max,
// a multiply and an accumulate; at the paper shapes (112 or 560 nodes a side,
// K = 512) that is 4*N1*N2*K = 26 or 642 Mop against a few MB of input, so
// the work sits far above the card's ridge point and the FP32 CUDA-core rate
// (67 TFLOP/s) sets the floor. A ReLU sits between the add and the reduction,
// so the sum is not a matrix product and the tensor cores cannot take it.
//
// What the design does about it: the (N1, N2, K) broadcast never exists in
// device memory (the plain version materialises it). Each block stages the
// rows it needs in shared memory in K-chunks (forward) or j/i-chunks
// (backward) and every thread accumulates in registers, so a value read from
// device memory is reused 16 (forward) or 32 (backward) times from shared
// memory. Ragged rows and a ragged K are masked with zeros instead of padded
// to a tile multiple: a zero row of `g` or a zero column of `w2` adds nothing.
// The backward reduction of dw2 and db2 across rows is a second pass in a
// fixed order with no atomics, so repeated runs give identical bits.
//
// Plain C interface, loaded with ctypes. Every entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int FT = 16;   // forward output tile: FT x FT threads, one output each
constexpr int FKC = 64;  // forward K-chunk staged in shared memory

constexpr int BK = 32;   // backward: k columns per block (threadIdx.x)
constexpr int BR = 8;    // backward: output rows per block (threadIdx.y)
constexpr int BC = 32;   // backward: rows of the reduced axis staged per chunk

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

// One thread per (i, k); loops over j. Writes dA and the per-(i, k) partial
// of dw2 (summed over j); `finish_kernel` reduces the partials over i.
__global__ void bwd_da_kernel(const float* __restrict__ a, const float* __restrict__ b,
                              const float* __restrict__ w2, const float* __restrict__ g,
                              float* __restrict__ da, float* __restrict__ dw2_part,
                              int n1, int n2, int k) {
  __shared__ float b_s[BC][BK];
  __shared__ float g_s[BR][BC + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * BK + tx;
  const int kk = blockIdx.x * BK + tx;
  const int i = blockIdx.y * BR + ty;
  const bool live = i < n1 && kk < k;
  const float av = live ? a[(size_t)i * k + kk] : 0.f;
  float acc_m = 0.f, acc_r = 0.f;
  for (int j0 = 0; j0 < n2; j0 += BC) {
    for (int e = tid; e < BC * BK; e += BK * BR) {
      const int r = e / BK, c = e % BK;
      const int j = j0 + r, col = blockIdx.x * BK + c;
      b_s[r][c] = (j < n2 && col < k) ? b[(size_t)j * k + col] : 0.f;
    }
    for (int e = tid; e < BR * BC; e += BK * BR) {
      const int r = e / BC, c = e % BC;
      const int ii = blockIdx.y * BR + r, j = j0 + c;
      g_s[r][c] = (ii < n1 && j < n2) ? g[(size_t)ii * n2 + j] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < BC; ++c) {
      const float t = av + b_s[c][tx];
      const float gv = g_s[ty][c];
      if (t > 0.f) {
        acc_m += gv;
        acc_r = fmaf(gv, t, acc_r);
      }
    }
    __syncthreads();
  }
  if (live) {
    da[(size_t)i * k + kk] = w2[kk] * acc_m;
    dw2_part[(size_t)i * k + kk] = acc_r;
  }
}

// One thread per (j, k); loops over i.
__global__ void bwd_db_kernel(const float* __restrict__ a, const float* __restrict__ b,
                              const float* __restrict__ w2, const float* __restrict__ g,
                              float* __restrict__ db, int n1, int n2, int k) {
  __shared__ float a_s[BC][BK];
  __shared__ float g_s[BR][BC + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * BK + tx;
  const int kk = blockIdx.x * BK + tx;
  const int j = blockIdx.y * BR + ty;
  const bool live = j < n2 && kk < k;
  const float bv = live ? b[(size_t)j * k + kk] : 0.f;
  float acc_m = 0.f;
  for (int i0 = 0; i0 < n1; i0 += BC) {
    for (int e = tid; e < BC * BK; e += BK * BR) {
      const int r = e / BK, c = e % BK;
      const int i = i0 + r, col = blockIdx.x * BK + c;
      a_s[r][c] = (i < n1 && col < k) ? a[(size_t)i * k + col] : 0.f;
    }
    // g is (n1, n2) row-major: neighbouring threads take neighbouring j
    for (int e = tid; e < BR * BC; e += BK * BR) {
      const int r = e % BR, c = e / BR;
      const int jj = blockIdx.y * BR + r, i = i0 + c;
      g_s[r][c] = (jj < n2 && i < n1) ? g[(size_t)i * n2 + jj] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < BC; ++c) {
      if (a_s[c][tx] + bv > 0.f) acc_m += g_s[ty][c];
    }
    __syncthreads();
  }
  if (live) db[(size_t)j * k + kk] = w2[kk] * acc_m;
}

constexpr int FIN_THREADS = 256;

// Blocks [0, nk): dw2[k] = sum_i dw2_part[i, k], one thread per k, i in order.
// Block nk: db2 = sum of g, strided per thread then a fixed tree.
__global__ void finish_kernel(const float* __restrict__ dw2_part,
                              const float* __restrict__ g, float* __restrict__ dw2,
                              float* __restrict__ db2, int n1, int n2, int k, int nk) {
  if (blockIdx.x < nk) {
    const int kk = blockIdx.x * FIN_THREADS + threadIdx.x;
    if (kk >= k) return;
    float s = 0.f;
    for (int i = 0; i < n1; ++i) s += dw2_part[(size_t)i * k + kk];
    dw2[kk] = s;
    return;
  }
  __shared__ float part[FIN_THREADS];
  const size_t total = (size_t)n1 * n2;
  float s = 0.f;
  for (size_t e = threadIdx.x; e < total; e += FIN_THREADS) s += g[e];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int w = FIN_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) db2[0] = part[0];
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

// dA, dw2 and db2: the per-(i, k) pass, then the fixed-order reduction pass.
// `dw2_part` is (n1, k) scratch.
int pairwise_mlp_bwd_da(const float* a, const float* b, const float* w2,
                        const float* g, float* da, float* dw2_part, float* dw2,
                        float* db2, int n1, int n2, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(BK, BR);
  const dim3 grid((k + BK - 1) / BK, (n1 + BR - 1) / BR);
  bwd_da_kernel<<<grid, block, 0, s>>>(a, b, w2, g, da, dw2_part, n1, n2, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nk = (k + FIN_THREADS - 1) / FIN_THREADS;
  finish_kernel<<<nk + 1, FIN_THREADS, 0, s>>>(dw2_part, g, dw2, db2, n1, n2, k, nk);
  return static_cast<int>(cudaGetLastError());
}

int pairwise_mlp_bwd_db(const float* a, const float* b, const float* w2,
                        const float* g, float* db, int n1, int n2, int k,
                        void* stream) {
  const dim3 block(BK, BR);
  const dim3 grid((k + BK - 1) / BK, (n2 + BR - 1) / BR);
  bwd_db_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, w2, g, db, n1, n2, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
