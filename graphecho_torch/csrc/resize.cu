// The FPN's align-corners bilinear resize for Hopper (sm_90a), with the
// top-down add fused: for an input x (N, C, Hi, Wi), NCHW or channels-last
// (NHWC in memory), and, optionally, an addend y of the output's shape
// (N, C, Ho, Wo) in the same layout,
//
//   scale = out > 1 ? float(in - 1) / float(out - 1) : 0     (per axis)
//   src   = scale * dst,  i0 = int(src),  ip = i0 < in - 1,
//   l1    = src - i0,     l0 = 1 - l1
//   val   = h0 * (w0 * x[i0][j0] + w1 * x[i0][j0 + jp])
//         + h1 * (w0 * x[i0 + ip][j0] + w1 * x[i0 + ip][j0 + jp])
//   out   = T(val),  or T(float(T(val)) + float(y)) with the addend
//
// in f32 arithmetic for f32 and bf16 tensors. That is PyTorch's own
// `upsample_bilinear2d_out_frame` and `upsample_bilinear2d_nhwc_out_frame`
// (ATen's UpSample.cuh and UpSampleBilinear2d.cu), operation for operation,
// multiply-adds fused as PyTorch's build fuses them, so the output has
// `F.interpolate(..., mode="bilinear", align_corners=True)`'s bits, and with
// the addend the bits of that resize followed by `+ y` (PyTorch's add rounds
// float(a) + float(b) once). Where both axes keep their size there is nothing
// to compute: the entry point refuses that call.
//
// It replaces no TPU kernel: the JAX package writes this resize as two
// interpolation-matrix products left to XLA (graphecho_tpu/ops/resize.py).
// It was added because PyTorch's NCHW kernel gives one thread each output
// pixel and loops it over every (frame, channel) pair: at the FPN's small
// maps (28^2 = 784 threads for 168 x 256 planes, 7^2 = 49 threads, one block
// on one of 132 SMs) the card stays almost empty, and the resizes took the
// largest share of a camus train step's device time (PERF.md, section 5).
//
// What bounds it on an H100: bytes. Each output element costs four input
// reads that neighbouring elements share (from L1 and L2), one addend read
// and one store; a camus step's head moves ~0.8 GB (0.24 ms at 3.35 TB/s).
// At one output a thread the index arithmetic (two divisions by runtime
// sizes) and the weights cost ~90 instructions an element, and the first
// version ran at 8-44% of the bytes bound, bound by instructions.
//
// What the design does about it:
//  * Every output element is one thread's work, over all N x C x Ho x Wo of
//    them, so every call fills the card whatever its map size. A thread takes
//    a run of VEC = 4 neighbours in memory where the innermost size allows
//    (one 16- or 8-byte store, one addend load), else one. Consecutive
//    threads run along memory: stores and addend reads are coalesced.
//    NCHW: a run is 4 columns of one output row, which share its vertical
//    weights and offsets, and a warp reads the same one or two input rows.
//    Channels-last: a run is 4 channels of one output pixel, which share all
//    its weights and offsets, and a warp reads four pixels' channel vectors.
//  * Divisions by the run count of a row (or a pixel), Wo and Ho by a
//    multiply-high and a shift with multipliers computed on the host (as
//    ATen's IntDivider), in 32-bit index arithmetic where the tensors allow
//    it; 64-bit division beyond.
//  * The addend is read and added in the same pass, so the top-down merge
//    writes its sum once instead of writing the resize and reading it back.
//
// Plain C interface, loaded with ctypes. The entry point launches one kernel
// on the given stream of the given device, allocates nothing, and returns a
// CUDA error code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 1LL << 24;  // a grid-stride loop covers the rest

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as c10::BFloat16 on the card
}

// PyTorch's interpolation, its multiply-adds spelled out as nvcc contracted
// them in PyTorch's own build, so that no compiler contracts them otherwise.
// Its NCHW kernel fuses w0 * a + w1 * b as fma(w0, a, w1 * b), the bottom row
// and the rows' sum (h0, h1) alike. Its NHWC kernel, which F.interpolate
// takes for a channels-last input of 16 channels or more, does the same in
// bf16, but in f32 fuses the top row as fma(w1, b, w0 * a) (W1_FIRST). Of the
// 27 ways to contract the expression, each of these is the only one that
// gave its kernel's bits on the card (PyTorch 2.11 built with CUDA 12.8,
// this file with nvcc 12.9).
template <bool W1_FIRST>
__device__ __forceinline__ float lerp2d(float h0, float h1, float w0, float w1, float a, float b,
                                        float c, float d) {
  const float top = W1_FIRST ? __fmaf_rn(w1, b, __fmul_rn(w0, a))
                             : __fmaf_rn(w0, a, __fmul_rn(w1, b));
  const float bottom = __fmaf_rn(w0, c, __fmul_rn(w1, d));
  return __fmaf_rn(h0, top, __fmul_rn(h1, bottom));
}

// one output index's source along an axis, as PyTorch computes it: the
// first source index, the step to the second (0 at the edge), the weights
struct Source {
  int i, step;
  float l0, l1;
};

__device__ __forceinline__ Source source(float scale, int dst, int in) {
  const float r = scale * dst;
  const int i = static_cast<int>(r);
  const float l1 = r - i;
  return {i, i < in - 1 ? 1 : 0, 1.0f - l1, l1};
}

// n / d for 0 <= n < 2^31: a multiply-high and a shift (ATen's IntDivider)
struct Div32 {
  unsigned d, m, s;
  __device__ __forceinline__ int operator()(int n) const {
    return static_cast<int>((__umulhi(static_cast<unsigned>(n), m) + static_cast<unsigned>(n)) >> s);
  }
};

Div32 make_div32(unsigned d) {
  unsigned s = 0;
  while ((1ull << s) < d) ++s;
  const unsigned long long m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return {d, static_cast<unsigned>(m), s};
}

struct Div64 {
  long long d;
  __device__ __forceinline__ long long operator()(long long n) const { return n / d; }
};

template <typename I>
struct DivOf;
template <>
struct DivOf<int> { using type = Div32; };
template <>
struct DivOf<long long> { using type = Div64; };

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// `runs` = N x C x Ho x Wo / VEC, in memory order. NCHW: run r covers columns
// VEC * (r mod Wo/VEC) onwards of output row r div (Wo/VEC) (`per_run` =
// Wo/VEC; `w_div` unused). Channels-last: channels VEC * (r mod C/VEC)
// onwards of output pixel r div (C/VEC) (`per_run` = C/VEC).
template <typename T, typename I, int VEC, bool ADD, bool CL, bool W1_FIRST>
__global__ void __launch_bounds__(THREADS)
    resize_bilinear_kernel(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out,
                           I runs, typename DivOf<I>::type per_run, typename DivOf<I>::type w_div,
                           typename DivOf<I>::type h_div, int channels, int h_in, int w_in,
                           float rh, float rw) {
  const I stride = static_cast<I>(gridDim.x) * THREADS;
  for (I r = static_cast<I>(blockIdx.x) * THREADS + threadIdx.x; r < runs; r += stride) {
    const I line = per_run(r);  // the output row (NCHW) or pixel (channels-last)
    const int first = static_cast<int>(r - line * static_cast<I>(per_run.d)) * VEC;
    I plane;  // n x C + c (NCHW) or n (channels-last)
    int h2, w2;
    if constexpr (CL) {
      const I nh = w_div(line);
      w2 = static_cast<int>(line - nh * static_cast<I>(w_div.d));
      plane = h_div(nh);
      h2 = static_cast<int>(nh - plane * static_cast<I>(h_div.d));
    } else {
      plane = h_div(line);
      h2 = static_cast<int>(line - plane * static_cast<I>(h_div.d));
      w2 = first;
    }
    const Source h = source(rh, h2, h_in);
    float val[VEC];
    if constexpr (CL) {
      const Source w = source(rw, w2, w_in);
      const T* top = x + ((plane * h_in + h.i) * w_in + w.i) * static_cast<I>(channels) + first;
      const T* bottom = top + static_cast<I>(h.step) * w_in * channels;
      const int dw = w.step * channels;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        val[k] = lerp2d<W1_FIRST>(h.l0, h.l1, w.l0, w.l1, to_float(top[k]),
                                  to_float(top[k + dw]), to_float(bottom[k]),
                                  to_float(bottom[k + dw]));
      }
    } else {
      const T* top = x + (plane * h_in + h.i) * static_cast<I>(w_in);
      const T* bottom = top + h.step * w_in;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const Source w = source(rw, w2 + k, w_in);
        val[k] = lerp2d<false>(h.l0, h.l1, w.l0, w.l1, to_float(top[w.i]),
                               to_float(top[w.i + w.step]), to_float(bottom[w.i]),
                               to_float(bottom[w.i + w.step]));
      }
    }
    Pack<T, VEC> o;
    Pack<T, VEC> add;
    if (ADD) add = reinterpret_cast<const Pack<T, VEC>*>(y)[r];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      o.v[k] = from_float<T>(val[k]);
      if (ADD) o.v[k] = from_float<T>(__fadd_rn(to_float(o.v[k]), to_float(add.v[k])));
    }
    reinterpret_cast<Pack<T, VEC>*>(out)[r] = o;
  }
}

// PyTorch's `area_pixel_compute_scale` with align_corners, on the host
float align_corners_scale(int in, int out) {
  return out > 1 ? static_cast<float>(in - 1) / static_cast<float>(out - 1) : 0.0f;
}

Div32 make_div(int d, int*) { return make_div32(static_cast<unsigned>(d)); }
Div64 make_div(int d, long long*) { return {d}; }

struct Shape {
  long long n;
  int c, h_in, w_in, h_out, w_out;
};

// PyTorch's NHWC kernel serves channels-last inputs of 16 channels or more
// (UpSampleBilinear2d.cu); fewer go through its NCHW kernel
constexpr int PYTORCH_NHWC_CHANNELS = 16;

// whether PyTorch fuses the top row w1 first for this call (see lerp2d)
template <typename T, bool CL>
bool w1_first(const Shape& s) {
  return CL && std::is_same<T, float>::value && s.c >= PYTORCH_NHWC_CHANNELS;
}

template <typename T, typename I, int VEC, bool ADD, bool CL>
void launch_kernel(const T* x, const T* y, T* out, long long runs, const Shape& s, dim3 grid,
                   cudaStream_t stream) {
  const float rh = align_corners_scale(s.h_in, s.h_out), rw = align_corners_scale(s.w_in, s.w_out);
  I* tag = nullptr;
  const auto per_run = make_div((CL ? s.c : s.w_out) / VEC, tag);
  const auto w_div = make_div(s.w_out, tag);
  const auto h_div = make_div(s.h_out, tag);
  if (w1_first<T, CL>(s)) {
    resize_bilinear_kernel<T, I, VEC, ADD, CL, true><<<grid, THREADS, 0, stream>>>(
        x, y, out, static_cast<I>(runs), per_run, w_div, h_div, s.c, s.h_in, s.w_in, rh, rw);
  } else {
    resize_bilinear_kernel<T, I, VEC, ADD, CL, false><<<grid, THREADS, 0, stream>>>(
        x, y, out, static_cast<I>(runs), per_run, w_div, h_div, s.c, s.h_in, s.w_in, rh, rw);
  }
}

template <typename T, typename I, int VEC, bool CL>
int launch(const T* x, const T* y, T* out, const Shape& s, cudaStream_t stream) {
  const long long runs = s.n * s.c * s.h_out * s.w_out / VEC;
  long long blocks = (runs + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (y != nullptr) {
    launch_kernel<T, I, VEC, true, CL>(x, y, out, runs, s, grid, stream);
  } else {
    launch_kernel<T, I, VEC, false, CL>(x, y, out, runs, s, grid, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename I, bool CL>
int launch_vec(const T* x, const T* y, T* out, const Shape& s, cudaStream_t stream) {
  constexpr uintptr_t align = sizeof(Pack<T, 4>);
  if ((CL ? s.c : s.w_out) % 4 == 0 && reinterpret_cast<uintptr_t>(out) % align == 0 &&
      reinterpret_cast<uintptr_t>(y) % align == 0) {
    return launch<T, I, 4, CL>(x, y, out, s, stream);
  }
  return launch<T, I, 1, CL>(x, y, out, s, stream);
}

template <typename T, bool CL>
int launch_typed(const void* x, const void* y, void* out, const Shape& s, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  T* ot = static_cast<T*>(out);
  // every run index, r + stride, and every input offset stay below 2^31
  // while neither tensor passes 2^30 elements
  const long long nc = s.n * s.c;
  if (nc * s.h_out * s.w_out <= (1LL << 30) && nc * s.h_in * s.w_in <= (1LL << 30)) {
    return launch_vec<T, int, CL>(xt, yt, ot, s, stream);
  }
  return launch_vec<T, long long, CL>(xt, yt, ot, s, stream);
}

template <typename T>
int launch_layout(const void* x, const void* y, void* out, const Shape& s, int channels_last,
                  cudaStream_t stream) {
  return channels_last ? launch_typed<T, true>(x, y, out, s, stream)
                       : launch_typed<T, false>(x, y, out, s, stream);
}

}  // namespace

extern "C" {

// x (n, c, h_in, w_in), y null or (n, c, h_out, w_out), out (n, c, h_out,
// w_out), all three dense in one layout: NCHW (channels_last = 0) or NHWC
// (channels_last = 1); float32 (bf16 = 0) or bfloat16 (bf16 = 1), on CUDA
// device `device`; launched on `stream`, a stream of that device. At
// least one axis changes its size.
int resize_bilinear(const void* x, const void* y, void* out, long long n, int c, int h_in,
                    int w_in, int h_out, int w_out, int bf16, int channels_last, int device,
                    void* stream) {
  if (n < 1 || c < 1 || h_in < 1 || w_in < 1 || h_out < 1 || w_out < 1 ||
      (h_in == h_out && w_in == w_out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const Shape s{n, c, h_in, w_in, h_out, w_out};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int launched = bf16 ? launch_layout<__nv_bfloat16>(x, y, out, s, channels_last, st)
                            : launch_layout<float>(x, y, out, s, channels_last, st);
  if (current != device && (err = cudaSetDevice(current)) != cudaSuccess && launched == 0) {
    return static_cast<int>(err);
  }
  return launched;
}

}  // extern "C"
