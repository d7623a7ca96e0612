// Flat-plane kernels (global top-k select, stochastic quantization, the
// weighted commit of the asynchronous server), for Hopper.
//
// Replace the Pallas TPU kernels of repro/kernels/plane_ops.py:
//   * _threshold_kernel (threshold_select_3d): for each element of a
//     contiguous (n_rows, d_pad) plane,
//         out = |x| >= thresh[row] ? x : 0
//     -- the select half of global top-k, after the per-row k-th magnitude
//     has been found (torch.topk, outside the kernel);
//   * _quantize_kernel (quantize_3d): given uniform draws u and a per-row
//     scale,
//         s = scale[row] == 0 ? 1 : scale[row]
//         y = x / s * L,  lo = floor(y),  q = lo + (u < y - lo),
//         out = q / L * s;
//   * _commit_kernel (weighted_commit_3d): the weighted client-axis sum of
//     an (n_rows, d_pad) report plane,
//         out[j] = sum_i w[i] * x[i, j],   i = 0 .. n_rows - 1 in order,
//     the reduction of the buffered commit's server half.
//
// Bound: all three are passes bound by device memory. The select reads x
// once and writes out once (2 moves of n * itemsize bytes), the quantizer
// reads x and u and writes out (3 moves), the commit reads the plane once
// and writes one row (n_rows + 1 moves of d_pad * itemsize bytes); a
// handful of operations per element against 67 (fp32) / 34 (fp64) TFLOP/s
// is far below the bytes. Design for that bound: one grid-stride launch
// over the whole plane (no per-row or per-leaf launches, no lane padding),
// 16-byte vector loads and stores where every pointer is aligned, a scalar
// loop for the ragged tail. In the select and the quantizer the row of an
// element is i / d_pad, computed once per vector and carried across row
// boundaries inside the vector; the per-row scalars are read through the
// cache (30 rows: a few hundred bytes). The commit gives each thread one
// 16-byte vector of columns and walks the rows in order, so each row is
// read coalesced across the warp and the sum needs no cross-thread
// reduction and no atomics: it is deterministic and adds in the plain
// version's order.
//
// Rounding: the results must equal the plain PyTorch versions
// (repro_torch/kernels/plane_ops.py) bitwise, so every add, subtract,
// multiply and divide is an explicit round-to-nearest intrinsic (never an
// FMA, never an approximate division; the build passes -fmad=false), and
// floor is exact. float and double compute in their own type; bfloat16 and
// half compute in float and round once at the store (the select passes x
// through untouched). The commit's weights come in the compute type
// (float64 for float64 planes, float otherwise), as repro/kernels/ref.py
// computes in the plane's dtype; the Pallas kernel takes them, and sums,
// in float32 for every dtype. NaN follows IEEE: |NaN| >= t is false, so
// the select writes 0.
//
// Plain C interface (loaded with ctypes): no PyTorch headers. Each launch
// goes on the caller's stream, allocates nothing, and the entry returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float abs_w(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_w(double a) { return fabs(a); }
__device__ __forceinline__ float floor_w(float a) { return floorf(a); }
__device__ __forceinline__ double floor_w(double a) { return floor(a); }

// Storage type <-> compute type.
__device__ __forceinline__ float load_w(float x) { return x; }
__device__ __forceinline__ double load_w(double x) { return x; }
__device__ __forceinline__ float load_w(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float load_w(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T store_t(float x);
template <typename T> __device__ __forceinline__ T store_t(double x);
template <> __device__ __forceinline__ float store_t<float>(float x) { return x; }
template <> __device__ __forceinline__ double store_t<double>(double x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 store_t<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half store_t<__half>(float x) {
  return __float2half_rn(x);
}

template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

// out = |x| >= t ? x : +0 (x passes through bit for bit).
template <typename T, typename W>
__device__ __forceinline__ T select_one(T x, W t) {
  return abs_w(load_w(x)) >= t ? x : store_t<T>(W(0));
}

template <typename W>
__device__ __forceinline__ W quantize_one(W x, W u, W s, W L) {
  const W y = mul_rn(div_rn(x, s), L);
  const W lo = floor_w(y);
  const W q = add_rn(lo, (u < sub_rn(y, lo)) ? W(1) : W(0));
  return mul_rn(div_rn(q, L), s);
}

// thresh: per-row thresholds in x's storage type (the reference casts the
// threshold to x's dtype before comparing), read in the compute type W.
template <typename T, typename W>
__global__ void threshold_select_kernel(const T* __restrict__ x, const T* __restrict__ thresh,
                                        T* __restrict__ out, int64_t n, int64_t d_pad,
                                        bool vectorized) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t head = 0;
  if (vectorized) {
    constexpr int N = Vec<T>::N;
    const int64_t nvec = n / N;
    const Vec<T>* x_v = reinterpret_cast<const Vec<T>*>(x);
    Vec<T>* out_v = reinterpret_cast<Vec<T>*>(out);
    for (int64_t i = tid; i < nvec; i += stride) {
      const int64_t base = i * N;
      int64_t row = base / d_pad;
      int64_t col = base - row * d_pad;
      W t = load_w(thresh[row]);
      const Vec<T> a = x_v[i];
      Vec<T> o;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        if (col == d_pad) {  // the vector crosses into the next row
          ++row;
          col = 0;
          t = load_w(thresh[row]);
        }
        o.v[k] = select_one<T, W>(a.v[k], t);
        ++col;
      }
      out_v[i] = o;
    }
    head = nvec * N;
  }
  for (int64_t i = head + tid; i < n; i += stride) {
    out[i] = select_one<T, W>(x[i], load_w(thresh[i / d_pad]));
  }
}

// scale: per-row scales in the compute type W (double for float64, float
// otherwise); a zero scale quantizes as 1.
template <typename W>
__device__ __forceinline__ W scale_of(const W* scale, int64_t row) {
  const W s = scale[row];
  return s == W(0) ? W(1) : s;
}

template <typename T, typename W>
__global__ void quantize_kernel(const T* __restrict__ x, const T* __restrict__ u,
                                const W* __restrict__ scale, T* __restrict__ out, int64_t n,
                                int64_t d_pad, W L, bool vectorized) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t head = 0;
  if (vectorized) {
    constexpr int N = Vec<T>::N;
    const int64_t nvec = n / N;
    const Vec<T>* x_v = reinterpret_cast<const Vec<T>*>(x);
    const Vec<T>* u_v = reinterpret_cast<const Vec<T>*>(u);
    Vec<T>* out_v = reinterpret_cast<Vec<T>*>(out);
    for (int64_t i = tid; i < nvec; i += stride) {
      const int64_t base = i * N;
      int64_t row = base / d_pad;
      int64_t col = base - row * d_pad;
      W s = scale_of(scale, row);
      const Vec<T> a = x_v[i], b = u_v[i];
      Vec<T> o;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        if (col == d_pad) {
          ++row;
          col = 0;
          s = scale_of(scale, row);
        }
        o.v[k] = store_t<T>(quantize_one<W>(load_w(a.v[k]), load_w(b.v[k]), s, L));
        ++col;
      }
      out_v[i] = o;
    }
    head = nvec * N;
  }
  for (int64_t i = head + tid; i < n; i += stride) {
    const W s = scale_of(scale, i / d_pad);
    out[i] = store_t<T>(quantize_one<W>(load_w(x[i]), load_w(u[i]), s, L));
  }
}

// w: per-row weights in the compute type W; out: (d_pad,) in T.
template <typename T, typename W>
__global__ void weighted_commit_kernel(const T* __restrict__ x, const W* __restrict__ w,
                                       T* __restrict__ out, int64_t n_rows, int64_t d_pad,
                                       bool vectorized) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t head = 0;
  if (vectorized) {  // every row starts on a 16-byte boundary
    constexpr int N = Vec<T>::N;
    const int64_t nvec = d_pad / N;
    for (int64_t v = tid; v < nvec; v += stride) {
      W acc[N];
#pragma unroll
      for (int k = 0; k < N; ++k) acc[k] = W(0);
      for (int64_t i = 0; i < n_rows; ++i) {
        const Vec<T> a = reinterpret_cast<const Vec<T>*>(x + i * d_pad)[v];
        const W wi = w[i];
#pragma unroll
        for (int k = 0; k < N; ++k) acc[k] = add_rn(acc[k], mul_rn(wi, load_w(a.v[k])));
      }
      Vec<T> o;
#pragma unroll
      for (int k = 0; k < N; ++k) o.v[k] = store_t<T>(acc[k]);
      reinterpret_cast<Vec<T>*>(out)[v] = o;
    }
    head = nvec * N;
  }
  for (int64_t j = head + tid; j < d_pad; j += stride) {
    W acc = W(0);
    for (int64_t i = 0; i < n_rows; ++i) acc = add_rn(acc, mul_rn(w[i], load_w(x[i * d_pad + j])));
    out[j] = store_t<T>(acc);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

constexpr int kThreads = 256;

template <typename T>
unsigned grid_for(int64_t n, bool vec) {
  const int64_t work = vec ? n / Vec<T>::N + Vec<T>::N : n;  // vectors + tail
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;  // grid-stride beyond this
  return static_cast<unsigned>(blocks);
}

template <typename T, typename W>
int launch_select(const void* x, const void* thresh, void* out, int64_t n_rows, int64_t d_pad,
                  cudaStream_t stream) {
  const int64_t n = n_rows * d_pad;
  const bool vec = aligned16(x) && aligned16(out);
  const unsigned grid = grid_for<T>(n, vec);
  const T* xs = static_cast<const T*>(x);
  const T* ts = static_cast<const T*>(thresh);
  T* os = static_cast<T*>(out);
  threshold_select_kernel<T, W><<<grid, kThreads, 0, stream>>>(xs, ts, os, n, d_pad, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename W>
int launch_quantize(const void* x, const void* u, const void* scale, void* out, int64_t n_rows,
                    int64_t d_pad, int levels, cudaStream_t stream) {
  const int64_t n = n_rows * d_pad;
  const bool vec = aligned16(x) && aligned16(u) && aligned16(out);
  const unsigned grid = grid_for<T>(n, vec);
  const T* xs = static_cast<const T*>(x);
  const T* us = static_cast<const T*>(u);
  const W* ss = static_cast<const W*>(scale);
  T* os = static_cast<T*>(out);
  const W L = static_cast<W>(levels);
  quantize_kernel<T, W><<<grid, kThreads, 0, stream>>>(xs, us, ss, os, n, d_pad, L, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename W>
int launch_commit(const void* x, const void* w, void* out, int64_t n_rows, int64_t d_pad,
                  cudaStream_t stream) {
  const bool vec = aligned16(x) && aligned16(out) && (d_pad * int64_t(sizeof(T))) % 16 == 0;
  const unsigned grid = grid_for<T>(d_pad, vec);
  weighted_commit_kernel<T, W><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(out), n_rows, d_pad,
      vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 float32, 1 float64, 2 bfloat16, 3 float16.
// thresh: (n_rows,) in x's dtype.
extern "C" int repro_threshold_select(int dtype, const void* x, const void* thresh, void* out,
                                      int64_t n_rows, int64_t d_pad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0 || d_pad <= 0) return 0;
  switch (dtype) {
    case 0: return launch_select<float, float>(x, thresh, out, n_rows, d_pad, s);
    case 1: return launch_select<double, double>(x, thresh, out, n_rows, d_pad, s);
    case 2: return launch_select<__nv_bfloat16, float>(x, thresh, out, n_rows, d_pad, s);
    case 3: return launch_select<__half, float>(x, thresh, out, n_rows, d_pad, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// u: (n_rows, d_pad) in x's dtype; scale: (n_rows,) in double for float64,
// float otherwise.
extern "C" int repro_quantize(int dtype, const void* x, const void* u, const void* scale,
                              void* out, int64_t n_rows, int64_t d_pad, int levels,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0 || d_pad <= 0) return 0;
  switch (dtype) {
    case 0: return launch_quantize<float, float>(x, u, scale, out, n_rows, d_pad, levels, s);
    case 1: return launch_quantize<double, double>(x, u, scale, out, n_rows, d_pad, levels, s);
    case 2:
      return launch_quantize<__nv_bfloat16, float>(x, u, scale, out, n_rows, d_pad, levels, s);
    case 3: return launch_quantize<__half, float>(x, u, scale, out, n_rows, d_pad, levels, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// w: (n_rows,) in double for float64, float otherwise; out: (d_pad,) in x's
// dtype.
extern "C" int repro_weighted_commit(int dtype, const void* x, const void* w, void* out,
                                     int64_t n_rows, int64_t d_pad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0 || d_pad <= 0) return 0;
  switch (dtype) {
    case 0: return launch_commit<float, float>(x, w, out, n_rows, d_pad, s);
    case 1: return launch_commit<double, double>(x, w, out, n_rows, d_pad, s);
    case 2: return launch_commit<__nv_bfloat16, float>(x, w, out, n_rows, d_pad, s);
    case 3: return launch_commit<__half, float>(x, w, out, n_rows, d_pad, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
