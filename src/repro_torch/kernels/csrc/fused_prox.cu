// Fused local update + L1 proximal step (Algorithm 1, lines 9-10), for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_prox.py:_kernel
// (fused_local_update_2d).  For each element of a contiguous plane:
//
//     z_hat' = z_hat - eta * (g + c)
//     z'     = sign(z_hat') * max(|z_hat'| - thresh, 0)
//
// Bound: the kernel moves 5 tensors of n * itemsize bytes (reads z_hat, g, c
// once, writes z_hat', z' once) and does ~10 operations per element, so it
// is bound by device memory: 5 * n * itemsize / 3.35 TB/s on an H100 SXM.
// Design for that bound: one launch over the whole (n_clients, d_pad) plane
// (no per-client or per-leaf launches), 16-byte vector loads and stores
// where all five pointers are aligned, a scalar loop for the ragged tail,
// nothing staged through shared memory (each element is used once).
//
// Rounding: the result must equal the plain PyTorch version
// (repro_torch/kernels/fused_prox.py:fused_local_update_plain) bitwise, so
// every add, multiply and subtract is an explicit round-to-nearest intrinsic
// (never contracted into an FMA), and the sign/max are written the way
// PyTorch's own kernels compute torch.sign and torch.clamp_min, which fixes
// the results for -0.0 and NaN too.  float and double compute in their own
// type; bfloat16 and half compute in float and round once at each store.
//
// Plain C interface (loaded with ctypes): no PyTorch headers, so nvcc
// builds this file in seconds.  The launch goes on the caller's stream, the
// kernel allocates nothing, and the entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float abs_w(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_w(double a) { return fabs(a); }

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

// One element: returns z_hat' and z' in the compute type W.
template <typename W>
__device__ __forceinline__ void step(W zh, W g, W c, W eta, W thresh, W* zh_new, W* z_new) {
  const W zero = W(0);
  const W u = sub_rn(zh, mul_rn(eta, add_rn(g, c)));
  // torch.sign: (0 < u) - (u < 0); NaN -> 0, -0.0 -> +0.0
  const W s = W(int(zero < u) - int(u < zero));
  // torch.clamp_min(a, 0): NaN passes through, else max(a, 0)
  const W a = sub_rn(abs_w(u), thresh);
  const W m = (a != a) ? a : (a > zero ? a : zero);
  *zh_new = u;
  *z_new = mul_rn(s, m);
}

template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

template <typename T, typename W>
__global__ void fused_prox_kernel(const T* __restrict__ zh, const T* __restrict__ g,
                                  const T* __restrict__ c, T* __restrict__ zh_out,
                                  T* __restrict__ z_out, W eta, W thresh, int64_t n,
                                  bool vectorized) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  const int64_t tid = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t head = 0;
  if (vectorized) {
    constexpr int N = Vec<T>::N;
    const int64_t nvec = n / N;
    const Vec<T>* zh_v = reinterpret_cast<const Vec<T>*>(zh);
    const Vec<T>* g_v = reinterpret_cast<const Vec<T>*>(g);
    const Vec<T>* c_v = reinterpret_cast<const Vec<T>*>(c);
    Vec<T>* zh_out_v = reinterpret_cast<Vec<T>*>(zh_out);
    Vec<T>* z_out_v = reinterpret_cast<Vec<T>*>(z_out);
    for (int64_t i = tid; i < nvec; i += stride) {
      const Vec<T> a = zh_v[i], b = g_v[i], d = c_v[i];
      Vec<T> o1, o2;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        W u, z;
        step<W>(load_w(a.v[k]), load_w(b.v[k]), load_w(d.v[k]), eta, thresh, &u, &z);
        o1.v[k] = store_t<T>(u);
        o2.v[k] = store_t<T>(z);
      }
      zh_out_v[i] = o1;
      z_out_v[i] = o2;
    }
    head = nvec * N;
  }
  for (int64_t i = head + tid; i < n; i += stride) {
    W u, z;
    step<W>(load_w(zh[i]), load_w(g[i]), load_w(c[i]), eta, thresh, &u, &z);
    zh_out[i] = store_t<T>(u);
    z_out[i] = store_t<T>(z);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T, typename W>
int launch(const void* zh, const void* g, const void* c, void* zh_out, void* z_out,
           int64_t n, double eta, double thresh, cudaStream_t stream) {
  const bool vec = aligned16(zh) && aligned16(g) && aligned16(c) && aligned16(zh_out) &&
                   aligned16(z_out);
  constexpr int threads = 256;
  const int64_t work = vec ? n / Vec<T>::N + Vec<T>::N : n;  // vectors + tail
  int64_t blocks = (work + threads - 1) / threads;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;  // grid-stride beyond this
  fused_prox_kernel<T, W><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const T*>(zh), static_cast<const T*>(g), static_cast<const T*>(c),
      static_cast<T*>(zh_out), static_cast<T*>(z_out), static_cast<W>(eta),
      static_cast<W>(thresh), n, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 float32, 1 float64, 2 bfloat16, 3 float16.
// eta and thresh arrive as doubles and are rounded to the compute type
// (float for codes 0, 2, 3), as PyTorch rounds a Python scalar.
extern "C" int repro_fused_local_update(int dtype, const void* zh, const void* g,
                                        const void* c, void* zh_out, void* z_out,
                                        int64_t n, double eta, double thresh,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  switch (dtype) {
    case 0: return launch<float, float>(zh, g, c, zh_out, z_out, n, eta, thresh, s);
    case 1: return launch<double, double>(zh, g, c, zh_out, z_out, n, eta, thresh, s);
    case 2: return launch<__nv_bfloat16, float>(zh, g, c, zh_out, z_out, n, eta, thresh, s);
    case 3: return launch<__half, float>(zh, g, c, zh_out, z_out, n, eta, thresh, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
