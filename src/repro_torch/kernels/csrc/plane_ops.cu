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
//     an (n_rows, n_cols) report plane,
//         out[j] = sum_i w[i] * x[i, j],   i = 0 .. n_rows - 1 in order,
//     the reduction of the buffered commit's server half.
//
// Bound: all three are passes bound by device memory. The select reads x
// once and writes out once (2 moves of n * itemsize bytes), the quantizer
// reads x and u and writes out (3 moves), the commit reads the plane once
// and writes one row (n_rows + 1 moves of n_cols * itemsize bytes); a
// handful of operations per element against 67 (fp32) / 34 (fp64) TFLOP/s
// is far below the bytes.
//
// The select and the quantizer: one grid-stride launch over the whole plane
// (no per-row or per-leaf launches, no lane padding), 16-byte vector loads
// and stores where every pointer is aligned, a scalar loop for the ragged
// tail. The row of an element is i / d_pad, computed once per vector and
// carried across row boundaries inside the vector; the per-row scalars are
// read through the cache (30 rows: a few hundred bytes).
//
// The commit: at the paper's plane, (30, 128) float64, the 30 KB take less
// than 10 ns at 3.35 TB/s, so what bounds the call there is latency: one
// launch and one round trip to L2 or memory. So every row of a block's
// column tile is in flight at once. A block owns one 1 KB segment of
// columns (128 consumer threads, 8 bytes of columns each); warp 0 stages
// the rows through shared memory with bulk asynchronous copies
// (cp.async.bulk, one row segment a lane) into a ring of kSlots slots of
// kRows rows, each slot completed on its own mbarrier, so the paper's 30
// rows are one round trip, not 30. The consumers read a slot's rows from
// shared memory all at once and add them in order into registers (no
// cross-thread reduction, no atomics: deterministic, in the plain version's
// order), then store their 8 bytes. The weights are read once per block in the caller's dtype,
// converted as Tensor.to converts them (float -> double exactly, double ->
// float by __double2float_rn), and kept in shared memory. A plane of more
// than kSlots * kRows rows walks the ring: a slot is refilled once every
// consumer has read it. The grid is one block per column segment: one
// block at the paper's plane, 879 at the wide (30, 112,512) float64 plane
// (one wave of at most seven a SM), 16,384 at (30, 4,194,304) float32. A plane whose row starts
// or width are not 16-byte aligned (a view at an odd offset, a row of 1,001
// float64) takes a scalar kernel: one thread per column, the rows walked in
// the same order, the weights staged the same way.
//
// A second entry, repro_weighted_commit_loads, computes the same function
// with plain loads instead of the ring: 256 threads a block, 16 bytes of
// columns each, every row of a 30-row pass loaded into registers at once,
// then added in order. It is a measured alternative (chip_smoke.py times it
// beside the ring at each commit shape); the wrappers' main path takes the
// ring.
//
// Rounding: the results must equal the plain PyTorch versions
// (repro_torch/kernels/plane_ops.py) bitwise, so every add, subtract,
// multiply and divide is an explicit round-to-nearest intrinsic (never an
// FMA, never an approximate division; the build passes -fmad=false), and
// floor is exact. float and double compute in their own type; bfloat16 and
// half compute in float and round once at the store (the select passes x
// through untouched). The commit sums in the plane's compute type (float64
// for float64 planes, as repro/kernels/ref.py does; the Pallas kernel sums
// in float32 for every dtype). NaN follows IEEE: |NaN| >= t is false, so
// the select writes 0.
//
// Plain C interface (loaded with ctypes): no PyTorch headers. Each launch
// goes on the caller's stream, allocates nothing, and the entry returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

// -- the weighted commit ------------------------------------------------------

constexpr int kCommitThreads = 128;            // consumers, 8 bytes of columns each
constexpr int kSegBytes = kCommitThreads * 8;  // a block's column segment of one row
constexpr int kRows = 15;                      // rows per ring slot
constexpr int kSlots = 2;                      // 30 rows in flight: the paper's clients
constexpr int kWeights = 8 * kRows;            // weights staged at a time
constexpr int kBarBytes = 16;                  // the slots' mbarriers
// 31,696 bytes: with the 1 KB each block reserves, seven blocks fit an SM's
// 228 KB, 924 on the card, so the wide plane's 879 blocks are one wave
constexpr int kSmem = kBarBytes + kSlots * kRows * kSegBytes + kWeights * 8;
constexpr int kScalarThreads = 256;
constexpr int kLoadThreads = 256;              // 16 bytes of columns each
constexpr int kLoadRows = kSlots * kRows;      // rows loaded at once

static_assert(kBarBytes >= kSlots * 8, "one mbarrier a slot");
static_assert(kSmem <= 48 * 1024, "no opt-in to more shared memory needed");
static_assert(kWeights % kLoadRows == 0, "a pass of rows never straddles a staging");

// A weight in the caller's dtype -> the compute type, as Tensor.to rounds it.
template <typename W> __device__ __forceinline__ W weight(float w);
template <typename W> __device__ __forceinline__ W weight(double w);
template <> __device__ __forceinline__ float weight<float>(float w) { return w; }
template <> __device__ __forceinline__ float weight<float>(double w) { return __double2float_rn(w); }
template <> __device__ __forceinline__ double weight<double>(float w) { return static_cast<double>(w); }
template <> __device__ __forceinline__ double weight<double>(double w) { return w; }

// The 8 bytes of columns one consumer owns.
template <typename T>
struct alignas(8) Pack {
  static constexpr int N = 8 / sizeof(T);
  T v[N];
};

// weights [r0, r0 + kWeights) of the caller's w into ws, by every thread
template <typename W, typename TW>
__device__ __forceinline__ void stage_weights(W* ws, const TW* __restrict__ w, int64_t r0,
                                              int64_t n_rows) {
  for (int64_t i = threadIdx.x; i < kWeights && r0 + i < n_rows; i += blockDim.x)
    ws[i] = weight<W>(w[r0 + i]);
}

// warp 0: rows [k * kRows, ...) of the block's column segment into slot k % kSlots
__device__ __forceinline__ void issue_chunk(unsigned char* ring, uint64_t* bars, const char* src,
                                            int64_t ld_bytes, uint32_t seg, int64_t k,
                                            int64_t n_rows) {
  const int lane = threadIdx.x;
  const int s = static_cast<int>(k % kSlots);
  const int64_t r0 = k * kRows;
  const int rows = static_cast<int>(n_rows - r0 < kRows ? n_rows - r0 : kRows);
  const uint32_t bar = smem_u32(&bars[s]);
  if (lane == 0) mbar_expect_tx(bar, static_cast<uint32_t>(rows) * seg);
  __syncwarp();
  if (lane < rows)
    bulk_load(smem_u32(ring + (s * kRows + lane) * kSegBytes), src + (r0 + lane) * ld_bytes, seg,
              bar);
}

// x: rows 16-byte aligned (x, ld * itemsize and n_cols * itemsize multiples
// of 16); out: (n_cols,), 8-byte aligned.
template <typename T, typename W, typename TW>
__global__ void __launch_bounds__(kCommitThreads)
    commit_bulk_kernel(const T* __restrict__ x, const TW* __restrict__ w, T* __restrict__ out,
                       int64_t n_rows, int64_t n_cols, int64_t ld) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + kBarBytes;
  W* ws = reinterpret_cast<W*>(ring + kSlots * kRows * kSegBytes);
  constexpr int N = Pack<T>::N;

  const int64_t seg0 = static_cast<int64_t>(blockIdx.x) * kSegBytes;  // bytes into a row
  const int64_t row_bytes = n_cols * static_cast<int64_t>(sizeof(T));
  const uint32_t seg =
      static_cast<uint32_t>(row_bytes - seg0 < kSegBytes ? row_bytes - seg0 : kSegBytes);
  const int64_t ld_bytes = ld * static_cast<int64_t>(sizeof(T));
  const char* src = reinterpret_cast<const char*>(x) + seg0;
  const int64_t n_chunks = (n_rows + kRows - 1) / kRows;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) mbar_init(smem_u32(&bars[s]), 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    for (int64_t k = 0; k < kSlots && k < n_chunks; ++k)
      issue_chunk(ring, bars, src, ld_bytes, seg, k, n_rows);
  }

  const bool owner = threadIdx.x * 8u < seg;  // this thread's 8 bytes lie in the plane
  W acc[N];
#pragma unroll
  for (int q = 0; q < N; ++q) acc[q] = W(0);
  for (int64_t k = 0; k < n_chunks; ++k) {
    const int64_t r0 = k * kRows;
    if (r0 % kWeights == 0) {  // under the first copies' flight time
      stage_weights<W, TW>(ws, w, r0, n_rows);
      __syncthreads();
    }
    const int s = static_cast<int>(k % kSlots);
    mbar_wait(smem_u32(&bars[s]), static_cast<uint32_t>((k / kSlots) & 1));
    const int rows = static_cast<int>(n_rows - r0 < kRows ? n_rows - r0 : kRows);
    if (owner) {
      // every row of the slot read at once (a short last slot reads stale
      // rows it then skips), then added in order
      const unsigned char* col = ring + s * kRows * kSegBytes + threadIdx.x * 8;
      const W* wk = ws + r0 % kWeights;
      Pack<T> p[kRows];
      W wr[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        p[r] = *reinterpret_cast<const Pack<T>*>(col + r * kSegBytes);
        wr[r] = wk[r];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
#pragma unroll
          for (int q = 0; q < N; ++q) acc[q] = add_rn(acc[q], mul_rn(wr[r], load_w(p[r].v[q])));
        }
      }
    }
    // slot s is refilled, or the weights restaged, once every consumer is
    // done with them (the paper's 30 rows need neither)
    const bool refill = k + kSlots < n_chunks;
    if (refill || (k + 1 < n_chunks && (r0 + kRows) % kWeights == 0)) {
      __syncthreads();
      if (threadIdx.x < 32 && refill)
        issue_chunk(ring, bars, src, ld_bytes, seg, k + kSlots, n_rows);
    }
  }
  if (owner) {
    Pack<T> o;
#pragma unroll
    for (int q = 0; q < N; ++q) o.v[q] = store_t<T>(acc[q]);
    *reinterpret_cast<Pack<T>*>(reinterpret_cast<char*>(out) + seg0 + threadIdx.x * 8) = o;
  }
}

// Any plane with unit column stride: one thread per column.
template <typename T, typename W, typename TW>
__global__ void __launch_bounds__(kScalarThreads)
    commit_scalar_kernel(const T* __restrict__ x, const TW* __restrict__ w, T* __restrict__ out,
                         int64_t n_rows, int64_t n_cols, int64_t ld) {
  __shared__ W ws[kWeights];
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kScalarThreads + threadIdx.x;
  W acc = W(0);
  for (int64_t r0 = 0; r0 < n_rows; r0 += kWeights) {
    __syncthreads();
    stage_weights<W, TW>(ws, w, r0, n_rows);
    __syncthreads();
    if (j < n_cols) {
      const int rows = static_cast<int>(n_rows - r0 < kWeights ? n_rows - r0 : kWeights);
      for (int r = 0; r < rows; ++r)
        acc = add_rn(acc, mul_rn(ws[r], load_w(x[(r0 + r) * ld + j])));
    }
  }
  if (j < n_cols) out[j] = store_t<T>(acc);
}

// The plain-load alternative: x as the bulk kernel takes it, out 16-byte
// aligned; one thread a 16-byte vector of columns.
template <typename T, typename W, typename TW>
__global__ void __launch_bounds__(kLoadThreads)
    commit_loads_kernel(const T* __restrict__ x, const TW* __restrict__ w, T* __restrict__ out,
                        int64_t n_rows, int64_t n_cols, int64_t ld) {
  __shared__ W ws[kWeights];
  constexpr int N = Vec<T>::N;
  const int64_t v = static_cast<int64_t>(blockIdx.x) * kLoadThreads + threadIdx.x;
  const bool owner = v * N < n_cols;
  const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x) + v;
  const int64_t ldv = ld / N;
  W acc[N];
#pragma unroll
  for (int q = 0; q < N; ++q) acc[q] = W(0);
  for (int64_t r0 = 0; r0 < n_rows; r0 += kLoadRows) {
    const int rows = static_cast<int>(n_rows - r0 < kLoadRows ? n_rows - r0 : kLoadRows);
    Vec<T> p[kLoadRows];
    if (owner) {  // the pass's rows in flight while the weights are staged
#pragma unroll
      for (int r = 0; r < kLoadRows; ++r)
        if (r < rows) p[r] = xv[(r0 + r) * ldv];
    }
    if (r0 % kWeights == 0) {
      __syncthreads();
      stage_weights<W, TW>(ws, w, r0, n_rows);
      __syncthreads();
    }
    if (owner) {
      const W* wk = ws + r0 % kWeights;
#pragma unroll
      for (int r = 0; r < kLoadRows; ++r) {
        if (r < rows) {
#pragma unroll
          for (int q = 0; q < N; ++q) acc[q] = add_rn(acc[q], mul_rn(wk[r], load_w(p[r].v[q])));
        }
      }
    }
  }
  if (owner) {
    Vec<T> o;
#pragma unroll
    for (int q = 0; q < N; ++q) o.v[q] = store_t<T>(acc[q]);
    reinterpret_cast<Vec<T>*>(out)[v] = o;
  }
}

template <typename T, typename W, typename TW>
int launch_commit(const void* x, const void* w, void* out, int64_t n_rows, int64_t n_cols,
                  int64_t ld, bool loads, cudaStream_t stream) {
  const int64_t item = sizeof(T);
  const bool bulk = aligned16(x) && (reinterpret_cast<uintptr_t>(out) & 7u) == 0 &&
                    (ld * item) % 16 == 0 && (n_cols * item) % 16 == 0;
  const T* xs = static_cast<const T*>(x);
  const TW* ws = static_cast<const TW*>(w);
  T* os = static_cast<T*>(out);
  if (bulk && loads && aligned16(out)) {
    const int64_t blocks = (n_cols * item / 16 + kLoadThreads - 1) / kLoadThreads;
    commit_loads_kernel<T, W, TW><<<static_cast<unsigned>(blocks), kLoadThreads, 0, stream>>>(
        xs, ws, os, n_rows, n_cols, ld);
  } else if (bulk) {
    const int64_t blocks = (n_cols * item + kSegBytes - 1) / kSegBytes;
    commit_bulk_kernel<T, W, TW><<<static_cast<unsigned>(blocks), kCommitThreads, kSmem, stream>>>(
        xs, ws, os, n_rows, n_cols, ld);
  } else {
    const int64_t blocks = (n_cols + kScalarThreads - 1) / kScalarThreads;
    commit_scalar_kernel<T, W, TW><<<static_cast<unsigned>(blocks), kScalarThreads, 0, stream>>>(
        xs, ws, os, n_rows, n_cols, ld);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TW>
int launch_commit_plane(int dtype, const void* x, const void* w, void* out, int64_t n_rows,
                        int64_t n_cols, int64_t ld, bool loads, cudaStream_t s) {
  switch (dtype) {
    case 0: return launch_commit<float, float, TW>(x, w, out, n_rows, n_cols, ld, loads, s);
    case 1: return launch_commit<double, double, TW>(x, w, out, n_rows, n_cols, ld, loads, s);
    case 2:
      return launch_commit<__nv_bfloat16, float, TW>(x, w, out, n_rows, n_cols, ld, loads, s);
    case 3: return launch_commit<__half, float, TW>(x, w, out, n_rows, n_cols, ld, loads, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int commit_entry(int dtype, int w_dtype, const void* x, const void* w, void* out,
                 int64_t n_rows, int64_t n_cols, int64_t ld, bool loads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0 || n_cols <= 0) return 0;
  switch (w_dtype) {
    case 0: return launch_commit_plane<float>(dtype, x, w, out, n_rows, n_cols, ld, loads, s);
    case 1: return launch_commit_plane<double>(dtype, x, w, out, n_rows, n_cols, ld, loads, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

// dtype codes: 0 float32, 1 float64, 2 bfloat16, 3 float16. x: (n_rows,
// n_cols) with row stride ld elements and unit column stride; w: (n_rows,)
// contiguous, float32 (w_dtype 0) or float64 (1); out: (n_cols,) in x's
// dtype.
extern "C" int repro_weighted_commit(int dtype, int w_dtype, const void* x, const void* w,
                                     void* out, int64_t n_rows, int64_t n_cols, int64_t ld,
                                     void* stream) {
  return commit_entry(dtype, w_dtype, x, w, out, n_rows, n_cols, ld, false, stream);
}

// The same, with the plain-load kernel where the bulk kernel would run.
extern "C" int repro_weighted_commit_loads(int dtype, int w_dtype, const void* x, const void* w,
                                           void* out, int64_t n_rows, int64_t n_cols, int64_t ld,
                                           void* stream) {
  return commit_entry(dtype, w_dtype, x, w, out, n_rows, n_cols, ld, true, stream);
}
