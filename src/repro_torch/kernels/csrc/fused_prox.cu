// Fused local update + L1 proximal step (Algorithm 1, lines 9-10), for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_prox.py:_kernel
// (fused_local_update_2d). For each element of every leaf of a pytree:
//
//     z_hat' = z_hat - eta * (g + c)
//     z'     = sign(z_hat') * max(|z_hat'| - thresh, 0)
//
// Bound: the kernel moves 5 tensors of n * itemsize bytes (reads z_hat, g, c
// once, writes z_hat', z' once) and does ~10 operations per element, so it
// is bound by device memory: 5 * n * itemsize / 3.35 TB/s on an H100 SXM.
// At the paper's tree, {w: (30, 20), b: (30,)} float64, that is 7.5 ns: the
// call is bound by its launch, so one launch per local step is the design's
// first aim.
//
// Design: one launch over all the leaves of the tree, reading z_hat, g and c
// in place, as a multi-tensor apply does. The launch's one parameter is a
// table passed by value (__grid_constant__: read from the parameter bank,
// never copied): a header (the two output planes, their row stride, the
// client rows, eta, thresh), one entry per leaf (its three input addresses,
// each input's row stride in elements -- the client axis of a stacked tree,
// 0 for a broadcast -- its width per client, its column offset in the output
// planes, and its chunking), then a block map: one 32-bit word per block,
// the block's leaf and chunk, built on the host. A chunk is a rectangle of
// one leaf: one row and chunk_cols columns of a wide leaf, or chunk_rows
// whole rows of a narrow one; the block's 256 threads lie over it as rows of
// 2^tpr_log2 threads, so no thread divides or searches. A leaf whose rows
// all start 16-byte aligned in all five tensors takes 16-byte vectors (and
// a scalar tail per row); any other leaf takes scalars. Nothing is staged
// through shared memory (each element is used once). The output planes are
// the caller's (n_rows, out_ld) buffers, each leaf's segment starting on a
// 16-byte boundary.
//
// The table holds up to 32,760 bytes where the toolkit allows kernel
// parameters of that size (CUDA 12.1), else 4,096; a tree whose table does
// not fit is split by the host into several launches.
//
// Rounding: the result must equal the plain PyTorch version
// (repro_torch/kernels/fused_prox.py:fused_local_update_plain) bitwise, so
// every add, multiply and subtract is an explicit round-to-nearest intrinsic
// (never contracted into an FMA), and the sign/max are written the way
// PyTorch's own kernels compute torch.sign and torch.clamp_min, which fixes
// the results for -0.0 and NaN too. float and double compute in their own
// type; bfloat16 and half compute in float and round once at each store.
//
// Plain C interface (loaded with ctypes): no PyTorch headers, so nvcc
// builds this file in seconds. The launch goes on the caller's stream, the
// kernel allocates nothing, and the entry returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmallTable = 4096;    // the kernel parameter limit before CUDA 12.1
constexpr int kLargeTable = 32760;   // 32,764 from CUDA 12.1, kept a multiple of 8
#if CUDART_VERSION >= 12010
constexpr int kMaxTable = kLargeTable;
#else
constexpr int kMaxTable = kSmallTable;
#endif

// The table's layout; repro_torch/kernels/fused_prox.py packs it
// (HEADER_FMT, LEAF_FMT, one uint32 per block: chunk << 16 | leaf).
struct Header {
  int64_t zh_out, z_out;  // the output planes' addresses
  int64_t out_ld;         // their row stride, elements
  int64_t n_rows;         // client rows (1 for an unbatched tree)
  double eta, thresh;     // rounded to the compute type in the kernel
  int32_t n_leaves, n_blocks;
  int64_t reserved;
};

struct Leaf {
  int64_t zh, g, c;           // addresses of row 0, column 0
  int64_t ld_zh, ld_g, ld_c;  // row strides, elements
  int64_t width;              // elements per row
  int64_t col;                // column offset in the output planes
  int32_t chunk_rows, chunk_cols, chunks_per_row;
  uint8_t tpr_log2;           // threads per row of a chunk: 2^tpr_log2
  uint8_t vec;                // 16-byte vectors (every row start aligned)
  uint8_t pad[2];
};

static_assert(sizeof(Header) == 64, "HEADER_FMT");
static_assert(sizeof(Leaf) == 80, "LEAF_FMT");

template <int CAP>
struct Table {
  Header h;
  unsigned char data[CAP - sizeof(Header)];  // leaves, then the block map
};

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

template <typename T, typename W, int CAP>
__global__ void __launch_bounds__(kThreads)
    fused_leaves_kernel(const __grid_constant__ Table<CAP> t) {
  const Header& h = t.h;
  const Leaf* leaves = reinterpret_cast<const Leaf*>(t.data);
  const uint32_t* bmap =
      reinterpret_cast<const uint32_t*>(t.data + sizeof(Leaf) * h.n_leaves);
  const uint32_t e = bmap[blockIdx.x];
  const Leaf& L = leaves[e & 0xffffu];
  const int64_t chunk = e >> 16;

  const int64_t rc = chunk / L.chunks_per_row;
  const int64_t c0 = (chunk - rc * L.chunks_per_row) * L.chunk_cols;
  const int64_t r0 = rc * L.chunk_rows;
  const int64_t r1 = r0 + L.chunk_rows < h.n_rows ? r0 + L.chunk_rows : h.n_rows;
  const int64_t nc = L.width - c0 < L.chunk_cols ? L.width - c0 : L.chunk_cols;
  const int tl = L.tpr_log2;
  const int tpr = 1 << tl;
  const int lane = threadIdx.x & (tpr - 1);
  const W eta = static_cast<W>(h.eta);
  const W thresh = static_cast<W>(h.thresh);
  const bool vec = L.vec != 0;

  for (int64_t r = r0 + (threadIdx.x >> tl); r < r1; r += kThreads >> tl) {
    const T* zh = reinterpret_cast<const T*>(L.zh) + r * L.ld_zh + c0;
    const T* g = reinterpret_cast<const T*>(L.g) + r * L.ld_g + c0;
    const T* c = reinterpret_cast<const T*>(L.c) + r * L.ld_c + c0;
    T* zh_out = reinterpret_cast<T*>(h.zh_out) + r * h.out_ld + L.col + c0;
    T* z_out = reinterpret_cast<T*>(h.z_out) + r * h.out_ld + L.col + c0;
    int64_t head = 0;
    if (vec) {
      constexpr int N = Vec<T>::N;
      const int64_t nvec = nc / N;
#pragma unroll 4
      for (int64_t i = lane; i < nvec; i += tpr) {
        const Vec<T> a = reinterpret_cast<const Vec<T>*>(zh)[i];
        const Vec<T> b = reinterpret_cast<const Vec<T>*>(g)[i];
        const Vec<T> d = reinterpret_cast<const Vec<T>*>(c)[i];
        Vec<T> o1, o2;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          W u, z;
          step<W>(load_w(a.v[k]), load_w(b.v[k]), load_w(d.v[k]), eta, thresh, &u, &z);
          o1.v[k] = store_t<T>(u);
          o2.v[k] = store_t<T>(z);
        }
        reinterpret_cast<Vec<T>*>(zh_out)[i] = o1;
        reinterpret_cast<Vec<T>*>(z_out)[i] = o2;
      }
      head = nvec * N;
    }
    for (int64_t i = head + lane; i < nc; i += tpr) {
      W u, z;
      step<W>(load_w(zh[i]), load_w(g[i]), load_w(c[i]), eta, thresh, &u, &z);
      zh_out[i] = store_t<T>(u);
      z_out[i] = store_t<T>(z);
    }
  }
}

template <int CAP>
int launch(int dtype, const void* table, int64_t nbytes, cudaStream_t stream) {
  Table<CAP> t;
  memcpy(&t, table, static_cast<size_t>(nbytes));
  const unsigned blocks = static_cast<unsigned>(t.h.n_blocks);
  switch (dtype) {
    case 0: fused_leaves_kernel<float, float, CAP><<<blocks, kThreads, 0, stream>>>(t); break;
    case 1: fused_leaves_kernel<double, double, CAP><<<blocks, kThreads, 0, stream>>>(t); break;
    case 2:
      fused_leaves_kernel<__nv_bfloat16, float, CAP><<<blocks, kThreads, 0, stream>>>(t);
      break;
    case 3: fused_leaves_kernel<__half, float, CAP><<<blocks, kThreads, 0, stream>>>(t); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The most bytes a table may hold with this toolkit: 32,760 from CUDA 12.1,
// else 4,096.
extern "C" int repro_fused_table_bytes() { return kMaxTable; }

// dtype codes: 0 float32, 1 float64, 2 bfloat16, 3 float16. table: nbytes
// bytes in the layout above; eta and thresh arrive as doubles in its header
// and are rounded to the compute type (float for codes 0, 2, 3), as PyTorch
// rounds a Python scalar.
extern "C" int repro_fused_local_update(int dtype, const void* table, int64_t nbytes,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nbytes < static_cast<int64_t>(sizeof(Header))) return static_cast<int>(cudaErrorInvalidValue);
  Header h;
  memcpy(&h, table, sizeof(Header));
  if (h.n_blocks <= 0) return 0;
  if (nbytes <= kSmallTable) return launch<kSmallTable>(dtype, table, nbytes, s);
#if CUDART_VERSION >= 12010
  if (nbytes <= kLargeTable) return launch<kLargeTable>(dtype, table, nbytes, s);
#endif
  return static_cast<int>(cudaErrorInvalidValue);
}
