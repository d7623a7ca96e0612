// Causal GQA flash attention with a sliding window and a tanh logit
// softcap, for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py:_kernel
// (flash_attention, wrapped by repro/kernels/ops.py:gqa_flash_attention).
// For q (B, S, H, D) and k, v (B, S, KH, D) with H = KH * group, query head
// h reading kv head h / group (the repeated kv heads are never built):
//
//     x[i, j] = (q[i] . k[j]) * scale,  x = cap * tanh(x / cap) with a cap,
//     admitted iff j < S and, when causal, j <= i and (window > 0 ->
//     j > i - window),
//     out[i]  = sum_j softmax_j(x[i, :])[j] * v[j]
//
// as an online softmax over kv tiles, accumulated in float32, the output in
// the input's dtype. The window applies only under causal, as in
// repro/kernels/ref.py:flash_attention and the model's attention (the Pallas
// kernel applies it without causal too). Every stride but the head dim's is
// an argument, so the model's (B, S, H, D) activations are read in place; a
// ragged S is masked, no S % tile requirement.
//
// Bound: at the model's shapes the work is the two products, 4 * D * (the
// admitted (i, j) pairs) operations per head, against 989 TFLOP/s of dense
// bf16 tensor-core work; the bytes (q, k, v read once, out written once) are
// some 5x below that at S = 4,608, D = 256. So bfloat16 and float16 go
// through the tensor cores: mma.sync m16n8k16 with float32 accumulators.
// A block of 4 warps owns 64 query rows of one (b, h) and walks the kv tiles
// its mask admits (first and last tile by the window and the diagonal, the
// heavy diagonal blocks launched first); each warp owns 16 rows, keeps its
// score tile, the running max and sum and its (16, D) accumulator in
// registers, and turns the probabilities into the A operand of the PV
// product without a trip through shared memory. Q, K and V^T tiles sit in
// padded shared memory, so every fragment is one conflict-free 32-bit load.
// D = 256 takes 32-key tiles to keep the accumulator (128 floats a thread)
// in registers. Probabilities enter the PV product rounded to the input
// dtype, as the reference's probs are cast to v's dtype. Loads are plain
// 16-byte loads with a barrier around each tile (no cp.async or TMA
// pipelining, no wgmma: later work).
//
// float32 inputs cannot take the tensor cores at float32 accuracy, so they
// take a SIMT kernel: 4 warps of 4 query rows, 32-key tiles; each lane
// scores one key against the warp's rows, then owns D / 32 columns of the
// output rows for the PV sum.
//
// Plain C interface (loaded with ctypes): no PyTorch headers. Each launch
// goes on the caller's stream, allocates nothing, and the entry returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
  int S, group, causal, window;
  float scale, cap;  // cap <= 0: no softcap
};

__device__ __forceinline__ bool admitted(const Args& a, int qpos, int kpos) {
  if (kpos >= a.S) return false;
  if (a.causal) {
    if (kpos > qpos) return false;
    if (a.window > 0 && kpos <= qpos - a.window) return false;
  }
  return true;
}

__device__ __forceinline__ float to_logit(const Args& a, float s) {
  float x = s * a.scale;
  if (a.cap > 0.f) x = a.cap * tanhf(x / a.cap);
  return x;
}

// kv tiles [*t0, *t1) that hold a key admitted for some query row in
// [q0, q0 + bq).
__device__ __forceinline__ void kv_tiles(const Args& a, int q0, int bq, int bk, int* t0,
                                         int* t1) {
  int lo = 0, hi = a.S;
  if (a.causal) {
    hi = min(a.S, q0 + bq);
    if (a.window > 0) lo = max(0, q0 - a.window + 1);
  }
  *t0 = lo / bk;
  *t1 = (hi + bk - 1) / bk;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename T>
struct Tc;

template <>
struct Tc<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <>
struct Tc<__half> {
  static __device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

constexpr int kThreads = 128;  // 4 warps
constexpr int kTcRows = 64;    // query rows of a tensor-core block

template <int D>
struct TcTile {
  static constexpr int BK = D >= 256 ? 32 : 64;  // keys per kv tile
  static constexpr int LDQ = D + 8;              // padded row of Q and K
  static constexpr int LDV = BK + 8;             // padded row of V^T
  static constexpr int kSmem = (kTcRows * LDQ + BK * LDQ + D * LDV) * 2;
};

// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4): A regs
// {row g, k 2t..2t+1}, {row g+8, k 2t..}, {row g, k 2t+8..}, {row g+8,
// k 2t+8..}; B regs {k 2t..2t+1, n g}, {k 2t+8.., n g}; C {row g, n 2t,
// 2t+1}, {row g+8, n 2t, 2t+1}.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_tc_kernel(Args a) {
  using Tile = TcTile<D>;
  constexpr int BK = Tile::BK, LDQ = Tile::LDQ, LDV = Tile::LDV;
  constexpr int CH = D / 8;  // 16-byte chunks in a row
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kTcRows * LDQ;
  T* Vt = Ks + BK * LDQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;  // diagonal-heavy first
  const int h = blockIdx.y, b = blockIdx.z, kh = h / a.group;
  const T* qg = static_cast<const T*>(a.q) + b * a.q_b + h * a.q_h;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_b + kh * a.k_h;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_b + kh * a.v_h;
  T* og = static_cast<T*>(a.o) + b * a.o_b + h * a.o_h;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int c = tid; c < kTcRows * CH; c += kThreads) {
    const int r = c / CH, d0 = (c % CH) * 8;
    uint4 val = zero;
    if (q0 + r < a.S) val = *reinterpret_cast<const uint4*>(qg + (q0 + r) * a.q_s + d0);
    *reinterpret_cast<uint4*>(Qs + r * LDQ + d0) = val;
  }

  const int row = warp * 16 + g;  // this thread's rows: row, row + 8
  const int qpos0 = q0 + row, qpos1 = qpos0 + 8;
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  int t0, t1;
  kv_tiles(a, q0, kTcRows, BK, &t0, &t1);
  for (int kt = t0; kt < t1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's reads are done
    for (int c = tid; c < BK * CH; c += kThreads) {
      const int r = c / CH, d0 = (c % CH) * 8;
      uint4 val = zero;
      if (k0 + r < a.S) val = *reinterpret_cast<const uint4*>(kg + (k0 + r) * a.k_s + d0);
      *reinterpret_cast<uint4*>(Ks + r * LDQ + d0) = val;
    }
    for (int c = tid; c < BK * CH; c += kThreads) {
      const int r = c % BK, d0 = (c / BK) * 8;  // a warp takes 32 keys of one chunk
      uint4 val = zero;
      if (k0 + r < a.S) val = *reinterpret_cast<const uint4*>(vg + (k0 + r) * a.v_s + d0);
      const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(d0 + i) * LDV + r] = e[i];
    }
    __syncthreads();
    // a warp whose 16 rows all precede this tile has nothing admitted in it
    if (a.causal && k0 > q0 + warp * 16 + 15) continue;

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const T* qa = Qs + row * LDQ + ks * 16 + 2 * t;
      const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * LDQ);
      const uint32_t a2 = ld32(qa + 8), a3 = ld32(qa + 8 * LDQ + 8);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const T* kb = Ks + (n * 8 + g) * LDQ + ks * 16 + 2 * t;
        Tc<T>::mma(s[n], a0, a1, a2, a3, ld32(kb), ld32(kb + 8));
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + n * 8 + 2 * t + (e & 1);
        const int qpos = e < 2 ? qpos0 : qpos1;
        const float x = admitted(a, qpos, kpos) ? to_logit(a, s[n][e]) : -INFINITY;
        s[n][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    // a row with nothing admitted yet keeps max -inf: shift by 0 instead
    const float mu0 = mn0 == -INFINITY ? 0.f : mn0, mu1 = mn1 == -INFINITY ? 0.f : mn1;
    const float al0 = __expf(m0 - mu0), al1 = __expf(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= al0;
      acc[i][1] *= al0;
      acc[i][2] *= al1;
      acc[i][3] *= al1;
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[n][0] = __expf(s[n][0] - mu0);
      s[n][1] = __expf(s[n][1] - mu0);
      s[n][2] = __expf(s[n][2] - mu1);
      s[n][3] = __expf(s[n][3] - mu1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t p0 = Tc<T>::pack(s[2 * j][0], s[2 * j][1]);
      const uint32_t p1 = Tc<T>::pack(s[2 * j][2], s[2 * j][3]);
      const uint32_t p2 = Tc<T>::pack(s[2 * j + 1][0], s[2 * j + 1][1]);
      const uint32_t p3 = Tc<T>::pack(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const T* vb = Vt + (i * 8 + g) * LDV + j * 16 + 2 * t;
        Tc<T>::mma(acc[i], p0, p1, p2, p3, ld32(vb), ld32(vb + 8));
      }
    }
  }

  const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int d = i * 8 + 2 * t;
    if (qpos0 < a.S)
      *reinterpret_cast<uint32_t*>(og + qpos0 * a.o_s + d) =
          Tc<T>::pack(acc[i][0] * inv0, acc[i][1] * inv0);
    if (qpos1 < a.S)
      *reinterpret_cast<uint32_t*>(og + qpos1 * a.o_s + d) =
          Tc<T>::pack(acc[i][2] * inv1, acc[i][3] * inv1);
  }
}

constexpr int kSimtRows = 4;                          // query rows of a warp
constexpr int kSimtBq = kSimtRows * (kThreads / 32);  // 16 rows a block
constexpr int kSimtBk = 32;                           // one key per lane

template <int D>
constexpr int simt_smem() {
  return (kSimtBq * D + kSimtBk * (D + 1) + kSimtBk * D + kSimtBq * kSimtBk) * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_simt_kernel(Args a) {
  constexpr int R = kSimtRows, BQ = kSimtBq, BK = kSimtBk, E = D / 32, LDK = D + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // (BQ, D)
  float* Ks = Qs + BQ * D;                      // (BK, D + 1): lane j reads row j
  float* Vs = Ks + BK * LDK;                    // (BK, D)
  float* Ps = Vs + BK * D;                      // (BQ, BK) probabilities

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, kh = h / a.group;
  const float* qg = static_cast<const float*>(a.q) + b * a.q_b + h * a.q_h;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_b + kh * a.k_h;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_b + kh * a.v_h;
  float* og = static_cast<float*>(a.o) + b * a.o_b + h * a.o_h;

  for (int c = tid; c < BQ * D; c += kThreads) {
    const int r = c / D, d = c % D;
    Qs[c] = q0 + r < a.S ? qg[(q0 + r) * a.q_s + d] : 0.f;
  }
  float acc[R][E], m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;  // this lane's share of the row sum
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }
  const float* qw = Qs + warp * R * D;
  float* pw = Ps + warp * R * BK;

  int t0, t1;
  kv_tiles(a, q0, BQ, BK, &t0, &t1);
  for (int kt = t0; kt < t1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    for (int c = tid; c < BK * D; c += kThreads) {
      const int r = c / D, d = c % D;
      const bool in = k0 + r < a.S;
      Ks[r * LDK + d] = in ? kg[(k0 + r) * a.k_s + d] : 0.f;
      Vs[c] = in ? vg[(k0 + r) * a.v_s + d] : 0.f;
    }
    __syncthreads();

    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    const float* kr = Ks + lane * LDK;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = fmaf(qw[r * D + d], kd, s[r]);
    }
    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qpos = q0 + warp * R + r;
      const float x = admitted(a, qpos, kpos) ? to_logit(a, s[r]) : -INFINITY;
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[r], mx);
      const float mu = mn == -INFINITY ? 0.f : mn;
      const float al = __expf(m[r] - mu);
      const float p = __expf(x - mu);
      m[r] = mn;
      l[r] = l[r] * al + p;
      pw[r * BK + lane] = p;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= al;
    }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vj[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vj[e] = Vs[j * D + lane + 32 * e];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = pw[r * BK + j];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] = fmaf(p, vj[e], acc[r][e]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    float lt = l[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    const int qpos = q0 + warp * R + r;
    if (qpos < a.S) {
#pragma unroll
      for (int e = 0; e < E; ++e) og[qpos * a.o_s + lane + 32 * e] = acc[r][e] * inv;
    }
  }
}

template <typename T, int D>
int launch_tc(const Args& a, int B, int H, cudaStream_t stream) {
  constexpr int smem = TcTile<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_tc_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + kTcRows - 1) / kTcRows, H, B);
  flash_tc_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_simt(const Args& a, int B, int H, cudaStream_t stream) {
  constexpr int smem = simt_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_simt_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + kSimtBq - 1) / kSimtBq, H, B);
  flash_simt_kernel<D><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dtype(int dtype, const Args& a, int B, int H, cudaStream_t s) {
  switch (dtype) {
    case 0: return launch_simt<D>(a, B, H, s);
    case 2: return launch_tc<__nv_bfloat16, D>(a, B, H, s);
    case 3: return launch_tc<__half, D>(a, B, H, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype codes: 0 float32, 2 bfloat16, 3 float16 (float64 is not taken).
// Strides in elements; the head dim is contiguous. window <= 0: none;
// softcap <= 0: none.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                     void* o, int64_t q_b, int64_t q_s, int64_t q_h,
                                     int64_t k_b, int64_t k_s, int64_t k_h, int64_t v_b,
                                     int64_t v_s, int64_t v_h, int64_t o_b, int64_t o_s,
                                     int64_t o_h, int B, int S, int H, int KH, int D,
                                     int causal, int window, double scale, double softcap,
                                     void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (KH <= 0 || H % KH != 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.q_b = q_b; a.q_s = q_s; a.q_h = q_h;
  a.k_b = k_b; a.k_s = k_s; a.k_h = k_h;
  a.v_b = v_b; a.v_s = v_s; a.v_h = v_h;
  a.o_b = o_b; a.o_s = o_s; a.o_h = o_h;
  a.S = S;
  a.group = H / KH;
  a.causal = causal;
  a.window = window;
  a.scale = static_cast<float>(scale);
  a.cap = static_cast<float>(softcap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_dtype<64>(dtype, a, B, H, s);
    case 128: return launch_dtype<128>(dtype, a, B, H, s);
    case 256: return launch_dtype<256>(dtype, a, B, H, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
