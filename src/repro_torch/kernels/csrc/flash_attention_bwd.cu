// The gradient of causal GQA flash attention with a sliding window and a
// tanh logit softcap, float32, for Hopper.
//
// The Pallas TPU kernel repro/kernels/flash_attention.py:_kernel has no
// backward: the reference differentiates its jnp attention
// (repro/models/layers.py:_sdpa, _blocked_sdpa) with jax.value_and_grad.
// This is the backward of the port's forward kernel (flash_attention.cu),
// whose float32 path hands it each row's log-sum-exp. For q (B, S, H, D),
// k, v (B, S, KH, D), query head h reading kv head h / group, the output o
// and its gradient do:
//
//     r = scale * q k^T,  x = cap * tanh(r / cap) with a cap (else x = r),
//     p = exp(x - lse) where admitted, else 0      (the forward's softmax)
//     dv = p^T do,  dp = do v^T,  ds = p * (dp - delta),
//     delta = rowsum(do * o),  dr = ds * (1 - (x / cap)^2) with a cap,
//     dq = scale * dr k,  dk = scale * dr^T q,
//
// dk and dv summed over the group's query heads. Admitted as in the
// forward: j < S and, when causal, j <= i and (window > 0 -> j > i - window).
//
// Bound: the work is five products of the admitted (i, j) pairs by D (the
// scores, dp, dv, dk, dq: 10 * D operations a pair, 2.5x the forward's
// 4 * D), against 67 TFLOP/s of float32 on the CUDA cores; the bytes (q,
// k, v, o, do, lse read once, dq, dk, dv written once) are far below that
// at the model's shapes. This first version is plain SIMT float32 code,
// deterministic (no atomics), in three kernels on the caller's stream:
//
//   * flash_bwd_delta_kernel: one warp per (b, i, h) row,
//     delta = rowsum(do * o);
//   * flash_bwd_dkv_kernel: one block per (b, kv head, 32-key tile) keeps
//     the tile's k, v in shared memory and its dk, dv in registers, and
//     walks the group's query heads and, for each, the 32-row query tiles
//     the mask admits for the tile's keys (flash_attention.py:q_tile_range);
//   * flash_bwd_dq_kernel: one block per (b, head, 32-row query tile) keeps
//     q, do, lse, delta in shared memory and dq in registers, and walks the
//     kv tiles the mask admits (the forward's kv_tiles).
//
// In both, a tile pair's scores and dp are computed with each lane owning
// one key (its k and v rows padded to D + 1 floats: no bank conflicts) and
// each warp 8 query rows; p and dr go through shared memory, and the
// products into the accumulators have each warp own 8 rows of the output
// tile and each lane D / 32 of its columns. wgmma (tf32 cannot keep
// float32's accuracy), TMA and a bf16 path are later work.
//
// Plain C interface (loaded with ctypes): no PyTorch headers. The launches
// go on the caller's stream, allocate nothing (delta is the caller's
// scratch), and the entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kTile = 32;      // query rows and keys of a tile
constexpr int kRows = kTile / (kThreads / 32);  // rows of a warp: 8

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse;    // (B, H, S)
  float* delta;        // (B, H, S)
  float* dq;
  float* dk;
  float* dv;
  int S, H, KH, group, causal, window;
  float scale, cap;  // cap <= 0: no softcap
};

__device__ __forceinline__ bool admitted(const Args& a, int i, int j) {
  if (i >= a.S || j >= a.S) return false;
  if (a.causal) {
    if (j > i) return false;
    if (a.window > 0 && j <= i - a.window) return false;
  }
  return true;
}

// element offset of row (b, s, head) of a contiguous (B, S, heads, D) tensor
__device__ __forceinline__ long long row_at(int b, int s, int head, int S, int heads, int D) {
  return ((static_cast<long long>(b) * S + s) * heads + head) * D;
}

// kv tiles [*t0, *t1) holding a key admitted for some row in [q0, q0 + kTile):
// flash_attention.py:kv_tile_range
__device__ __forceinline__ void kv_tiles(const Args& a, int q0, int* t0, int* t1) {
  int lo = 0, hi = a.S;
  if (a.causal) {
    if (q0 + kTile < hi) hi = q0 + kTile;
    if (a.window > 0 && q0 - a.window + 1 > 0) lo = q0 - a.window + 1;
  }
  *t0 = lo / kTile;
  *t1 = (hi + kTile - 1) / kTile;
}

// query tiles [*t0, *t1) holding a row that admits some key in
// [k0, k0 + kTile): flash_attention.py:q_tile_range
__device__ __forceinline__ void q_tiles(const Args& a, int k0, int* t0, int* t1) {
  int lo = 0, hi = a.S;
  if (a.causal) {
    lo = k0;
    if (a.window > 0 && k0 + kTile - 1 + a.window < hi) hi = k0 + kTile - 1 + a.window;
  }
  *t0 = lo / kTile;
  *t1 = (hi + kTile - 1) / kTile;
}

// rows [r0, r0 + kTile) of a (B, S, heads, D) tensor into a (kTile, ld)
// shared tile, rows past S as zeros
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, int b, int r0,
                                          int head, int S, int heads) {
  for (int c = threadIdx.x; c < kTile * D; c += kThreads) {
    const int r = c / D, d = c % D;
    dst[r * ld + d] = r0 + r < S ? src[row_at(b, r0 + r, head, S, heads, D) + d] : 0.f;
  }
}

// For the warp's 8 query rows against the lane's key: p and dr * scale of
// each pair (0 where the mask refuses it), from the tiles in shared memory:
// q, do (kTile, D) and k, v (kTile, D + 1); lse, delta of the query rows.
template <int D>
__device__ __forceinline__ void pair_grads(const Args& a, const float* Qs, const float* dOs,
                                           const float* Ks, const float* Vs, const float* Ls,
                                           const float* Ds, int q0, int k0, float* p,
                                           float* dr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float s[kRows], dp[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.f;
  const float* kr = Ks + lane * (D + 1);
  const float* vr = Vs + lane * (D + 1);
  const float* qw = Qs + warp * kRows * D;
  const float* dw = dOs + warp * kRows * D;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float kd = kr[d], vd = vr[d];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      s[r] = fmaf(qw[r * D + d], kd, s[r]);
      dp[r] = fmaf(dw[r * D + d], vd, dp[r]);
    }
  }
  const int j = k0 + lane;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = warp * kRows + r, i = q0 + row;
    if (!admitted(a, i, j)) {
      p[r] = dr[r] = 0.f;
      continue;
    }
    float x = s[r] * a.scale, dx = 1.f;
    if (a.cap > 0.f) {
      const float t = tanhf(x / a.cap);
      x = a.cap * t;
      dx = 1.f - t * t;
    }
    p[r] = expf(x - Ls[row]);
    dr[r] = p[r] * (dp[r] - Ds[row]) * dx * a.scale;
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_delta_kernel(Args a, int D, long long rows) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  // row = (b * S + s) * H + h: the (B, S, H, D) layout's row order
  const float* o = a.o + row * D;
  const float* g = a.dout + row * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(o[d], g[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % a.H);
    const long long bs = row / a.H;
    const int s = static_cast<int>(bs % a.S), b = static_cast<int>(bs / a.S);
    a.delta[(static_cast<long long>(b) * a.H + h) * a.S + s] = acc;
  }
}

template <int D>
constexpr int dkv_smem() {
  return (2 * kTile * (D + 1) + 2 * kTile * D + 2 * kTile * (kTile + 1) + 2 * kTile) * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Args a) {
  constexpr int E = D / 32, LDK = D + 1, LDP = kTile + 1;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                  // (kTile, D + 1)
  float* Vs = Ks + kTile * LDK;      // (kTile, D + 1)
  float* Qs = Vs + kTile * LDK;      // (kTile, D)
  float* dOs = Qs + kTile * D;       // (kTile, D)
  float* Ps = dOs + kTile * D;       // (kTile, kTile + 1): p[i][j]
  float* Rs = Ps + kTile * LDP;      // (kTile, kTile + 1): dr[i][j] * scale
  float* Ls = Rs + kTile * LDP;      // (kTile): lse of the query rows
  float* Ds = Ls + kTile;            // (kTile): delta of the query rows

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * kTile, kh = blockIdx.y, b = blockIdx.z;
  load_tile<D>(Ks, LDK, a.k, b, k0, kh, a.S, a.KH);
  load_tile<D>(Vs, LDK, a.v, b, k0, kh, a.S, a.KH);
  // dk, dv of the warp's 8 keys, the lane's D / 32 columns
  float dk[kRows][E], dv[kRows][E];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e) dk[r][e] = dv[r][e] = 0.f;

  int t0, t1;
  q_tiles(a, k0, &t0, &t1);
  for (int g = 0; g < a.group; ++g) {
    const int h = kh * a.group + g;
    const float* lse = a.lse + (static_cast<long long>(b) * a.H + h) * a.S;
    const float* delta = a.delta + (static_cast<long long>(b) * a.H + h) * a.S;
    for (int t = t0; t < t1; ++t) {
      const int q0 = t * kTile;
      __syncthreads();  // the previous tile's Qs, dOs, Ps, Rs are consumed
      load_tile<D>(Qs, D, a.q, b, q0, h, a.S, a.H);
      load_tile<D>(dOs, D, a.dout, b, q0, h, a.S, a.H);
      if (threadIdx.x < kTile) {
        const int i = q0 + threadIdx.x;
        Ls[threadIdx.x] = i < a.S ? lse[i] : 0.f;
        Ds[threadIdx.x] = i < a.S ? delta[i] : 0.f;
      }
      __syncthreads();
      float p[kRows], dr[kRows];
      pair_grads<D>(a, Qs, dOs, Ks, Vs, Ls, Ds, q0, k0, p, dr);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        Ps[(warp * kRows + r) * LDP + lane] = p[r];
        Rs[(warp * kRows + r) * LDP + lane] = dr[r];
      }
      __syncthreads();
      // dv[j] += sum_i p[i][j] do[i],  dk[j] += sum_i dr[i][j] q[i]
#pragma unroll 2
      for (int i = 0; i < kTile; ++i) {
        float qi[E], gi[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          qi[e] = Qs[i * D + lane + 32 * e];
          gi[e] = dOs[i * D + lane + 32 * e];
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float pij = Ps[i * LDP + warp * kRows + r];
          const float rij = Rs[i * LDP + warp * kRows + r];
#pragma unroll
          for (int e = 0; e < E; ++e) {
            dv[r][e] = fmaf(pij, gi[e], dv[r][e]);
            dk[r][e] = fmaf(rij, qi[e], dk[r][e]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int j = k0 + warp * kRows + r;
    if (j >= a.S) continue;
    const long long at = row_at(b, j, kh, a.S, a.KH, D);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      a.dk[at + lane + 32 * e] = dk[r][e];
      a.dv[at + lane + 32 * e] = dv[r][e];
    }
  }
}

template <int D>
constexpr int dq_smem() {
  return (2 * kTile * (D + 1) + 2 * kTile * D + kTile * (kTile + 1) + 2 * kTile) * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  constexpr int E = D / 32, LDK = D + 1, LDP = kTile + 1;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                  // (kTile, D + 1)
  float* Vs = Ks + kTile * LDK;      // (kTile, D + 1)
  float* Qs = Vs + kTile * LDK;      // (kTile, D)
  float* dOs = Qs + kTile * D;       // (kTile, D)
  float* Rs = dOs + kTile * D;       // (kTile, kTile + 1): dr[i][j] * scale
  float* Ls = Rs + kTile * LDP;      // (kTile)
  float* Ds = Ls + kTile;            // (kTile)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = gridDim.x;
  const int q0 = (nq - 1 - blockIdx.x) * kTile;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z, kh = h / a.group;
  load_tile<D>(Qs, D, a.q, b, q0, h, a.S, a.H);
  load_tile<D>(dOs, D, a.dout, b, q0, h, a.S, a.H);
  if (threadIdx.x < kTile) {
    const int i = q0 + threadIdx.x;
    const long long at = (static_cast<long long>(b) * a.H + h) * a.S + i;
    Ls[threadIdx.x] = i < a.S ? a.lse[at] : 0.f;
    Ds[threadIdx.x] = i < a.S ? a.delta[at] : 0.f;
  }
  float dq[kRows][E];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e) dq[r][e] = 0.f;

  int t0, t1;
  kv_tiles(a, q0, &t0, &t1);
  for (int t = t0; t < t1; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's Ks, Rs are consumed
    load_tile<D>(Ks, LDK, a.k, b, k0, kh, a.S, a.KH);
    load_tile<D>(Vs, LDK, a.v, b, k0, kh, a.S, a.KH);
    __syncthreads();
    float p[kRows], dr[kRows];
    pair_grads<D>(a, Qs, dOs, Ks, Vs, Ls, Ds, q0, k0, p, dr);
#pragma unroll
    for (int r = 0; r < kRows; ++r) Rs[(warp * kRows + r) * LDP + lane] = dr[r];
    __syncthreads();
    // dq[i] += sum_j dr[i][j] k[j]
#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      float kj[E];
#pragma unroll
      for (int e = 0; e < E; ++e) kj[e] = Ks[j * LDK + lane + 32 * e];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float rij = Rs[(warp * kRows + r) * LDP + j];
#pragma unroll
        for (int e = 0; e < E; ++e) dq[r][e] = fmaf(rij, kj[e], dq[r][e]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = q0 + warp * kRows + r;
    if (i >= a.S) continue;
    const long long at = row_at(b, i, h, a.S, a.H, D);
#pragma unroll
    for (int e = 0; e < E; ++e) a.dq[at + lane + 32 * e] = dq[r][e];
  }
}

template <int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * a.S * a.H;
  const int per = kThreads / 32;
  const unsigned blocks = static_cast<unsigned>((rows + per - 1) / per);
  flash_bwd_delta_kernel<<<blocks, kThreads, 0, stream>>>(a, D, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int s_kv = dkv_smem<D>(), s_q = dq_smem<D>();
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, s_kv);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, s_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (a.S + kTile - 1) / kTile;
  flash_bwd_dkv_kernel<D><<<dim3(tiles, a.KH, B), kThreads, s_kv, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<D><<<dim3(tiles, a.H, B), kThreads, s_q, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// float32 only; every tensor contiguous: q, o, dout, dq (B, S, H, D); k, v,
// dk, dv (B, S, KH, D); lse, delta (B, H, S), delta the caller's scratch.
// window <= 0: none (the caller passes the window under causal only);
// softcap <= 0: none.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* delta, void* dq, void* dk, void* dv, int B, int S,
                                         int H, int KH, int D, int causal, int window,
                                         double scale, double softcap, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (KH <= 0 || H % KH != 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<const float*>(o);
  a.dout = static_cast<const float*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.S = S;
  a.H = H;
  a.KH = KH;
  a.group = H / KH;
  a.causal = causal;
  a.window = window;
  a.scale = static_cast<float>(scale);
  a.cap = static_cast<float>(softcap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(a, B, s);
    case 128: return launch<128>(a, B, s);
    case 256: return launch<256>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
