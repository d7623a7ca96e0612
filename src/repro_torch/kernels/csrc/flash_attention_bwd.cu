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
// 4 * D), against 165 TFLOP/s of split TF32 on the tensor cores
// (split_tf32.cuh: three TF32 products per float32 one at 495 TFLOP/s; the
// same work in float32 FMAs on the CUDA cores, 67 TFLOP/s, takes 2.5x as
// long); the bytes (q, k, v, o, do, lse read once, dq, dk, dv written once)
// are far below that at the model's shapes. Deterministic (no atomics),
// in three kernels on the caller's stream:
//
//   * flash_bwd_delta_kernel: delta = rowsum(do * o) of each (b, i, h)
//     row (a row sum on the CUDA cores, 16-byte loads, half a warp a row at
//     D = 64);
//   * flash_bwd_dkv_kernel: one block per (b, kv head, BKV-key tile) keeps
//     the tile's k, v in shared memory and its dk, dv in registers, and
//     walks the group's query heads and, for each, the BQ-row query tiles
//     the mask admits for the tile's keys (flash_attention.py:q_tile_range),
//     their q, do, lse and delta through a two-slot cp.async ring (the next
//     step's tiles load while this one's products run). Warp w owns 16 keys
//     and 64 columns of dk and dv: with CS = D / 64 > 1 (D >= 128, where
//     both accumulators of all D columns would not fit in registers) CS
//     warps share each 16 keys and each computes their scores and dp;
//   * flash_bwd_dq_kernel: one block per (b, head, 16-rows-a-warp query
//     tile) keeps q, do in shared memory, lse, delta and dq in registers,
//     and walks the kv tiles the mask admits (the forward's kv_tiles), k
//     and v through the same ring (one slot at D = 256, where two do not
//     fit beside q and do; there two warps share each 16 rows, each with
//     half of dq's columns).
//
// Every product runs on the tensor cores in split TF32 with mma.sync
// (split_tf32.cuh, which says why not wgmma): s^T = k q^T and dp^T = v do^T
// (dK/dV kernel), s = q k^T and dp = do v^T (dQ kernel) from shared memory;
// dv += p^T do, dk += ds^T q and dq += ds k with p and ds the A operands
// straight from the accumulators. p, dr and the mask are float32 on the
// CUDA cores in between (__expf as the forward's softmax, tanhf). Query
// tiles of 32 rows (64 at D = 128) and kv tiles of 32 keys keep the
// registers low enough for three blocks an SM at D = 64. The scores and dp
// are recomputed in
// both kernels: 7 products a pair where 5 would do (14 * D operations, 1.4x
// the bound's 10 * D; the warps sharing rows recompute them too: 9 products
// at D = 128, 1.8x, and 15 at D = 256, 3x), the price of no atomics and no
// stored (S, S) probabilities. A warp skips a
// step holding no pair its keys (rows) admit and masks per element only
// where the step crosses the diagonal, the window's lower edge or S.
//
// Plain C interface (loaded with ctypes): no PyTorch headers. The launches
// go on the caller's stream, allocate nothing (delta is the caller's
// scratch), and the entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "split_tf32.cuh"

namespace {

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
  float scale, cap, inv_cap;  // cap <= 0: no softcap
};

template <int D>
struct BwdTile {
  // dK/dV kernel: BKV keys a block, 16 a warp, CS warps over each 16 keys
  // taking D / CS columns of dk and dv each; query tiles of BQ rows
  static constexpr int BKV = D == 256 ? 32 : 64;
  static constexpr int CS = D / 64;
  static constexpr int KV_WARPS = BKV / 16 * CS;
  static constexpr int BQ = D == 128 ? 64 : 32;
  // dQ kernel: DQ_BQ query rows a block, 16 a warp (DQ_RW warps along the
  // rows), DQ_CS warps over each 16 rows taking D / DQ_CS columns of dq;
  // kv tiles of DQ_BK keys through a ring of DQ_STAGES slots
  static constexpr int DQ_RW = D == 128 ? 8 : 4;
  static constexpr int DQ_CS = D == 256 ? 2 : 1;
  static constexpr int DQ_WARPS = DQ_RW * DQ_CS;
  static constexpr int DQ_BQ = 16 * DQ_RW;
  static constexpr int DQ_BK = 32;
  static constexpr int DQ_STAGES = D == 256 ? 1 : 2;
  static constexpr int LD = D + 4;  // row stride in shared memory
  static constexpr int KV_SMEM = ((2 * BKV + 4 * BQ) * LD + 4 * BQ) * 4;
  static constexpr int DQ_SMEM = (2 * DQ_BQ + 2 * DQ_STAGES * DQ_BK) * LD * 4;
};

__device__ __forceinline__ bool admitted(const Args& a, int i, int j) {
  if (i >= a.S || j >= a.S) return false;
  if (a.causal) {
    if (j > i) return false;
    if (a.window > 0 && j <= i - a.window) return false;
  }
  return true;
}

// whether some row i in [i0, i0 + ni) admits some key j in [j0, j0 + nj)
__device__ __forceinline__ bool any_admitted(const Args& a, int i0, int ni, int j0, int nj) {
  if (i0 >= a.S || j0 >= a.S) return false;
  if (!a.causal) return true;
  const int i1 = min(i0 + ni, a.S) - 1, j1 = min(j0 + nj, a.S) - 1;
  // j - i ranges over [j0 - i1, j1 - i0]: does it meet (-window, 0]?
  return j0 <= i1 && (a.window <= 0 || j1 > i0 - a.window);
}

// whether every row in [i0, i0 + ni) admits every key in [j0, j0 + nj)
__device__ __forceinline__ bool all_admitted(const Args& a, int i0, int ni, int j0, int nj) {
  if (i0 + ni > a.S || j0 + nj > a.S) return false;
  if (!a.causal) return true;
  return j0 + nj - 1 <= i0 && (a.window <= 0 || j0 > i0 + ni - 1 - a.window);
}

// kv tiles [*t0, *t1) of bk keys holding a key admitted for some row in
// [q0, q0 + bq): flash_attention.py:kv_tile_range
__device__ __forceinline__ void kv_tiles(const Args& a, int q0, int bq, int bk, int* t0,
                                         int* t1) {
  int lo = 0, hi = a.S;
  if (a.causal) {
    if (q0 + bq < hi) hi = q0 + bq;
    if (a.window > 0 && q0 - a.window + 1 > 0) lo = q0 - a.window + 1;
  }
  *t0 = lo / bk;
  *t1 = (hi + bk - 1) / bk;
}

// query tiles [*t0, *t1) of bq rows holding a row that admits some key in
// [k0, k0 + bk): flash_attention.py:q_tile_range
__device__ __forceinline__ void q_tiles(const Args& a, int k0, int bk, int bq, int* t0,
                                        int* t1) {
  int lo = 0, hi = a.S;
  if (a.causal) {
    lo = k0;
    if (a.window > 0 && k0 + bk - 1 + a.window < hi) hi = k0 + bk - 1 + a.window;
  }
  *t0 = lo / bq;
  *t1 = (hi + bq - 1) / bq;
}

// In place on one warp's scores s and dp (C fragments of NB 8-column
// blocks): s -> p = exp(x - lse) and dp -> dr = p (dp - delta) dx scale for
// the pairs the mask admits, 0 elsewhere. Element e of block j is the pair
// of row (e < 2 ? 0 : 8) and column 8 j + 2 t + (e & 1) of the slab; kKeyRows:
// the slab's rows are keys (dK/dV kernel, lse and delta per column, from
// shared memory), else query rows (dQ kernel, lse and delta per row, in
// registers).
template <bool kMask, bool kKeyRows, int NB>
__device__ __forceinline__ void pair_grads(const Args& a, float (&s)[NB][4], float (&dp)[NB][4],
                                           int row0, int col0, const float* Ls,
                                           const float* Ds, const float (&lr)[2],
                                           const float (&dr)[2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + (e & 2) * 4, col = 8 * j + 2 * t + (e & 1);
      const bool in = !kMask || (kKeyRows ? admitted(a, col0 + col, row)
                                          : admitted(a, row, col0 + col));
      float x = s[j][e] * a.scale, dx = 1.f;
      if (a.cap > 0.f) {
        const float th = tanhf(x * a.inv_cap);
        x = a.cap * th;
        dx = 1.f - th * th;
      }
      const float lse = kKeyRows ? Ls[col] : lr[e >> 1];
      const float delta = kKeyRows ? Ds[col] : dr[e >> 1];
      const float p = __expf(x - lse);
      s[j][e] = in ? p : 0.f;
      dp[j][e] = in ? p * (dp[j][e] - delta) * dx * a.scale : 0.f;
    }
}

template <int NB>
__device__ __forceinline__ void zero(float (&c)[NB][4]) {
#pragma unroll
  for (int j = 0; j < NB; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// rows r0 and r0 + 8 (those below S) of a warp's accumulator c (C fragments
// over 8 NB columns from col0) into row-major rows of ld floats at dst
template <int NB>
__device__ __forceinline__ void store_rows(float* dst, long long ld, int col0, int r0, int S,
                                           const float (&c)[NB][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < NB; ++j)
      *reinterpret_cast<float2*>(dst + row * ld + col0 + 8 * j + 2 * t) =
          make_float2(c[j][2 * r], c[j][2 * r + 1]);
  }
}

// delta = rowsum(do * o) of each (b, s, h) row, 16-byte loads: L lanes a
// row (D / 4 up to 32), 32 / L rows a warp, 8 warps a block
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(const Args a, long long rows) {
  constexpr int C = D / 4, L = C < 32 ? C : 32;
  const int lane = threadIdx.x & 31, l = lane % L;
  // row = (b * S + s) * H + h: the (B, S, H, D) layout's row order
  const long long row = (static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5)) * (32 / L) +
                        lane / L;
  float acc = 0.f;
  if (row < rows) {
    const float4* o = reinterpret_cast<const float4*>(a.o + row * D);
    const float4* g = reinterpret_cast<const float4*>(a.dout + row * D);
#pragma unroll
    for (int c = l; c < C; c += L) {
      const float4 x = o[c], y = g[c];
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
      acc = fmaf(x.z, y.z, acc);
      acc = fmaf(x.w, y.w, acc);
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && l == 0) {
    const int h = static_cast<int>(row % a.H);
    const long long bs = row / a.H;
    const int s = static_cast<int>(bs % a.S), b = static_cast<int>(bs / a.S);
    a.delta[(static_cast<long long>(b) * a.H + h) * a.S + s] = acc;
  }
}

template <int D>
__global__ void __launch_bounds__(BwdTile<D>::KV_WARPS * 32) flash_bwd_dkv_kernel(const Args a) {
  using C = BwdTile<D>;
  constexpr int BKV = C::BKV, BQ = C::BQ, LD = C::LD, KW = BKV / 16;
  constexpr int THREADS = C::KV_WARPS * 32, NQ = BQ / 8, NN = D / C::CS / 8;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;               // (BKV, LD)
  float* Vs = Ks + BKV * LD;      // (BKV, LD)
  float* Qs = Vs + BKV * LD;      // 2 x (BQ, LD)
  float* dOs = Qs + 2 * BQ * LD;  // 2 x (BQ, LD)
  float* Ls = dOs + 2 * BQ * LD;  // 2 x BQ: lse of the step's rows
  float* Ds = Ls + 2 * BQ;        // 2 x BQ: delta of the step's rows

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * BKV, kh = blockIdx.y, b = blockIdx.z;
  const int kw = k0 + 16 * (warp % KW);  // the warp's first key
  const int c0 = D / C::CS * (warp / KW);  // its first column of dk, dv
  const long long q_st = static_cast<long long>(a.H) * D, kv_st = static_cast<long long>(a.KH) * D;
  const long long kv_at = (static_cast<long long>(b) * a.S * a.KH + kh) * D;
  load_rows<BKV, D, THREADS>(Ks, a.k + kv_at, kv_st, k0, a.S);
  load_rows<BKV, D, THREADS>(Vs, a.v + kv_at, kv_st, k0, a.S);
  int t0, t1;
  q_tiles(a, k0, BKV, BQ, &t0, &t1);
  const int nt = t1 - t0, steps = a.group * nt;  // (query head, query tile) steps
  auto load_step = [&](int i) {
    const int h = kh * a.group + i / nt, q0 = (t0 + i % nt) * BQ, slot = i & 1;
    const long long at = (static_cast<long long>(b) * a.S * a.H + h) * D;
    load_rows<BQ, D, THREADS>(Qs + slot * BQ * LD, a.q + at, q_st, q0, a.S);
    load_rows<BQ, D, THREADS>(dOs + slot * BQ * LD, a.dout + at, q_st, q0, a.S);
    const long long row = (static_cast<long long>(b) * a.H + h) * a.S + q0;
    for (int r = threadIdx.x; r < BQ; r += THREADS) {
      const bool in = q0 + r < a.S;
      cp_async4(Ls + slot * BQ + r, in ? a.lse + row + r : a.lse, in);
      cp_async4(Ds + slot * BQ + r, in ? a.delta + row + r : a.delta, in);
    }
  };
  load_step(0);
  cp_async_commit();

  float dk[NN][4], dv[NN][4];
  zero(dk);
  zero(dv);
  const float none[2] = {0.f, 0.f};
  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) load_step(i + 1);
    cp_async_commit();
    cp_async_wait<1>();  // step i's tiles (and k, v) landed
    __syncthreads();
    const int q0 = (t0 + i % nt) * BQ, slot = i & 1;
    if (any_admitted(a, q0, BQ, kw, 16)) {  // warp-uniform
      const float* qs = Qs + slot * BQ * LD;
      const float* dos = dOs + slot * BQ * LD;
      float st[NQ][4], dpt[NQ][4];
      zero(st);
      zero(dpt);
      mma_nt<NQ, D>(st, Ks + (kw - k0) * LD, qs, LD);    // s^T = k q^T
      mma_nt<NQ, D>(dpt, Vs + (kw - k0) * LD, dos, LD);  // dp^T = v do^T
      const int j0 = kw + (lane >> 2);
      if (all_admitted(a, q0, BQ, kw, 16))
        pair_grads<false, true>(a, st, dpt, j0, q0, Ls + slot * BQ, Ds + slot * BQ, none, none);
      else
        pair_grads<true, true>(a, st, dpt, j0, q0, Ls + slot * BQ, Ds + slot * BQ, none, none);
      mma_pn<NN, NQ>(dv, st, dos + c0, LD);  // dv += p^T do
      mma_pn<NN, NQ>(dk, dpt, qs + c0, LD);  // dk += dr^T q
    }
    __syncthreads();  // the slot is read before step i + 2 refills it
  }
  store_rows(a.dk + kv_at, kv_st, c0, kw + (lane >> 2), a.S, dk);
  store_rows(a.dv + kv_at, kv_st, c0, kw + (lane >> 2), a.S, dv);
}

template <int D>
__global__ void __launch_bounds__(BwdTile<D>::DQ_WARPS * 32) flash_bwd_dq_kernel(const Args a) {
  using C = BwdTile<D>;
  constexpr int BQ = C::DQ_BQ, BK = C::DQ_BK, ST = C::DQ_STAGES, LD = C::LD;
  constexpr int THREADS = C::DQ_WARPS * 32, NK = BK / 8, ND = D / C::DQ_CS / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;               // (BQ, LD)
  float* dOs = Qs + BQ * LD;      // (BQ, LD)
  float* Ks = dOs + BQ * LD;      // ST x (BK, LD)
  float* Vs = Ks + ST * BK * LD;  // ST x (BK, LD)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z, kh = h / a.group;
  const long long q_st = static_cast<long long>(a.H) * D, kv_st = static_cast<long long>(a.KH) * D;
  const long long q_at = (static_cast<long long>(b) * a.S * a.H + h) * D;
  const long long kv_at = (static_cast<long long>(b) * a.S * a.KH + kh) * D;
  load_rows<BQ, D, THREADS>(Qs, a.q + q_at, q_st, q0, a.S);
  load_rows<BQ, D, THREADS>(dOs, a.dout + q_at, q_st, q0, a.S);
  int t0, t1;
  kv_tiles(a, q0, BQ, BK, &t0, &t1);
  const int n = t1 - t0;
  auto load_kv = [&](int i) {
    const int k0 = (t0 + i) * BK, slot = i % ST;
    load_rows<BK, D, THREADS>(Ks + slot * BK * LD, a.k + kv_at, kv_st, k0, a.S);
    load_rows<BK, D, THREADS>(Vs + slot * BK * LD, a.v + kv_at, kv_st, k0, a.S);
  };
  load_kv(0);
  cp_async_commit();

  const int rw = warp % C::DQ_RW, c0 = D / C::DQ_CS * (warp / C::DQ_RW);  // its dq columns
  const int qw = q0 + 16 * rw, r0 = qw + (lane >> 2);  // rows r0, r0 + 8
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + 8 * r;
    const long long at = (static_cast<long long>(b) * a.H + h) * a.S + i;
    lr[r] = i < a.S ? a.lse[at] : 0.f;
    dr[r] = i < a.S ? a.delta[at] : 0.f;
  }
  float dq[ND][4];
  zero(dq);
  for (int i = 0; i < n; ++i) {
    if (ST == 2) {
      if (i + 1 < n) load_kv(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = (t0 + i) * BK;
    if (any_admitted(a, qw, 16, k0, BK)) {  // warp-uniform
      const float* kb = Ks + (i % ST) * BK * LD;
      const float* vb = Vs + (i % ST) * BK * LD;
      float s[NK][4], dp[NK][4];
      zero(s);
      zero(dp);
      mma_nt<NK, D>(s, Qs + 16 * rw * LD, kb, LD);    // s = q k^T
      mma_nt<NK, D>(dp, dOs + 16 * rw * LD, vb, LD);  // dp = do v^T
      if (all_admitted(a, qw, 16, k0, BK))
        pair_grads<false, false>(a, s, dp, r0, k0, nullptr, nullptr, lr, dr);
      else
        pair_grads<true, false>(a, s, dp, r0, k0, nullptr, nullptr, lr, dr);
      mma_pn<ND, NK>(dq, dp, kb + c0, LD);  // dq += dr k
    }
    __syncthreads();  // the slot is read before it is refilled
    if (ST == 1 && i + 1 < n) {
      load_kv(i + 1);
      cp_async_commit();
    }
  }
  store_rows(a.dq + q_at, q_st, c0, r0, a.S, dq);
}

template <typename K>
cudaError_t shared_bytes(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  using C = BwdTile<D>;
  const long long rows = static_cast<long long>(B) * a.S * a.H;
  const long long per_block = 8 * (32 / (D / 4 < 32 ? D / 4 : 32));
  const unsigned blocks = static_cast<unsigned>((rows + per_block - 1) / per_block);
  flash_bwd_delta_kernel<D><<<blocks, 256, 0, stream>>>(a, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = shared_bytes(flash_bwd_dkv_kernel<D>, C::KV_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = shared_bytes(flash_bwd_dq_kernel<D>, C::DQ_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<D><<<dim3((a.S + C::BKV - 1) / C::BKV, a.KH, B), C::KV_WARPS * 32,
                            C::KV_SMEM, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<D><<<dim3((a.S + C::DQ_BQ - 1) / C::DQ_BQ, a.H, B), C::DQ_WARPS * 32,
                           C::DQ_SMEM, stream>>>(a);
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
  a.inv_cap = softcap > 0 ? static_cast<float>(1.0 / softcap) : 0.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(a, B, s);
    case 128: return launch<128>(a, B, s);
    case 256: return launch<256>(a, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
