// Batched float32 matrix product in split TF32 on Hopper's tensor cores:
//
//     C[b] = A[b] B[b],   A[b] (M, K), B[b] (K, N), C[b] (M, N) float32,
//
// A and B read in place through their strides: each may be K-major or
// M/N-major (its rows or its columns contiguous), and either may be shared
// by every batch entry (batch stride 0). C is written row-major.
//
// It replaces no TPU kernel: the JAX package leaves its products to XLA.
// It takes the model step's float32 products with the weights (x W, x E^T
// and their gradients dX = dY W^T, dW = X^T dY under torch.func.grad),
// which cuBLAS would run as SIMT sgemm on the CUDA cores at float32
// ("highest"), 67 TFLOP/s.
//
// Bound: operations. At the model's shapes (M = 512 tokens a client, K and
// N 512 to 100,352) the products are far above the card's ops-per-byte
// line. Each float32 product is three TF32 products (split_tf32.cuh: x =
// hi + lo, hi = tf32(x) by split_tf32's rounding, lo = x - hi; lo hi +
// hi lo + hi hi, the small ones first, lo lo dropped) on the tensor cores,
// so the bound is 495 / 3 = 165 TFLOP/s.
//
// Design, one persistent block per SM walking output tiles of 128 x 128
// (BM x BN) in steps of BK = 32 along K, 512 threads in four warpgroups,
// and two rings in shared memory: F_STAGES stages of the float32 A and B
// tiles as TMA writes them, and H_STAGES stages of B's hi and lo tiles.
//   * warp 0 lane 0, the producer: keeps TMA loads of the float32 tiles in
//     flight, running ahead across tile boundaries. The tiles arrive in the
//     128-byte swizzle, in boxes 32 floats wide along the operand's
//     contiguous axis; rows and columns past M, N or K arrive as zeros;
//   * warps 1-7, the splitters: split the stage's B tile into hi and lo
//     tiles of the other ring, K-major in the 128-byte swizzle, which is
//     what wgmma reads (wgmma takes .tf32 operands K-major only): a K-major
//     B chunk for chunk, each thread's five 16-byte loads in flight before
//     its stores; an N-major B (dW's dY) transposed in the same pass, 4 x 4
//     blocks through registers, the blocks of each 8 lanes chosen so that
//     both their 16-byte reads and their writes hit 8 distinct bank quads,
//     and the blocks of successive stages dealt out in one stream (a
//     stage's 256 blocks do not divide among 224 threads).
//     A float32 stage is released once its B tile is read and both
//     consumers hold its A values, so TMA runs up to F_STAGES stages ahead
//     while the hi / lo ring holds the stages in the tensor cores' hands;
//   * warpgroups 2 and 3, the consumers, 64 rows of the tile each: split
//     their A fragments (K-major or M-major: the transpose is in the
//     addressing) in registers, then issue wgmma m64n128k8 .tf32 with A from
//     registers and B from shared memory: lo hi, hi lo, hi hi over the
//     stage's four k8 steps. While those run they load the next stage's A
//     values, so the loads' latency is off the tensor cores' path. The two
//     take turns (two named barriers): one issues its stage while the other
//     folds its last one.
// Where only A is K-major (x W and the head's dX, whose B is an N-major
// weight) the entry computes C^T = B^T A^T instead (the wrapper's choice,
// `trans`), so that the operand split in shared memory is a K-major one and
// the transposing pass is left to dW, whose operands are both MN-major.
// Nothing new is kept in device memory: no hi / lo copy and no transposed
// copy of an operand; the split happens once per tile in shared memory or
// registers.
//
// Accuracy: the tensor cores add into their float32 accumulators with
// truncation, not rounding. Over a whole K (12,544 k8 steps at the tied
// head's K of 100,352) the bias adds up to many times the error of a
// float32 FMA chain, so each stage's products go into a fresh accumulator
// (the first wgmma of a stage overwrites it) that is then added, rounding
// to nearest, into a second float32 accumulator in registers.
//
// Tile order follows the shape: consecutive tiles share the panel of the
// larger operand (the B panel when N >= M, else the A panel), so the
// blocks running together read it from L2 once.
//
// Plain C interface (loaded with ctypes): no PyTorch headers. The entry
// returns cudaGetLastError(), or kEncodeFailed if a tensor map cannot be
// encoded.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "split_tf32.cuh"

namespace {

constexpr int kEncodeFailed = 1000;  // not a cudaError_t

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int F_STAGES = 4, H_STAGES = 3;
constexpr int TILE_BYTES = 128 * BK * 4;  // one float32 tile of 128 x 32: 16 KB
constexpr int F_BYTES = 2 * TILE_BYTES;   // a float32 stage: A and B as loaded
constexpr int H_BYTES = 2 * TILE_BYTES;   // a split stage: B's hi and lo tiles
// warpgroups 0 and 1: the producer (warp 0) and seven splitter warps;
// warpgroups 2 and 3: the consumers
constexpr int THREADS = 512, CONSUMER_WG = 2;
constexpr int SPLITTERS = 224;  // warps 1-7
constexpr int CONSUMER_WARPS = 8;
constexpr int SPLIT_BLOCKS = (BN / 4) * (BK / 4);  // a stage's 4 x 4 blocks of B
// 1 KB of slack to align the rings to the swizzle's 1,024-byte atom
constexpr int SMEM =
    1024 + F_STAGES * F_BYTES + H_STAGES * H_BYTES + 8 * (2 * F_STAGES + 2 * H_STAGES);
static_assert(SMEM <= 232448, "the rings must fit the block's 227 KB of shared memory");
// the block starts with 512 x 128 registers (its launch bounds) and
// setmaxnreg moves them, never more: 256 x 56 + 256 x 200 = 512 x 128 (a
// request past the block's own would wait forever)
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 200;
static_assert(256 * PRODUCER_REGS + 256 * CONSUMER_REGS == THREADS * 128,
              "setmaxnreg must hand on exactly the registers it takes");
// named barriers of the consumers' turns (0 is __syncthreads')
constexpr int TURN_1 = 1, TURN_2 = 2;

struct Args {
  float* c;
  long long c_b, ldc;
  int M, N, K, tiles_m, tiles_n, tiles, k_tiles;
  int a_shared, b_shared, m_fast, c_trans;
};

// byte offset of (row r, column k) in a K-major tile of 128-byte rows in the
// 128-byte swizzle (16-byte chunk k / 4 of row r stored at chunk
// (k / 4) ^ (r % 8)): what TMA writes and what wgmma's descriptors read
__device__ __forceinline__ uint32_t kmajor_off(int r, int k) {
  return r * 128 + ((((k >> 2) ^ r) & 7) << 4) + ((k & 3) << 2);
}

// byte offset of (row r, column k) in an MN-major tile as TMA writes it:
// boxes of 32 rows (the contiguous axis) by BK columns, each column of the
// box a 128-byte line in the 128-byte swizzle
__device__ __forceinline__ uint32_t mnmajor_off(int r, int k) {
  return (r >> 5) * 4096 + k * 128 + (((((r & 31) >> 2) ^ k) & 7) << 4) + ((r & 3) << 2);
}

__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ float4 lds4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts4(uint32_t addr, uint32_t x, uint32_t y, uint32_t z,
                                     uint32_t w) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(x), "r"(y),
               "r"(z), "r"(w)
               : "memory");
}

// makes this thread's generic-proxy writes to shared memory visible to the
// async proxy (the wgmma that reads them)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one box of a 3-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// rows [r0, r0 + 128) x columns [k0, k0 + BK) of an operand of batch entry
// bt into its float32 tile at dst, completing on bar: a K-major operand in
// two boxes of 64 rows, an MN-major one in four boxes of 32 rows (its
// contiguous axis) x BK
template <bool KMAJ>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int k0, int r0, int bt) {
  constexpr int BOXES = KMAJ ? 2 : 4, ROWS = 128 / BOXES, BOX_BYTES = TILE_BYTES / BOXES;
#pragma unroll
  for (int c = 0; c < BOXES; ++c) {
    if (KMAJ)
      tma_load3(dst + c * BOX_BYTES, map, bar, k0, r0 + c * ROWS, bt);
    else
      tma_load3(dst + c * BOX_BYTES, map, bar, r0 + c * ROWS, k0, bt);
  }
}

__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// start address, leading and stride byte offsets (16-byte units), layout 1
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 128, float32, 64 a thread) = A B + (scale_d ? d : 0): A (64 x 8)
// tf32 from registers (a thread's rows g and g + 8 of its warp's 16, columns
// t and t + 4), B (8 x 128) tf32 K-major from shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// a consumer thread's A values of one stage: rows row and row + 8 of the
// tile, columns t4 and t4 + 4 of each of its four k8 steps, v[4 kk + e]
template <bool A_K>
__device__ __forceinline__ void load_a(float (&v)[16], uint32_t a, int row, int t4) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row + 8 * (e & 1), k = 8 * kk + t4 + 4 * (e >> 1);
      v[4 * kk + e] = lds(a + (A_K ? kmajor_off(r, k) : mnmajor_off(r, k)));
    }
}

struct Tile {
  int bt, m0, n0;
};

__device__ __forceinline__ Tile tile_at(const Args& g, int t) {
  const int per = g.tiles_m * g.tiles_n, bt = t / per, r = t - bt * per;
  int tm, tn;
  if (g.m_fast) {
    tm = r % g.tiles_m;
    tn = r / g.tiles_m;
  } else {
    tn = r % g.tiles_n;
    tm = r / g.tiles_n;
  }
  return {bt, tm * BM, tn * BN};
}

// A_K / B_K: A / B K-major (else M- / N-major)
template <bool A_K, bool B_K>
__global__ void __launch_bounds__(THREADS, 1)
    split_tf32_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                           const __grid_constant__ CUtensorMap tb, const Args g) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t split_ring = ring + F_STAGES * F_BYTES;
  auto sA = [&](int s) { return ring + s * F_BYTES; };
  auto sB = [&](int s) { return ring + s * F_BYTES + TILE_BYTES; };
  auto sHi = [&](int h) { return split_ring + h * H_BYTES; };
  auto sLo = [&](int h) { return split_ring + h * H_BYTES + TILE_BYTES; };
  const uint32_t bars = split_ring + H_STAGES * H_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };                    // TMA landed
  auto empty = [&](int s) { return bars + 8u * (F_STAGES + s); };      // float32 read
  auto ready = [&](int h) { return bars + 8u * (2 * F_STAGES + h); };  // B split
  auto spent = [&](int h) { return bars + 8u * (2 * F_STAGES + H_STAGES + h); };  // consumed

  // a stage's splitter arrivals: each splitter warp (B K-major) or each
  // block (B N-major)
  constexpr int SPLIT_ARRIVALS = B_K ? SPLITTERS / 32 : SPLIT_BLOCKS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < F_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), SPLIT_ARRIVALS + CONSUMER_WARPS);  // and each consumer warp
    }
    for (int h = 0; h < H_STAGES; ++h) {
      mbar_init(ready(h), SPLIT_ARRIVALS);
      mbar_init(spent(h), CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the stages this block takes; a float32 stage among the last F_STAGES
  // is released to no one (no load waits for it)
  const int total =
      ((g.tiles - 1 - static_cast<int>(blockIdx.x)) / static_cast<int>(gridDim.x) + 1) *
      g.k_tiles;
  // the warpgroup, broadcast from lane 0 so that the compiler sees it is
  // uniform: a wgmma on a path it takes as divergent is serialised, and
  // setmaxnreg on one is not honoured
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  const int lane = threadIdx.x & 31;
  if (wg < CONSUMER_WG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      // -- producer ------------------------------------------------------------
      int it = 0;
      for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
        const Tile tl = tile_at(g, t);
        const int ba = g.a_shared ? 0 : tl.bt, bb = g.b_shared ? 0 : tl.bt;
        for (int kt = 0; kt < g.k_tiles; ++kt, ++it) {
          const int s = it % F_STAGES, k0 = kt * BK;
          if (it >= F_STAGES) mbar_wait(empty(s), ((it / F_STAGES) + 1) & 1);
          mbar_expect_tx(full(s), 2 * TILE_BYTES);
          load_tile<A_K>(sA(s), &ta, full(s), k0, tl.m0, ba);
          load_tile<B_K>(sB(s), &tb, full(s), k0, tl.n0, bb);
        }
      }
    } else if (threadIdx.x >= 32 && B_K) {
      // -- splitters, B K-major: hi and lo tiles chunk for chunk ----------------
      const int st = threadIdx.x - 32;
      for (int it = 0; it < total; ++it) {
        const int s = it % F_STAGES, h = it % H_STAGES;
        mbar_wait(full(s), (it / F_STAGES) & 1);
        if (it >= H_STAGES) mbar_wait(spent(h), ((it / H_STAGES) + 1) & 1);
        const uint32_t src = sB(s), hi = sHi(h), lo = sLo(h);
        // already K-major in the swizzle: 16-byte chunk st + SPLITTERS i in
        // place, the thread's loads all in flight before its stores
        constexpr int CHUNKS = BN * BK / 4, PER = (CHUNKS + SPLITTERS - 1) / SPLITTERS;
        float4 v[PER];
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int c = st + SPLITTERS * i;
          if (c < CHUNKS) v[i] = lds4(src + 16 * c);
        }
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int c = st + SPLITTERS * i;
          if (c < CHUNKS) {
            uint32_t hv[4], lv[4];
            split_tf32(v[i].x, hv[0], lv[0]);
            split_tf32(v[i].y, hv[1], lv[1]);
            split_tf32(v[i].z, hv[2], lv[2]);
            split_tf32(v[i].w, hv[3], lv[3]);
            sts4(hi + 16 * c, hv[0], hv[1], hv[2], hv[3]);
            sts4(lo + 16 * c, lv[0], lv[1], lv[2], lv[3]);
          }
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
          if (it + F_STAGES < total) mbar_arrive(empty(s));
          mbar_arrive(ready(h));
        }
      }
    } else if (threadIdx.x >= 32) {
      // -- splitters, B N-major: hi and lo tiles transposed -------------------
      // A stage is SPLIT_BLOCKS 4 x 4 blocks (k rows 4 kq.., n columns 4
      // q..); the splitters take the blocks of all the block's stages in
      // turn, thread st block u = st + SPLITTERS j of the stream (stage
      // u / SPLIT_BLOCKS), so no thread does two blocks of a stage while
      // others wait, and each block is signalled on its own. Block b = x +
      // 8 y (x the lane's place among 8): q = x + 8 (y % 4), kq = ((x / 2) ^
      // (y / 4)) % 4 + 4 (y / 16). Among 8 lanes the reads' 16-byte chunk
      // (q ^ k) % 8 and the writes' (kq ^ (4 q + r)) % 8 each take 8
      // values: no bank conflict.
      const int st = threadIdx.x - 32;
      int cur = -1;  // the stage whose barriers this thread has waited on
#pragma unroll 1
      for (int u = st; u < total * SPLIT_BLOCKS; u += SPLITTERS) {
        const int it = u / SPLIT_BLOCKS, b = u % SPLIT_BLOCKS;
        const int s = it % F_STAGES, h = it % H_STAGES;
        if (it != cur) {
          mbar_wait(full(s), (it / F_STAGES) & 1);
          if (it >= H_STAGES) mbar_wait(spent(h), ((it / H_STAGES) + 1) & 1);
          cur = it;
        }
        const uint32_t src = sB(s), hi = sHi(h), lo = sLo(h);
        const int x = b & 7, y = b >> 3;
        const int q = x + 8 * (y & 3);
        const int kq = (((x >> 1) ^ (y >> 2)) & 3) | ((y >> 4) << 2);
        float4 v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = lds4(src + mnmajor_off(4 * q, 4 * kq + k));
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float xs[4] = {r == 0 ? v[0].x : r == 1 ? v[0].y : r == 2 ? v[0].z : v[0].w,
                               r == 0 ? v[1].x : r == 1 ? v[1].y : r == 2 ? v[1].z : v[1].w,
                               r == 0 ? v[2].x : r == 1 ? v[2].y : r == 2 ? v[2].z : v[2].w,
                               r == 0 ? v[3].x : r == 1 ? v[3].y : r == 2 ? v[3].z : v[3].w};
          uint32_t hv[4], lv[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) split_tf32(xs[k], hv[k], lv[k]);
          const uint32_t off = kmajor_off(4 * q + r, 4 * kq);
          sts4(hi + off, hv[0], hv[1], hv[2], hv[3]);
          sts4(lo + off, lv[0], lv[1], lv[2], lv[3]);
        }
        fence_proxy_async();
        if (it + F_STAGES < total) mbar_arrive(empty(s));
        mbar_arrive(ready(h));
      }
    }
  } else {
    // -- consumers: 64 rows of the tile each ---------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int tw = threadIdx.x - 128 * wg, warp = tw >> 5, gq = lane >> 2, t4 = lane & 3;
    const int row = 64 * (wg - CONSUMER_WG) + 16 * warp + gq;  // rows row and row + 8
    // turns: the first consumer warpgroup issues a stage, then the second ...
    const bool first = wg == CONSUMER_WG;
    const int my_turn = first ? TURN_1 : TURN_2, next_turn = first ? TURN_2 : TURN_1;
    if (!first) turn_pass(TURN_1);
    float acc[64], sum[64];
    // the next stage's A values, loaded while this stage's products run
    float anext[16];
    mbar_wait(full(0), 0);
    load_a<A_K>(anext, sA(0), row, t4);
    int it = 0;
    for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
      const Tile tl = tile_at(g, t);
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] = 0.f;
      for (int kt = 0; kt < g.k_tiles; ++kt, ++it) {
        const int s = it % F_STAGES, h = it % H_STAGES;
        // A fragments of the stage's four k8 steps, split in registers
        uint32_t ahi[4][4], alo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(anext[4 * kk + e], ahi[kk][e], alo[kk][e]);
        fence_regs(ahi);  // the loads have returned before the stage is released
        fence_regs(alo);
        __syncwarp();
        if (lane == 0 && it + F_STAGES < total) mbar_arrive(empty(s));
        mbar_wait(ready(h), (it / H_STAGES) & 1);
        turn_wait(my_turn);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_tf32(acc, alo[kk], sw128_desc(sHi(h) + 32 * kk), kk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_tf32(acc, ahi[kk], sw128_desc(sLo(h) + 32 * kk), 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_tf32(acc, ahi[kk], sw128_desc(sHi(h) + 32 * kk), 1);
        wgmma_commit();
        turn_pass(next_turn);
        if (it + 1 < total) {
          const int sn = (it + 1) % F_STAGES;
          mbar_wait(full(sn), ((it + 1) / F_STAGES) & 1);
          load_a<A_K>(anext, sA(sn), row, t4);
        }
        wgmma_wait_all();
        fence_regs(acc);  // and the A fragments, which the wgmmas read until now
        fence_regs(ahi);
        fence_regs(alo);
        __syncwarp();
        if (lane == 0) mbar_arrive(spent(h));
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] += acc[i];
      }
      // sum[4j + e]: row row + 8 (e >> 1), column 8 j + 2 t4 + (e & 1)
      float* cb = g.c + tl.bt * g.c_b;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = tl.m0 + row + 8 * hh;
        if (m >= g.M) continue;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int n = tl.n0 + 8 * j + 2 * t4;
          const float xv = sum[4 * j + 2 * hh], yv = sum[4 * j + 2 * hh + 1];
          if (g.c_trans) {  // C^T was computed: its (m, n) is C's (n, m)
            if (n < g.N) cb[n * g.ldc + m] = xv;
            if (n + 1 < g.N) cb[(n + 1) * g.ldc + m] = yv;
          } else if (n + 1 < g.N && (g.ldc & 1) == 0) {
            *reinterpret_cast<float2*>(cb + m * g.ldc + n) = make_float2(xv, yv);
          } else {
            if (n < g.N) cb[m * g.ldc + n] = xv;
            if (n + 1 < g.N) cb[m * g.ldc + n + 1] = yv;
          }
        }
      }
    }
    if (first) turn_wait(TURN_1);  // the other warpgroup's last pass
  }
}

// -- host side ----------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map over a float32 operand seen as (inner, outer, batch): inner
// the contiguous axis, strides in elements; boxes of 32 x rows x 1 in the
// 128-byte swizzle, out-of-range elements read as zeros. A shared operand
// (batch stride 0) is one batch entry; an axis of size 1 gets any stride
// that TMA takes.
bool encode(CUtensorMap* map, const void* base, long long inner, long long outer,
            long long batch, long long outer_st, long long batch_st, int rows) {
  EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const long long line = ((inner * 4 + 15) / 16) * 16;
  if (batch_st == 0) batch = 1;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(outer > 1 ? outer_st * 4 : line),
      static_cast<cuuint64_t>(batch > 1 ? batch_st * 4 : line * outer)};
  const cuuint32_t box[3] = {32, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <bool A_K, bool B_K>
int launch(const CUtensorMap& ta, const CUtensorMap& tb, const Args& g, int blocks,
           cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      split_tf32_gemm_kernel<A_K, B_K>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  split_tf32_gemm_kernel<A_K, B_K><<<blocks, THREADS, SMEM, stream>>>(ta, tb, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C[b] = A[b] B[b] for b < batch: A (M, K) with element strides a_b, a_m,
// a_k; B (K, N) with b_b, b_k, b_n; C (M, N) float32 with c_b and row
// stride ldc, written whole. A is K-major when a_k == 1, else M-major with
// a_m == 1; B is K-major when b_k == 1, else N-major with b_n == 1. A batch
// stride of 0 shares the operand. Every other stride, and both base
// addresses, must be 16-byte multiples (TMA's); K >= 1. blocks: the
// persistent grid (the card's SM count; fewer if there are fewer tiles).
// trans: compute C^T = B^T A^T instead (B^T the kernel's A, A^T its B,
// C^T written into C transposed), so that A is the operand split in
// shared memory.
extern "C" int repro_split_gemm(const void* a, const void* b, void* c, int batch, int M, int N,
                                int K, int64_t a_b, int64_t a_m, int64_t a_k, int64_t b_b,
                                int64_t b_k, int64_t b_n, int64_t c_b, int64_t ldc, int blocks,
                                int trans, void* stream) {
  if (batch <= 0 || M <= 0 || N <= 0) return 0;
  if (K <= 0 || blocks <= 0 || (a_k != 1 && a_m != 1) || (b_k != 1 && b_n != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (trans) {  // (M, K) x (K, N) becomes (N, K) x (K, M)
    const void* p = a;
    a = b;
    b = p;
    const int m = M;
    M = N;
    N = m;
    const int64_t ab = a_b, am = a_m, ak = a_k;
    a_b = b_b;
    a_m = b_n;
    a_k = b_k;
    b_b = ab;
    b_k = ak;
    b_n = am;
  }
  const bool ak = a_k == 1, bk = b_k == 1;
  CUtensorMap ta, tb;
  const bool ok_a = ak ? encode(&ta, a, K, M, batch, a_m, a_b, BM / 2)
                       : encode(&ta, a, M, K, batch, a_k, a_b, BK);
  const bool ok_b = bk ? encode(&tb, b, K, N, batch, b_n, b_b, BN / 2)
                       : encode(&tb, b, N, K, batch, b_k, b_b, BK);
  if (!ok_a || !ok_b) return kEncodeFailed;
  Args g;
  g.c = static_cast<float*>(c);
  g.c_b = c_b;
  g.ldc = ldc;
  g.M = M;
  g.N = N;
  g.K = K;
  g.tiles_m = (M + BM - 1) / BM;
  g.tiles_n = (N + BN - 1) / BN;
  g.tiles = batch * g.tiles_m * g.tiles_n;
  g.k_tiles = (K + BK - 1) / BK;
  g.a_shared = a_b == 0;
  g.b_shared = b_b == 0;
  g.m_fast = N >= M;  // consecutive tiles share B's panel when B is the larger
  g.c_trans = trans != 0;
  if (blocks > g.tiles) blocks = g.tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ak && bk) return launch<true, true>(ta, tb, g, blocks, s);
  if (ak) return launch<true, false>(ta, tb, g, blocks, s);
  if (bk) return launch<false, true>(ta, tb, g, blocks, s);
  return launch<false, false>(ta, tb, g, blocks, s);
}
