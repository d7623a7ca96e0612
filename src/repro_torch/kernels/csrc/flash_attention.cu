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
// bf16 tensor-core work, or, in float32, 165 TFLOP/s of split TF32 (three
// TF32 products per float32 one at 495 TFLOP/s: split_tf32.cuh; the same
// work in float32 FMAs on the CUDA cores, 67 TFLOP/s, takes 2.5x as long);
// the bytes (q, k, v read once, out written once) are some 5x below
// that at S = 4,608, D = 256. Beside the products, each admitted pair costs
// an exp and, with a softcap, a tanh on the multi-function unit (~3.9 T/s on
// the card): 50-75% of the bf16 product bound at gemma2's shapes if it ran
// alone.
//
// bfloat16 / float16: one block owns 128 query rows of one (b, h) and is
// warp-specialised (384 threads):
//   * a producer warpgroup, of which one thread issues TMA loads: the Q
//     tile once, then K and V tiles into rings of STAGES slots in shared
//     memory (2 at D = 256, 3 at 128, 4 at 64), in the order they are
//     used (K0, K1, V0, K2, V1, ...), each with its own mbarrier; a K slot
//     is refilled once both consumers have its QK^T, a V slot once they
//     have its PV.
//     Tensor maps over the (D, S, H, B) view, encoded on the host from the
//     caller's strides: q, k, v are read in place, rows past S arrive as
//     zeros, every box is 64 columns (128 bytes) wide with the 128-byte
//     swizzle the wgmma descriptors name;
//   * two consumer warpgroups of 64 query rows each, setmaxnreg moving
//     registers from the producer to them. S = Q K^T is a wgmma with both
//     operands in shared memory (K-major); O += P V a wgmma with P in
//     registers (the S accumulator rounded to the input dtype, as the
//     reference casts the probabilities to v's dtype) and V read MN-major
//     through the descriptor's transpose bit, in its natural layout;
//   * ping-pong: the consumers take turns on the tensor cores through two
//     named barriers; a turn issues this tile's QK^T and the previous
//     tile's PV, so one warpgroup's softmax (exp, softcap) runs while the
//     other's products do; within a warpgroup the softmax of tile j
//     overlaps the PV of tile j - 1, and O's rescale to tile j's max runs
//     under the QK^T of tile j + 1.
// kv tiles: BK = 80 keys at D = 256 (Q 64 KB + 2 stages x (40 + 40) KB;
// the O accumulator takes 128 registers a thread, S 40, P 20), 128 at
// D <= 128. The block's tile range, and which tiles need a
// per-element mask (those crossing the diagonal, the window's lower edge or
// S), mirror repro_torch/kernels/flash_attention.py:tile_plan (the card tests
// hold the kernel's own plan, from repro_flash_tile_plan, to it), the masks per
// consumer warpgroup: a full tile takes no test; a tile outside a
// warpgroup's rows is masked whole, so every wgmma is issued on every path
// (a wgmma under a branch is serialised by the compiler). Heavy diagonal
// blocks launch first. The softcap is
//     cap * tanh(y) = cap * (1 - 2 / (1 + 2^(2 y log2 e))),  y = x / cap,
// with ex2.approx and rcp.approx (absolute error ~1e-5 at cap 50; tanh.approx
// would be off by up to ~0.02 near saturation), and the softmax runs in
// base 2 (logits times log2 e, ex2.approx).
//
// float32 takes its own kernel, on the tensor cores in split TF32
// (split_tf32.cuh: x = hi + lo, three TF32 mma.sync m16n8k8 products per
// float32 one, float32 accumulators; mma.sync rather than wgmma because
// wgmma reads tf32 operands K-major only, which O += P V's V is not):
// blocks of 64 query rows (128 at D = 128), 16 rows a warp (two warps
// each taking half of O's columns at D = 256), kv tiles of 32 keys
// through a two-slot cp.async ring, the next tile
// loading while this one's products run. S = Q K^T with both operands from
// padded shared memory; P stays in registers as the A operand of O += P V
// (its columns taken in the order the accumulator holds them, V's rows
// read in the same order). The logits, softcap (tanhf), mask, online
// softmax (__expf) and row sums stay float32 on the CUDA cores. A warp skips a kv tile that holds no key its rows
// admit; a tile crossing the diagonal, the window's lower edge or S is
// masked per element. Given an lse buffer it also writes each row's
// log-sum-exp of the logits, (B, H, S) float32, for the backward kernel
// (flash_attention_bwd.cu); the bf16 / f16 kernel writes none.
//
// Plain C interface (loaded with ctypes): no PyTorch headers. The CUDA
// driver's cuTensorMapEncodeTiled is reached through cudaGetDriverEntryPoint, so the
// library needs no -lcuda. Each launch goes on the caller's stream,
// allocates nothing, and the entry returns cudaGetLastError(), or
// kEncodeFailed if a tensor map cannot be encoded.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "split_tf32.cuh"

namespace {

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, S) row log-sum-exp, or null (float32 kernel only)
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
  int S, group, causal, window;
  float scale, cap, inv_cap;  // cap <= 0: no softcap
};

constexpr int kEncodeFailed = 1000;  // not a cudaError_t

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
  if (a.cap > 0.f) x = a.cap * tanhf(x * a.inv_cap);
  return x;
}

// kv tiles [*t0, *t1) that hold a key admitted for some query row in
// [q0, q0 + bq): flash_attention.py:tile_plan. Host and device: the host
// entry repro_flash_tile_plan runs it for the card tests.
__host__ __device__ __forceinline__ void kv_tiles(const Args& a, int q0, int bq, int bk,
                                                  int* t0, int* t1) {
  int lo = 0, hi = a.S;
  if (a.causal) {
    if (q0 + bq < hi) hi = q0 + bq;
    if (a.window > 0 && q0 - a.window + 1 > 0) lo = q0 - a.window + 1;
  }
  *t0 = lo / bk;
  *t1 = (hi + bk - 1) / bk;
}

// Whether the kv tile at k0 holds a pair (i, j), i in [q0, min(q0 + bq, S)),
// that the mask refuses: flash_attention.py:tile_plan. Host and device.
__host__ __device__ __forceinline__ bool tile_masked(const Args& a, int q0, int bq, int k0,
                                                     int bk) {
  if (k0 + bk > a.S) return true;
  if (!a.causal) return false;
  if (k0 + bk - 1 > q0) return true;
  const int last = q0 + bq < a.S ? q0 + bq - 1 : a.S - 1;  // the block's last row
  return a.window > 0 && k0 <= last - a.window;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// -- Hopper primitives (the mbarriers: hopper.cuh) ------------------------------

// one box of a 4-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the fence
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma shared-memory descriptor of a tile in the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units), layout 1 (B128)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

// wgmma m64nNk16, float32 accumulators d (N / 2 a thread). SS: A and B
// K-major from shared memory; RS: A from registers (4 x 32 bits), B MN-major
// (transposed) from shared memory. scale_d = 0 overwrites d.

#define WGMMA_SS_N64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "%32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(a), "l"(b), "r"(scale_d))

#define WGMMA_SS_N128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
      "%64, %65, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(a), "l"(b), "r"(scale_d))

#define WGMMA_SS_N80(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n80k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39}, " \
      "%40, %41, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]) \
      : "l"(a), "l"(b), "r"(scale_d))

#define WGMMA_RS_N64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d))

#define WGMMA_RS_N128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d))

#define WGMMA_RS_N256(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, " \
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d))


template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int scale_d) {
  static_assert(N == 64 || N == 80 || N == 128, "QK^T tile width");
  if constexpr (N == 64) {
    if constexpr (kIsBf16<T>) WGMMA_SS_N64("bf16"); else WGMMA_SS_N64("f16");
  } else if constexpr (N == 80) {
    if constexpr (kIsBf16<T>) WGMMA_SS_N80("bf16"); else WGMMA_SS_N80("f16");
  } else {
    if constexpr (kIsBf16<T>) WGMMA_SS_N128("bf16"); else WGMMA_SS_N128("f16");
  }
}

template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a, uint64_t b,
                                         int scale_d) {
  static_assert(N == 64 || N == 128 || N == 256, "head dim");
  if constexpr (N == 64) {
    if constexpr (kIsBf16<T>) WGMMA_RS_N64("bf16"); else WGMMA_RS_N64("f16");
  } else if constexpr (N == 128) {
    if constexpr (kIsBf16<T>) WGMMA_RS_N128("bf16"); else WGMMA_RS_N128("f16");
  } else {
    if constexpr (kIsBf16<T>) WGMMA_RS_N256("bf16"); else WGMMA_RS_N256("f16");
  }
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsBf16<T>) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// -- the bfloat16 / float16 kernel ---------------------------------------------

template <int D>
struct Tile {
  static constexpr int BQ = 128;                // query rows of a block
  static constexpr int WQ = 64;                 // ... of a consumer warpgroup
  static constexpr int BK = D == 256 ? 80 : 128;  // keys of a kv tile
  // ring depth: as many K and V tiles as fit beside Q in 227 KB
  static constexpr int STAGES = D == 256 ? 2 : D == 128 ? 3 : 4;
  static constexpr int CHUNKS = D / 64;         // 128-byte column boxes of a row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one K or V tile
  static constexpr int BAR_BYTES = 8 * (1 + 4 * STAGES);
  // 1 KB of slack to align the ring to the swizzle's 1,024-byte atom
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES;
  static constexpr int THREADS = 384;  // 2 consumer warpgroups + the producer's
  // 128 x 24 + 256 x 240 <= the 384 x 168 registers the block starts with
  static constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
};

// One consumer thread's rows r0 = row and r1 = row + 8; s[4j + e] is the
// score of key k0 + 8j + 2t + (e & 1) for row e < 2 ? r0 : r1 (the wgmma
// accumulator layout). Turns the scores into probabilities in place (base
// 2), updates the running max and sum, returns the factors that rescale O.
template <bool kMask, bool kCap, int BK>
__device__ __forceinline__ void softmax_tile(const Args& a, float (&s)[BK / 2], int k0,
                                             int r0, int t, float mul, float inner,
                                             float (&m)[2], float (&l)[2], float (&al)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    float x = s[i];
    if constexpr (kCap) {
      // cap * tanh(y) * log2 e with y = x * scale / cap; mul = cap * log2 e
      const float e = ex2(x * inner);  // inner = 2 log2 e * scale / cap
      x = fmaf(-2.f * mul, rcp(1.f + e), mul);
    } else {
      x *= mul;  // mul = scale * log2 e
    }
    if constexpr (kMask) {
      const int kpos = k0 + (i / 4) * 8 + 2 * t + (i & 1);
      if (!admitted(a, r0 + ((i & 2) ? 8 : 0), kpos)) x = -INFINITY;
    }
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], quad_max(mx[r]));
    // a row with nothing admitted yet keeps max -inf: shift by 0 instead
    mu[r] = mn == -INFINITY ? 0.f : mn;
    al[r] = ex2(m[r] - mu[r]);
    m[r] = mn;
    l[r] *= al[r];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    s[i] = ex2(s[i] - mu[(i >> 1) & 1]);
    l[(i >> 1) & 1] += s[i];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Tile<D>::THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const Args a) {
  using C = Tile<D>;
  constexpr int BQ = C::BQ, WQ = C::WQ, BK = C::BK, ST = C::STAGES, CH = C::CHUNKS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + C::Q_BYTES;         // ST K tiles
  const uint32_t sV = sK + ST * C::KV_BYTES;   // ST V tiles
  const uint32_t sBar = sV + ST * C::KV_BYTES;
  const uint32_t q_full = sBar;
  auto k_full = [&](int s) { return sBar + 8u * (1 + s); };
  auto v_full = [&](int s) { return sBar + 8u * (1 + ST + s); };
  auto k_empty = [&](int s) { return sBar + 8u * (1 + 2 * ST + s); };
  auto v_empty = [&](int s) { return sBar + 8u * (1 + 3 * ST + s); };

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // diagonal-heavy first
  const int h = blockIdx.y, b = blockIdx.z, kh = h / a.group;
  int t0, t1;
  kv_tiles(a, q0, BQ, BK, &t0, &t1);
  const int n = t1 - t0;  // >= 1: every row admits its own key, or all keys

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      // every consumer thread releases a slot: K once QK^T is done, V once PV is
      mbar_init(k_empty(s), 2 * 128);
      mbar_init(v_empty(s), 2 * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the warpgroup, broadcast from lane 0 so that the compiler sees it is
  // uniform: a wgmma on a path it takes as divergent is serialised, and
  // setmaxnreg on one is not honoured
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 2) {
    // -- producer: one thread keeps the ring full ------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS));
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int c = 0; c < CH; ++c)
        tma_load(sQ + c * BQ * 128, &tq, q_full, c * 64, q0, h, b);
      // in the order the consumers take them: K0, K1, V0, K2, V1, ...
      for (int i = 0; i <= n; ++i) {
        if (i < n) {
          const int s = i % ST;
          if (i >= ST) mbar_wait(k_empty(s), ((i / ST) - 1) & 1);
          mbar_expect_tx(k_full(s), C::KV_BYTES);
          for (int c = 0; c < CH; ++c)
            tma_load(sK + s * C::KV_BYTES + c * BK * 128, &tk, k_full(s), c * 64,
                     (t0 + i) * BK, kh, b);
        }
        if (i > 0) {
          const int j = i - 1, s = j % ST;
          if (j >= ST) mbar_wait(v_empty(s), ((j / ST) - 1) & 1);
          mbar_expect_tx(v_full(s), C::KV_BYTES);
          for (int c = 0; c < CH; ++c)
            tma_load(sV + s * C::KV_BYTES + c * BK * 128, &tv, v_full(s), c * 64,
                     (t0 + j) * BK, kh, b);
        }
      }
    }
  } else {
    // -- consumers: 64 query rows each ----------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS));
    constexpr float kLog2e = 1.4426950408889634f;
    const int tw = threadIdx.x % 128, lane = tw % 32, t = lane % 4;
    const int qw = q0 + wg * WQ;                    // this warpgroup's first row
    const int r0 = qw + (tw / 32) * 16 + lane / 4;  // this thread's rows r0, r0 + 8
    const bool cap = a.cap > 0.f;
    const float mul = cap ? a.cap * kLog2e : a.scale * kLog2e;
    const float inner = cap ? 2.f * kLog2e * a.scale / a.cap : 0.f;

    float o[D / 2], s[BK / 2];
    uint32_t p[BK / 4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, al[2];

    // Q, K: K-major, 8-row groups 1,024 bytes apart, +32 bytes per k16 step
    // inside a 64-column box, the next box (rows x 128 bytes) on. V:
    // MN-major, 8-key groups 1,024 bytes apart, the next 64 columns one box
    // (BK x 128 bytes) on.
    const uint32_t qa = sQ + wg * WQ * 128;
    auto qk = [&](int i) {  // S = Q K^T for the tile in ring slot i
      const uint32_t kb = sK + (i % ST) * C::KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = (ks % 4) * 32;
        wgmma_ss<T, BK>(s, sw128_desc(qa + (ks / 4) * BQ * 128 + off, 16, 1024),
                        sw128_desc(kb + (ks / 4) * BK * 128 + off, 16, 1024), ks > 0);
      }
      wgmma_commit();
    };
    auto pv = [&](int i) {  // O += P V for the tile in ring slot i
      mbar_wait(v_full(i % ST), (i / ST) & 1);
      const uint32_t vb = sV + (i % ST) * C::KV_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<T, D>(o, p + 4 * kk, sw128_desc(vb + kk * 16 * 128, BK * 128, 1024), 1);
      wgmma_commit();
    };
    // Every tile of the block's range is computed: one outside this
    // warpgroup's rows is masked whole (p = 0), so the wgmmas are issued
    // on every path and the compiler keeps them asynchronous.
    auto softmax = [&](int i) {
      const int k0 = (t0 + i) * BK;
      if (tile_masked(a, qw, WQ, k0, BK)) {
        if (cap) softmax_tile<true, true, BK>(a, s, k0, r0, t, mul, inner, m, l, al);
        else softmax_tile<true, false, BK>(a, s, k0, r0, t, mul, inner, m, l, al);
      } else {
        if (cap) softmax_tile<false, true, BK>(a, s, k0, r0, t, mul, inner, m, l, al);
        else softmax_tile<false, false, BK>(a, s, k0, r0, t, mul, inner, m, l, al);
      }
    };
    auto to_p = [&]() {
      // the A fragment of m64k16 for keys 16 kk ..: rows r0 / r0 + 8, keys
      // 2t.. and 2t + 8.. -- accumulator blocks 2 kk and 2 kk + 1
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        p[4 * kk + 0] = pack2<T>(s[8 * kk + 0], s[8 * kk + 1]);
        p[4 * kk + 1] = pack2<T>(s[8 * kk + 2], s[8 * kk + 3]);
        p[4 * kk + 2] = pack2<T>(s[8 * kk + 4], s[8 * kk + 5]);
        p[4 * kk + 3] = pack2<T>(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };

    // Turns on the tensor cores, named barriers 1 (warpgroup 0's) and 2:
    // each warpgroup waits for its own and, after issuing, hands the other
    // its turn; warpgroup 1 starts by handing warpgroup 0 the first and
    // gives none after its last, so both barriers end balanced.
    const int me = 1 + wg, other = 2 - wg;
    if (wg == 1) named_arrive(1, 256);
    mbar_wait(q_full, 0);
    mbar_wait(k_full(0), 0);
    named_sync(me, 256);
    qk(0);
    named_arrive(other, 256);
    wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(k_empty(0));
    softmax(0);
    to_p();
    auto rescale = [&]() {  // O to the running max of the last softmax
      fence_regs(o);         // not before the QK^T above is issued
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 0] *= al[0];
        o[4 * j + 1] *= al[0];
        o[4 * j + 2] *= al[1];
        o[4 * j + 3] *= al[1];
      }
    };
    for (int i = 1; i < n; ++i) {
      mbar_wait(k_full(i % ST), (i / ST) & 1);
      named_sync(me, 256);
      qk(i);
      rescale();  // while QK^T runs
      pv(i - 1);
      named_arrive(other, 256);
      wgmma_wait<1>();  // S of tile i; the PV of tile i - 1 runs on
      fence_regs(s);
      mbar_arrive(k_empty(i % ST));
      softmax(i);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      mbar_arrive(v_empty((i - 1) % ST));
      to_p();
    }
    named_sync(me, 256);
    rescale();
    pv(n - 1);
    if (wg == 0) named_arrive(other, 256);
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(v_empty((n - 1) % ST));

    T* og = static_cast<T*>(a.o) + b * a.o_b + h * a.o_h;
    const float inv0 = 1.f / fmaxf(quad_sum(l[0]), 1e-30f);
    const float inv1 = 1.f / fmaxf(quad_sum(l[1]), 1e-30f);
    const int r1 = r0 + 8;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int d = j * 8 + 2 * t;
      if (r0 < a.S)
        *reinterpret_cast<uint32_t*>(og + r0 * a.o_s + d) =
            pack2<T>(o[4 * j + 0] * inv0, o[4 * j + 1] * inv0);
      if (r1 < a.S)
        *reinterpret_cast<uint32_t*>(og + r1 * a.o_s + d) =
            pack2<T>(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

// -- the float32 kernel: split TF32 on the tensor cores --------------------------

// One block owns BQ query rows of one (b, h), 16 rows a warp; kv tiles of BK
// keys stream through a two-slot cp.async ring (tile i + 1 loads while tile
// i's products run). kv tiles of 32 keys keep the ring small and the S
// accumulator at 16 registers: at D = 64 three blocks fit an SM (64 keys
// leave room for two). At D = 128 a block has 8 row warps
// sharing each K and V tile; at D = 256 CS = 2 warps share each 16 rows,
// each accumulating D / 2 columns of O (all D would spill), both computing
// the rows' scores and softmax.
template <int D>
struct Tf32Tile {
  static constexpr int RW = D == 128 ? 8 : 4;    // warps along the rows
  static constexpr int CS = D == 256 ? 2 : 1;    // warps along O's columns
  static constexpr int WARPS = RW * CS;
  static constexpr int BQ = 16 * RW;             // query rows of a block
  static constexpr int BK = 32;                  // keys of a kv tile
  static constexpr int LD = D + 4;               // row stride in shared memory
  static constexpr int STAGES = 2;
  static constexpr int SMEM = (BQ + 2 * STAGES * BK) * LD * 4;
};

template <int D>
__global__ void __launch_bounds__(Tf32Tile<D>::WARPS * 32)
    flash_tf32_kernel(const Args a) {
  using C = Tf32Tile<D>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, ST = C::STAGES;
  constexpr int THREADS = C::WARPS * 32, NK = BK / 8, ND = D / C::CS / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;              // (BQ, LD)
  float* Ks = Qs + BQ * LD;      // ST x (BK, LD)
  float* Vs = Ks + ST * BK * LD;  // ST x (BK, LD)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // diagonal-heavy first
  const int h = blockIdx.y, b = blockIdx.z, kh = h / a.group;
  const float* qg = static_cast<const float*>(a.q) + b * a.q_b + h * a.q_h;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_b + kh * a.k_h;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_b + kh * a.v_h;
  int t0, t1;
  kv_tiles(a, q0, BQ, BK, &t0, &t1);
  const int n = t1 - t0;  // >= 1: every row admits its own key, or all keys
  auto load_kv = [&](int i) {
    const int k0 = (t0 + i) * BK, slot = i % ST;
    load_rows<BK, D, THREADS>(Ks + slot * BK * LD, kg, a.k_s, k0, a.S);
    load_rows<BK, D, THREADS>(Vs + slot * BK * LD, vg, a.v_s, k0, a.S);
  };
  load_rows<BQ, D, THREADS>(Qs, qg, a.q_s, q0, a.S);
  load_kv(0);
  cp_async_commit();

  const int rw = warp % C::RW, c0 = D / C::CS * (warp / C::RW);  // its O columns
  const int qw = q0 + 16 * rw;         // the warp's first row
  const int r0 = qw + (lane >> 2);     // this thread's rows r0 and r0 + 8
  int w0, w1;  // the kv tiles holding a key some row of the warp admits
  kv_tiles(a, qw, 16, BK, &w0, &w1);
  float o[ND][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) load_kv(i + 1);
    cp_async_commit();  // (empty after the last tile: the count stays even)
    cp_async_wait<1>();  // tile i (and Q) landed
    __syncthreads();
    const int kt = t0 + i, k0 = kt * BK;
    if (kt >= w0 && kt < w1) {  // warp-uniform: no mma.sync under divergence
      const float* kb = Ks + (i % ST) * BK * LD;
      const float* vb = Vs + (i % ST) * BK * LD;
      float s[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      mma_nt<NK, D>(s, Qs + 16 * rw * LD, kb, LD);
      // logits (scale, softcap), mask, online softmax: s[j][e] is the score
      // of row r0 + (e < 2 ? 0 : 8) against key k0 + 8 j + 2 t + (e & 1)
      const bool masked = tile_masked(a, qw, 16, k0, BK);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = to_logit(a, s[j][e]);
          if (masked && !admitted(a, r0 + (e & 2) * 4, k0 + 8 * j + 2 * t + (e & 1)))
            x = -INFINITY;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float mu[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = quad_max(mx[r]);
        mu[r] = mn == -INFINITY ? 0.f : mn;  // nothing admitted yet: shift by 0
        const float al = __expf(m[r] - mu[r]);
        m[r] = mn;
        l[r] *= al;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          o[j][2 * r] *= al;
          o[j][2 * r + 1] *= al;
        }
      }
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = __expf(s[j][e] - mu[e >> 1]);
          l[e >> 1] += s[j][e];
        }
      mma_pn<ND, NK>(o, s, vb + c0, LD);
    }
    __syncthreads();  // the slot is read before tile i + 2 refills it
  }

  float* og = static_cast<float*>(a.o) + b * a.o_b + h * a.o_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    const float lt = quad_sum(l[r]);
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    if (row < a.S) {
#pragma unroll
      for (int j = 0; j < ND; ++j)
        *reinterpret_cast<float2*>(og + row * a.o_s + c0 + 8 * j + 2 * t) =
            make_float2(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
      if (a.lse && t == 0 && c0 == 0)
        a.lse[(static_cast<long long>(b) * gridDim.y + h) * a.S + row] = m[r] + logf(lt);
    }
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

// A tensor map over the (D, S, heads, B) view of a (B, S, heads, D) operand
// with the given element strides, boxes of 64 columns x `rows` rows, the
// 128-byte swizzle, rows past S read as zeros. A dimension of size 1 gets a
// stride of one row: only its coordinate 0 is read.
template <typename T>
bool encode(CUtensorMap* map, const void* base, int D, int S, int heads, int B,
            long long s_st, long long h_st, long long b_st, int rows) {
  EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const long long row = static_cast<long long>(D) * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(S > 1 ? s_st * 2 : row),
                                 static_cast<cuuint64_t>(heads > 1 ? h_st * 2 : row),
                                 static_cast<cuuint64_t>(B > 1 ? b_st * 2 : row)};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapDataType ty =
      kIsBf16<T> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  return fn(map, ty, 4, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D>
int launch_wgmma(const Args& a, int B, int H, int KH, cudaStream_t stream) {
  using C = Tile<D>;
  CUtensorMap tq, tk, tv;
  if (!encode<T>(&tq, a.q, D, a.S, H, B, a.q_s, a.q_h, a.q_b, C::BQ) ||
      !encode<T>(&tk, a.k, D, a.S, KH, B, a.k_s, a.k_h, a.k_b, C::BK) ||
      !encode<T>(&tv, a.v, D, a.S, KH, B, a.v_s, a.v_h, a.v_b, C::BK))
    return kEncodeFailed;
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + C::BQ - 1) / C::BQ, H, B);
  flash_wgmma_kernel<T, D><<<grid, C::THREADS, C::SMEM, stream>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_tf32(const Args& a, int B, int H, cudaStream_t stream) {
  using C = Tf32Tile<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_tf32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.S + C::BQ - 1) / C::BQ, H, B);
  flash_tf32_kernel<D><<<grid, C::WARPS * 32, C::SMEM, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core kernel's tile plan (see repro_flash_tile_plan), from its own
// Tile constants and the kv_tiles / tile_masked calls it makes.
template <int D>
int tile_plan(const Args& a, int* sizes, int* ranges, unsigned char* masks) {
  using C = Tile<D>;
  sizes[0] = C::BQ;
  sizes[1] = C::WQ;
  sizes[2] = C::BK;
  int n = 0;
  for (int q0 = 0; q0 < a.S; q0 += C::BQ) {
    int t0, t1;
    kv_tiles(a, q0, C::BQ, C::BK, &t0, &t1);
    if (ranges) {
      ranges[2 * (q0 / C::BQ)] = t0;
      ranges[2 * (q0 / C::BQ) + 1] = t1;
    }
    for (int t = t0; t < t1; ++t)
      for (int wg = 0; wg < 2; ++wg, ++n)
        if (masks) masks[n] = tile_masked(a, q0 + wg * C::WQ, C::WQ, t * C::BK, C::BK);
  }
  return n;
}

template <int D>
int launch_dtype(int dtype, const Args& a, int B, int H, int KH, cudaStream_t s) {
  switch (dtype) {
    case 0: return launch_tf32<D>(a, B, H, s);
    case 2: return launch_wgmma<__nv_bfloat16, D>(a, B, H, KH, s);
    case 3: return launch_wgmma<__half, D>(a, B, H, KH, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype codes: 0 float32, 2 bfloat16, 3 float16 (float64 is not taken).
// Strides in elements; the head dim is contiguous. window <= 0: none;
// softcap <= 0: none. lse: null, or (float32 only) a contiguous (B, H, S)
// float32 buffer for the rows' log-sum-exp.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                     void* o, void* lse, int64_t q_b, int64_t q_s, int64_t q_h,
                                     int64_t k_b, int64_t k_s, int64_t k_h, int64_t v_b,
                                     int64_t v_s, int64_t v_h, int64_t o_b, int64_t o_s,
                                     int64_t o_h, int B, int S, int H, int KH, int D,
                                     int causal, int window, double scale, double softcap,
                                     void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (KH <= 0 || H % KH != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (lse && dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = static_cast<float*>(lse);
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
  a.inv_cap = softcap > 0 ? static_cast<float>(1.0 / softcap) : 0.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch_dtype<64>(dtype, a, B, H, KH, s);
    case 128: return launch_dtype<128>(dtype, a, B, H, KH, s);
    case 256: return launch_dtype<256>(dtype, a, B, H, KH, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bfloat16 / float16 kernel's tile plan at head dim D for a sequence of
// S (window <= 0: none; the window applies under causal only, as the caller
// passes it to repro_flash_attention), computed on the host by the functions
// the kernel calls: sizes = {BQ, WQ, BK}; per BQ-row block i, its kv tiles
// [ranges[2i], ranges[2i + 1]); then, block by block and tile by tile,
// whether consumer warpgroup 0 and 1 mask it. ranges and masks may be null.
// Returns the number of mask entries, or -1 for a head dim the kernel does
// not take. flash_attention.py:kernel_tile_plan reads it.
extern "C" int repro_flash_tile_plan(int D, int S, int causal, int window, int* sizes,
                                     int* ranges, unsigned char* masks) {
  Args a = {};
  a.S = S;
  a.causal = causal;
  a.window = window;
  switch (D) {
    case 64: return tile_plan<64>(a, sizes, ranges, masks);
    case 128: return tile_plan<128>(a, sizes, ranges, masks);
    case 256: return tile_plan<256>(a, sizes, ranges, masks);
    default: return -1;
  }
}
