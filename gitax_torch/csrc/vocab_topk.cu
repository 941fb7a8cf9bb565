// The int8 tied output head fused with the beam prefilter's statistics,
// written for Hopper (sm_90a).  Built with nvcc into a shared library with a
// plain C entry point and bound with ctypes (gitax_torch/ops/cuda_build.py);
// the Python wrapper, the launch plan, the tensor-map parameters, the k
// permutation's table and the plain PyTorch version live in
// gitax_torch/ops/vocab_topk.py.
//
// Replaces the TPU kernel gitax/ops/vocab_topk.py::_kernel (entry
// vocab_logits_topk).  It computes the same function, not a block-by-block
// copy:
//   * logits[r, c] = (sum_w h[r, w] * q8[w, c]) * scale[c] + bias[c], the sum
//     in f32, the scale and then the bias applied as two rounded operations
//     (the plain head's order), for c < V; columns V .. NB*512 - 1 are -inf;
//   * bmax[r, j] = the max over block j (512 columns) of the very f32 values
//     written to the logits, so the beam prefilter's exactness proof
//     (decode/beam.py::_top_k_blocked) holds bit for bit;
//   * bsum[r, j] = sum over the block's valid columns of exp(logit - bmax).
// int8 -> bf16 is exact and a bf16 x bf16 product is exact in f32, so the
// tensor-core products are the plain head's products, summed in another
// order.  Each (row, block) statistic is written once, by one thread, with
// no atomics: the outputs are the same from run to run.  The TPU-only parts
// are gone: R padded to 8 rows, the 128-lane statistics arrays and their
// read-modify-write across a sequential grid.
//
// Bound on the H100 at the beam step's R = 128, W = 768, V = 30522 (NB =
// 60): 23.4 MB of int8 weights read and 15.7 MB of f32 logits written,
// ~39 MB, ~12 us at 3.35 TB/s; 6.0 GFLOP is 6 us of bf16 tensor-core time,
// so bytes bound it, but a design that leaves the tensor cores half idle
// would not reach the bound.
//
// bf16 design (the path's).  The matrix is vocab-major, a row-major [V, W]
// table (models/nn.py::Linear.set_int8), so the vocab columns go on wgmma's
// 64-row M side as the A operand and the R hidden rows on its N side as B:
//   * a cluster of 2 CTAs per 512-column block, each CTA 256 columns x up
//     to 128 hidden rows (a row group; R above 128 takes more groups):
//     2 x 60 = 120 CTAs on the 132 SMs in one wave, and each weight byte
//     crosses L2 once.
//   * a ring of 6 stages of 64 values of W, one full and one empty mbarrier
//     per stage and no block-wide barrier in the loop.  A producer warp
//     fills a stage with two TMA loads: the int8 tile [256 columns, 64] (a
//     2-D tensor map over the matrix as stored, 64-byte swizzle, rows past
//     V zero-filled: 96 KB of weight loads in flight per SM) and the hidden
//     chunk [128 rows, 64] bf16 (128-byte swizzle, rows past R zero-filled).
//   * two consumer warpgroups, 128 columns each as two m64 tiles.  A thread
//     reads its rows' raw int8 from shared memory in wgmma's A fragment
//     order (the bytes k = 2t, 2t+1 and 2t+8, 2t+9 of each group of 16: two
//     4-byte loads and one prmt; the 64-byte swizzle keeps a warp's 8
//     columns on different banks), widens them to bf16 in registers (the
//     byte placed in the mantissa of 2^23 by prmt, one f32 subtraction, the
//     high halves packed: exact, no cvt) and issues wgmma m64n128k16 with A
//     from registers and B, the hidden chunk, from shared memory (K-major).
//     The widened weights never touch shared memory, and no operand is
//     permuted.  A tile's product is issued as soon as its rows are
//     widened; the k-step ends with a wait for both, and the other
//     warpgroup fills the tensor cores meanwhile.  (The 128 accumulators
//     leave no room for more in flight: warps are allocated four at a time,
//     so nine warps leave a thread 168 registers, at which ptxas serialises
//     any deeper wgmma pipeline or spills.)
//   * the epilogue applies scale, bias and the -inf columns on the
//     accumulator registers, stages the tile through the ring's shared
//     memory (the accumulators are vocab-major, the logits row-major),
//     writes 16 bytes per lane, 512 contiguous bytes per warp, and takes
//     each row's max and sum of exponentials from the staged values, four
//     rows of a warp in flight.  Rank 1 pushes its rows' (max, sum) into
//     rank 0's shared memory; after one cluster barrier rank 0 merges them
//     as m = max(m0, m1), s = s0 exp(m0 - m) + s1 exp(m1 - m).
// Where its time goes (H100, the shape above; tools/vocab_topk_timeline.py
// stamps a copy of the kernel per CTA): ~2.6 us until the first stage has
// landed; ~11 us of main loop, ~0.9 us a stage against 0.56 us of
// tensor-core time and 0.6 us of HBM time (the products alone take 8.8 us,
// the loads and conversions alone 7.5 us; shared memory serves wgmma's B
// reads, the A loads and TMA's writes); ~1.5 us of staging; ~5.1 us of row
// stores, the 15.7 MB of logits at ~3.1 TB/s, which nothing overlaps in a
// single wave; ~0.8 us for the cluster barrier.
//
// f32 (the parity path): the first design, unchanged.  One block of 8 warps
// per (512-column tile, 32 rows); W in chunks of 32, the int8 chunk
// prefetched into registers one chunk ahead, widened into shared memory and
// multiplied by plain f32 FMAs (no TF32); bound ~90 us at 67 TFLOP/s.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kTile = 512;  // columns per statistics block: one prefilter block
constexpr int kVec = 16;    // W must be a multiple of this many int8 bytes

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// f32: plain FMAs on the CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kRows = 32;  // rows per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kK = 32;                        // W rows per chunk
constexpr int kLdC = kTile + 4;               // f32 accumulator row stride
constexpr int kRowsPerWarp = kRows / kWarps;  // epilogue: rows per warp
constexpr int kColsPerLane = kTile / 32;      // epilogue: columns per lane
static_assert(kThreads == kTile / 2, "the product gives each thread two columns");

// One chunk of the product's inputs, held in registers from its global
// loads until it is widened into shared memory: rows [k0, k0 + kK) and
// columns [c0, c0 + kTile) of the int8 matrix, and rows [r0, r0 + kRows),
// columns [k0, k0 + kK) of hidden [R, W]; outside the matrices the values
// are 0.  The matrix's element (k, c) lies at wq[c * W + k] (vocab-major).
// Loads are kVec bytes along W, which kVec divides, so a vector is wholly
// in or out.  `fetch` issues every load of the chunk before any is used,
// so they are in flight together (and, fetched one chunk ahead, during
// the chunk before's products).
struct Chunk {
  static constexpr int kPerCol = kK / kVec;                // vectors per column of a chunk
  static constexpr int kW = kK * kTile / kVec / kThreads;  // int8 vectors per thread
  static constexpr int kH = kRows * kK / kThreads;         // hidden values per thread
  static_assert((kK * kTile / kVec) % kThreads == 0 && (kRows * kK) % kThreads == 0,
                "whole chunks");
  uint4 w[kW];
  float h[kH];

  // the chunk's vector i: its first element's (k, c) within the chunk
  static __device__ __forceinline__ void coords(int i, int* k, int* c) {
    *k = (i % kPerCol) * kVec;
    *c = i / kPerCol;
  }

  __device__ __forceinline__ void fetch(const int8_t* __restrict__ wq,
                                        const float* __restrict__ hid, int R, int W, int V,
                                        int r0, int k0, int c0) {
#pragma unroll
    for (int s = 0; s < kW; ++s) {
      int kr, cr;
      coords(threadIdx.x + s * kThreads, &kr, &cr);
      const int k = k0 + kr, c = c0 + cr;
      w[s] = uint4{};
      if (k < W && c < V) w[s] = *reinterpret_cast<const uint4*>(wq + (long long)c * W + k);
    }
#pragma unroll
    for (int s = 0; s < kH; ++s) {
      const int i = threadIdx.x + s * kThreads;
      const int row = r0 + i / kK, k = k0 + i % kK;
      h[s] = (row < R && k < W) ? hid[(long long)row * W + k] : 0.f;
    }
  }

  // int8 -> f32 (exact) into the product's weight tile ws [kK, kTile]
  // row-major, by transposing scalar stores; the hidden chunk into hs
  // [kRows, kK].
  __device__ __forceinline__ void store(float* ws, float* hs) const {
#pragma unroll
    for (int s = 0; s < kW; ++s) {
      int kr, cr;
      coords(threadIdx.x + s * kThreads, &kr, &cr);
      union {
        uint4 v;
        int8_t b[kVec];
      } u;
      u.v = w[s];
#pragma unroll
      for (int j = 0; j < kVec; ++j) ws[(kr + j) * kTile + cr] = (float)u.b[j];
    }
#pragma unroll
    for (int s = 0; s < kH; ++s) {
      const int i = threadIdx.x + s * kThreads;
      hs[i] = h[s];
    }
  }
};

// the chunk buffers during the product, then the accumulators: one region
constexpr size_t kSmemGemm = sizeof(float) * ((size_t)kK * kTile + (size_t)kRows * kK);
constexpr size_t kSmemAcc = sizeof(float) * (size_t)kRows * kLdC;
constexpr size_t kSmem = kSmemGemm > kSmemAcc ? kSmemGemm : kSmemAcc;

__global__ void __launch_bounds__(kThreads)
vocab_topk_f32_kernel(const float* __restrict__ h, const int8_t* __restrict__ w,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      float* __restrict__ out, float* __restrict__ bmax,
                      float* __restrict__ bsum, int R, int W, int V, int nb) {
  const int j = blockIdx.x;
  const int c0 = j * kTile;
  const int r0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ws = reinterpret_cast<float*>(smem_raw);  // [kK, kTile]
  float* hs = ws + kK * kTile;                     // [kRows, kK]
  float* cs = reinterpret_cast<float*>(smem_raw);  // [kRows, kLdC]
  Chunk chunk;
  chunk.fetch(w, h, R, W, V, r0, 0, c0);

  // thread t owns columns t and t + kThreads of all kRows rows
  float acc[kRows][2];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.f;
  for (int k0 = 0; k0 < W; k0 += kK) {
    __syncthreads();
    chunk.store(ws, hs);
    __syncthreads();
    if (k0 + kK < W) chunk.fetch(w, h, R, W, V, r0, k0 + kK, c0);
#pragma unroll 4
    for (int kk = 0; kk < kK; ++kk) {
      const float w0 = ws[kk * kTile + threadIdx.x], w1 = ws[kk * kTile + threadIdx.x + kThreads];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float hv = hs[r * kK + kk];
        acc[r][0] = fmaf(hv, w0, acc[r][0]);
        acc[r][1] = fmaf(hv, w1, acc[r][1]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    cs[r * kLdC + threadIdx.x] = acc[r][0];
    cs[r * kLdC + threadIdx.x + kThreads] = acc[r][1];
  }
  __syncthreads();

  // epilogue: scale and bias once per logit, the -inf columns, the store,
  // and the tile's max and sum of exponentials from the same registers
  float sc[kColsPerLane], bz[kColsPerLane];
#pragma unroll
  for (int i = 0; i < kColsPerLane; ++i) {
    const int col = c0 + lane + 32 * i;
    sc[i] = col < V ? scale[col] : 0.f;
    bz[i] = col < V ? bias[col] : 0.f;
  }
  const long long ldo = (long long)nb * kTile;
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    const int row = r0 + r;
    if (row >= R) break;  // warp-uniform
    float x[kColsPerLane];
    float m = neg_inf();
#pragma unroll
    for (int i = 0; i < kColsPerLane; ++i) {
      const int c = lane + 32 * i;
      x[i] = c0 + c < V ? __fadd_rn(__fmul_rn(cs[r * kLdC + c], sc[i]), bz[i]) : neg_inf();
      out[row * ldo + c0 + c] = x[i];
      m = fmaxf(m, x[i]);
    }
    m = warp_max(m);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kColsPerLane; ++i)
      if (c0 + lane + 32 * i < V) s += expf(x[i] - m);
    s = warp_sum(s);
    if (lane == 0) {
      bmax[(long long)row * nb + j] = m;
      bsum[(long long)row * nb + j] = s;
    }
  }
}

int launch(const void* h, const void* w, const float* scale, const float* bias, float* out,
           float* bmax, float* bsum, int R, int W, int V, cudaStream_t stream) {
  static bool sized = false;
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(vocab_topk_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int nb = (V + kTile - 1) / kTile;
  vocab_topk_f32_kernel<<<dim3(nb, (R + kRows - 1) / kRows), kThreads, kSmem, stream>>>(
      static_cast<const float*>(h), static_cast<const int8_t*>(w), scale, bias, out, bmax, bsum,
      R, W, V, nb);
  return (int)cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: TMA ring, wgmma with the int8 weights widened in registers
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kN = 128;                     // hidden rows per CTA: wgmma's N
constexpr int kCols = 256;                  // vocab columns per CTA
constexpr int kCluster = kTile / kCols;     // CTAs per statistics block
constexpr int kConsumers = 2;               // warpgroups, kCols / 2 columns each
constexpr int kMT = kCols / kConsumers / 64;  // m64 tiles per warpgroup
constexpr int kKC = 64;                     // values of W per stage
constexpr int kStages = 6;
constexpr int kThreads = kConsumers * 128 + 32;  // + one producer warp
constexpr int kProducerWarp = kConsumers * 4;
constexpr uint32_t kWBytes = kCols * kKC;             // a stage's int8 tile, 16 KB
constexpr uint32_t kHBytes = kN * kKC * sizeof(bf16);  // a stage's hidden chunk, 16 KB
constexpr size_t kRing = (size_t)kStages * (kWBytes + kHBytes);
constexpr int kPitch = kCols + 4;           // staged logits row pitch (floats): no bank conflicts
constexpr size_t kStaged = sizeof(float) * (size_t)kN * kPitch;
constexpr int kRowsAtOnce = 4;              // epilogue: rows a warp reduces together
// the 1 KB of slack aligns the ring by hand (swizzle atoms are 1024 bytes);
// then each row's (max, sum), this CTA's and the other's, and the barriers
constexpr size_t kSmem = 1024 + kRing + 4 * kN * sizeof(float) + 8 * 2 * kStages;
static_assert(kCluster == 2 && kMT == 2, "the cluster exchange and the tiles assume these");
static_assert(kStaged <= kRing, "the staged logits reuse the ring");
static_assert(kKC == 64, "one 64-byte swizzle row per column, one 128-byte row per hidden row");
static_assert(kN % (kConsumers * 4 * kRowsAtOnce) == 0, "whole groups of rows per warp");
static_assert(kSmem <= 232448, "shared memory per block on sm_90");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.  A
// wait that never ends (a lost load, a wrong phase) traps after ~2^26
// polls, so a fault shows as a launch error rather than a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One box of a 2-D tensor map (W, rows) into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int k,
                                         int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(k), "r"(row)
      : "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers * 128) : "memory");
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// A wgmma shared-memory descriptor for a K-major tile in the 128-byte
// swizzle: start address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Pin the accumulator registers behind the asm statements around them, so
// that no read of them moves above a wgmma.wait_group.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) : : "memory");
}

#define GITAX_D8(d, i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 128] += A[64 x 16] (bf16 pairs in registers) . B[16 x 128], B
// K-major in shared memory.  Thread (warp w, lane l) of the warpgroup holds
// d[4j + 2i + e] = D[16w + l/4 + 8i][8j + 2(l%4) + e].
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 0;"
      : GITAX_D8(d, 0), GITAX_D8(d, 8), GITAX_D8(d, 16), GITAX_D8(d, 24), GITAX_D8(d, 32),
        GITAX_D8(d, 40), GITAX_D8(d, 48), GITAX_D8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// Four int8 values (a 32-bit word, lowest byte first) -> bf16 pairs
// (q0, q1) and (q2, q3), exactly: the byte, made unsigned by flipping its
// sign bit, goes into the low mantissa of 2^23 (prmt); subtracting
// 2^23 + 128 leaves the signed value as an f32 integer, whose high half is
// its bf16.
__device__ __forceinline__ void widen4(uint32_t x, uint32_t* lo, uint32_t* hi) {
  const uint32_t u = x ^ 0x80808080u;
  const float off = 8388736.f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - off;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - off;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - off;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - off;
  *lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  *hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

__global__ void __launch_bounds__(kThreads, 1)
vocab_topk_bf16_kernel(const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ CUtensorMap hmap,
                       const float* __restrict__ scale, const float* __restrict__ bias,
                       float* __restrict__ out, float* __restrict__ bmax,
                       float* __restrict__ bsum, int R, int W, int V, int nb) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* wring = base;                       // [kStages][kCols, kKC] int8, 64-byte swizzle
  unsigned char* hring = base + kStages * kWBytes;   // [kStages][kN, kKC] bf16, 128-byte swizzle
  float* staged = reinterpret_cast<float*>(base);    // [kN, kPitch], after the product
  float* part = reinterpret_cast<float*>(base + kRing);  // [2][kN]: each row's max, sum
  float* peer = part + 2 * kN;                       // the other CTA's, pushed into rank 0
  uint64_t* full = reinterpret_cast<uint64_t*>(peer + 2 * kN);
  uint64_t* empty = full + kStages;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int j = blockIdx.x / kCluster;  // the statistics block
  const int c0 = blockIdx.x * kCols;    // this CTA's first vocab column
  const int r0 = blockIdx.y * kN;       // this row group's first hidden row
  const int warp_id = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nk = (W + kKC - 1) / kKC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);                // the producer's expect_tx
      mbar_init(&empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp_id == kProducerWarp) {
    // producer: per stage one box of int8 weights [kCols columns, kKC] and
    // one of hidden [kN rows, kKC]; TMA zero-fills past V, R and W
    if (lane == 0) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kWBytes + kHBytes);
        tma_load(wring + s * kWBytes, &wmap, &full[s], it * kKC, c0);
        tma_load(hring + s * kHBytes, &hmap, &full[s], it * kKC, r0);
      }
    }
    __syncwarp();
  } else {
    const int wg = warp_id / 4, warp = warp_id % 4;
    const int g = lane / 4, t = lane % 4;
    // this thread's vocab columns within the CTA: tile mt, rows g and g + 8
    const int col0 = wg * (kCols / kConsumers) + warp * 16 + g;
    float sc[kMT][2], bz[kMT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = c0 + col0 + 64 * mt + 8 * i;
        sc[mt][i] = col < V ? scale[col] : 0.f;
        bz[mt][i] = col < V ? bias[col] : 0.f;
      }
    }
    float acc[kMT][64];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[mt][i] = 0.f;
    }
    // wgmma's A fragment of k-step s wants, for rows g and g + 8, the bytes
    // k = 16s + {2t, 2t+1} and 16s + 8 + {2t, 2t+1}: the word holding the
    // first pair, the word 8 bytes on, and one prmt that keeps the thread's
    // half of each.  A column's 64 bytes lie in the 64-byte swizzle: its
    // 16-byte piece s sits at piece s ^ ((column / 2) % 4), which spreads a
    // warp's 8 columns over the banks.
    const uint32_t wbase = smem_u32(wring) + (uint32_t)col0 * kKC + 4 * (t >> 1);
    const uint32_t swz = (g >> 1) & 3;
    const uint32_t pick = (t & 1) ? 0x7632 : 0x5410;
    const uint32_t hbase = smem_u32(hring);
    for (int it = 0; it < nk; ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const uint32_t ws = wbase + s * kWBytes;
#pragma unroll
      for (int ks = 0; ks < kKC / 16; ++ks) {
        const uint32_t piece = ws + ((ks ^ swz) << 4);
        uint32_t x[kMT][2], a[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const uint32_t at = piece + (64 * mt + 8 * i) * kKC;
            x[mt][i] = __byte_perm(lds32(at), lds32(at + 8), pick);
          }
        }
        const uint64_t db = desc_sw128(hbase + s * kHBytes + 32 * ks, 16, 1024);
        // a tile's product is issued as soon as its rows are widened, so the
        // second tile's conversion runs under the first one's product; the
        // other warpgroup's work fills the wait
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
            widen4(x[mt][i], &a[mt][i], &a[mt][2 + i]);  // k 2t.., then k 2t+8..
          wgmma_fence();
          wgmma_rs(acc[mt], a[mt], db);
          wgmma_commit();
        }
        wgmma_wait0();
      }
      if (lane == 0) mbar_arrive(&empty[s]);  // the stage is read no more
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) fence_regs(acc[mt]);

    // epilogue.  Every load has landed and every product is done once both
    // warpgroups are here, so the ring's memory takes the logits: scale and
    // bias once per logit and the -inf columns on the registers, then
    // staged[row][column] (the pitch spreads a warp's 32 stores over the
    // banks)
    consumer_sync();
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = col0 + 64 * mt + 8 * i;
        const bool valid = c0 + col < V;
#pragma unroll
        for (int jn = 0; jn < kN / 8; ++jn) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = __fadd_rn(__fmul_rn(acc[mt][4 * jn + 2 * i + e], sc[mt][i]), bz[mt][i]);
            staged[(8 * jn + 2 * t + e) * kPitch + col] = valid ? x : neg_inf();
          }
        }
      }
    }
    consumer_sync();
    // a warp per row, kRowsAtOnce rows in flight: 16 bytes per lane and 512
    // per warp to the logits, and the row's max and sum of exponentials over
    // this CTA's columns, kept here (rank 0) or pushed into rank 0
    const long long ldo = (long long)nb * kTile;
    float* mine = rank == 0 ? part : cluster.map_shared_rank(peer, 0);
    for (int rb = warp_id; rb < kN; rb += kConsumers * 4 * kRowsAtOnce) {
      float x[kRowsAtOnce][8], m[kRowsAtOnce], sum[kRowsAtOnce];
#pragma unroll
      for (int u = 0; u < kRowsAtOnce; ++u) {
        const int r = rb + u * kConsumers * 4;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(staged + r * kPitch + 128 * i + 4 * lane);
          if (r0 + r < R)
            *reinterpret_cast<float4*>(out + (r0 + r) * ldo + c0 + 128 * i + 4 * lane) = v;
          x[u][4 * i] = v.x, x[u][4 * i + 1] = v.y, x[u][4 * i + 2] = v.z, x[u][4 * i + 3] = v.w;
        }
        m[u] = x[u][0];
#pragma unroll
        for (int i = 1; i < 8; ++i) m[u] = fmaxf(m[u], x[u][i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < kRowsAtOnce; ++u)
          m[u] = fmaxf(m[u], __shfl_xor_sync(0xffffffffu, m[u], off));
      }
#pragma unroll
      for (int u = 0; u < kRowsAtOnce; ++u) {
        sum[u] = 0.f;
        if (m[u] != neg_inf()) {  // else no valid column here: exp(-inf - -inf) is no number
#pragma unroll
          for (int i = 0; i < 8; ++i) sum[u] += expf(x[u][i] - m[u]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int u = 0; u < kRowsAtOnce; ++u) sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < kRowsAtOnce; ++u) {
          const int r = rb + u * kConsumers * 4;
          mine[r] = m[u], mine[kN + r] = sum[u];
        }
      }
    }
  }

  // the block's statistics: after the barrier rank 0 holds both CTAs' (max,
  // sum) and writes each row's pair once.  Every block has a valid column,
  // so the merged max is finite.
  cluster.sync();
  if (rank == 0 && threadIdx.x < kN && r0 + threadIdx.x < R) {
    const float m0 = part[threadIdx.x], s0 = part[kN + threadIdx.x];
    const float m1 = peer[threadIdx.x], s1 = peer[kN + threadIdx.x];
    const float m = fmaxf(m0, m1);
    const float s = (m0 == neg_inf() ? 0.f : s0 * expf(m0 - m)) +
                    (m1 == neg_inf() ? 0.f : s1 * expf(m1 - m));
    const long long o = (long long)(r0 + threadIdx.x) * nb + j;
    bmax[o] = m;
    bsum[o] = s;
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, reached through the runtime (no
// -lcuda); null when the driver does not offer it.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// One 2-D map from the wrapper's parameters (ops/vocab_topk.py weight_map,
// hidden_map): dims (W, rows) in elements, the byte stride of a row, the box
// (W elements, rows); zeros outside.  The int8 matrix in the 64-byte
// swizzle, hidden in the 128-byte one.  Returns 0 or an error.
int encode(CUtensorMap* map, const void* ptr, const long long* p, bool weights) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)p[0], (cuuint64_t)p[1]};
  const cuuint64_t strides[1] = {(cuuint64_t)p[2]};
  const cuuint32_t box[2] = {(cuuint32_t)p[3], (cuuint32_t)p[4]};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(
      map, weights ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
      const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      weights ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

int launch(const void* h, const void* w, const float* scale, const float* bias, float* out,
           float* bmax, float* bsum, int R, int W, int V, const long long* maps,
           cudaStream_t stream) {
  if (maps == nullptr || maps[0] != W || maps[1] != V || maps[3] != kKC || maps[4] != kCols ||
      maps[5] != W || maps[6] != R || maps[8] != kKC || maps[9] != kN)
    return (int)cudaErrorInvalidValue;
  CUtensorMap wm, hm;
  int rc = encode(&wm, w, maps, true);
  if (rc == 0) rc = encode(&hm, h, maps + 5, false);
  if (rc != 0) return rc;
  static bool sized = false;
  cudaError_t e = cudaSuccess;
  if (!sized) {
    e = cudaFuncSetAttribute(vocab_topk_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int nb = (V + kTile - 1) / kTile;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * nb, (R + kN - 1) / kN);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, vocab_topk_bf16_kernel, wm, hm, scale, bias, out, bmax, bsum, R, W,
                         V, nb);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

int gitax_vocab_topk_tile() { return kTile; }

// Shared memory (bytes) one block needs.  bf16: the alignment slack, the
// ring (which the staged logits reuse), the rows' (max, sum) of both CTAs
// and the barriers; f32: the larger of the product's chunk buffers and the
// accumulator tile, which reuse one region.  The wrapper's tile_plan
// (ops/vocab_topk.py) holds the bf16 formula; chip_smoke.py checks it.
size_t gitax_vocab_topk_smem(int act_bf16) { return act_bf16 ? tc::kSmem : f32::kSmem; }

// h [R, W] (bf16 if act_bf16, else f32) and scale, bias [V] f32, contiguous;
// w the int8 [W, V] matrix, vocab-major (the storage of the transpose of a
// row-major [V, W]), 16-byte aligned, W a multiple of 16 -> out
// [R, NB*tile], bmax and bsum [R, NB] f32, NB = ceil(V / tile).  bf16 also
// takes `maps`, the tensor-map parameters of w and of h (5 values each, see
// tc::encode).
// Returns cudaGetLastError() after the launch (0 = launched), or the
// tensor-map encoder's error as 10000 + CUresult.
int gitax_vocab_topk(const void* h, const void* w, const void* scale, const void* bias,
                     void* out, void* bmax, void* bsum, int R, int W, int V, int tile,
                     int act_bf16, const long long* maps, void* stream) {
  if (tile != kTile || R <= 0 || W <= 0 || V <= 0 || W % kVec != 0 ||
      reinterpret_cast<uintptr_t>(w) % kVec != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bz = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  float* mx = static_cast<float*>(bmax);
  float* sm = static_cast<float*>(bsum);
  if (act_bf16) return tc::launch(h, w, sc, bz, o, mx, sm, R, W, V, maps, s);
  return f32::launch(h, w, sc, bz, o, mx, sm, R, W, V, s);
}

}  // extern "C"
