// The int8 tied output head fused with the beam prefilter's statistics,
// written for Hopper (sm_90a).  Built with nvcc into a shared library with a
// plain C entry point and bound with ctypes (gitax_torch/ops/cuda_build.py);
// the Python wrapper and the plain PyTorch version live in
// gitax_torch/ops/vocab_topk.py.
//
// Replaces the TPU kernel gitax/ops/vocab_topk.py::_kernel (entry
// vocab_logits_topk).  It computes the same function, not a block-by-block
// copy:
//   * logits[r, c] = (sum_w h[r, w] * q8[w, c]) * scale[c] + bias[c], the sum
//     in f32, the scale and then the bias applied as two rounded operations
//     (the plain head's order), for c < V; columns V .. NB*512 - 1 are -inf;
//   * bmax[r, j] = the max over tile j of the very f32 values written to the
//     logits: each logit is computed once, kept in a register, written, and
//     reduced from that register, so the beam prefilter's exactness proof
//     (decode/beam.py::_top_k_blocked) holds bit for bit;
//   * bsum[r, j] = sum over the tile's valid columns of exp(logit - bmax), f32.
// bf16 activations: int8 -> bf16 is exact (|q| <= 127) and a bf16 x bf16
// product is exact in f32, so tensor-core products (WMMA, f32 accumulators)
// are the plain head's products, summed in another order.  f32 activations
// (the parity mode): f32 FMAs on the CUDA cores, no TF32.  The TPU-only
// parts are gone: R padded to 8 rows, the 128-lane statistics arrays and
// their read-modify-write across a sequential grid (in gitax that block is
// read before its first write).  Here each block writes its own statistics
// columns once.
//
// Design: one block of 8 warps per (512-column tile, group of 32 rows):
// 60 x 4 = 240 blocks at the beam step's R = B*K = 128, V = 30522, where the
// 60 tiles alone would fill fewer than half of the 132 SMs.  A block walks W
// in chunks of 32: the int8 chunk [32, 512] is read from device memory
// into registers, all of a chunk's loads issued together and one chunk
// ahead, so that they are in flight while the chunk before is multiplied;
// then it is widened to bf16 (or f32) into shared memory beside the hidden
// chunk [32 rows, 32] and multiplied into accumulators held in registers
// (bf16: each warp owns 32 rows x 64 columns as 2 x 4 WMMA 16x16x16
// fragments).  The matrix is vocab-major: the storage of a [V, W]
// row-major table seen as its transpose, each vocab column's W weights
// contiguous, the one layout the port's int8 Linear keeps
// (models/nn.py::Linear.set_int8).  Loads are 16 bytes along W, so W must
// be a multiple of 16 (768 and 1024 are).  The accumulators then go through shared memory to
// the epilogue, where each warp takes 4 rows and each lane 16 columns of a
// row (coalesced logit stores), and the row's max and sum of exponentials
// are reduced with warp shuffles.  The row groups of a tile re-read its
// 393 KB int8 slice; all 23.4 MB of the matrix fit in the 50 MB L2.
//
// Bound on the H100 at R = 128, W = 768, V = 30522 (NB = 60): 23.4 MB of
// int8 weights read and 15.7 MB of f32 logits written, ~39 MB, ~12 us at
// 3.35 TB/s; 6.0 GFLOP, below the bf16 ridge point (f32 parity mode: ~90 us
// at 67 TFLOP/s of f32 FMA).  As written it is latency-bound short of that:
// two block barriers per chunk, a register prefetch one chunk deep, WMMA
// rather than wgmma.  A
// TMA ring of int8 chunks feeding wgmma, with the epilogue of one tile
// overlapping the loads of the next, is the later faster design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kTile = 512;                  // columns per block: one prefilter block
constexpr int kRows = 32;                   // rows per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kK = 32;                      // W rows per chunk
constexpr int kVec = 16;                    // int8 bytes per load, along W
constexpr int kLdB = kK + 8;                // bf16 weight tile column stride (a legal WMMA stride)
constexpr int kLdH = kK + 8;                // bf16 hidden chunk row stride
constexpr int kLdC = kTile + 4;             // f32 accumulator row stride
constexpr int kWarpCols = kTile / kWarps;   // bf16: columns per warp
constexpr int kRowsPerWarp = kRows / kWarps;  // epilogue: rows per warp
constexpr int kColsPerLane = kTile / 32;      // epilogue: columns per lane
static_assert(kWarpCols == 64 && kRows == 32 && kK % 16 == 0, "the WMMA tiling assumes these");
static_assert(kThreads == kTile / 2, "the f32 product gives each thread two columns");

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

template <typename T>
__device__ __forceinline__ T from_float(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else {
    return __float2bfloat16_rn(x);
  }
}

// One chunk of the product's inputs, held in registers from its global
// loads until it is widened into shared memory: rows [k0, k0 + kK) and
// columns [c0, c0 + kTile) of the int8 matrix, and rows [r0, r0 + kRows),
// columns [k0, k0 + kK) of hidden [R, W]; outside the matrices the values
// are 0.  The matrix's element (k, c) lies at wq[c * W + k] (vocab-major).
// Loads are kVec bytes along W, which kVec divides, so a vector is wholly
// in or out.  `fetch` issues every load of the chunk before any is used,
// so they are in flight together (and, fetched one chunk ahead, during
// the chunk before's products).
template <typename T>
struct Chunk {
  static constexpr int kPerCol = kK / kVec;                   // vectors per column of a chunk
  static constexpr int kW = kK * kTile / kVec / kThreads;     // int8 vectors per thread
  static constexpr int kH = kRows * kK / kThreads;            // hidden values per thread
  static_assert((kK * kTile / kVec) % kThreads == 0 && (kRows * kK) % kThreads == 0,
                "whole chunks");
  uint4 w[kW];
  T h[kH];

  // the chunk's vector i: its first element's (k, c) within the chunk
  static __device__ __forceinline__ void coords(int i, int* k, int* c) {
    *k = (i % kPerCol) * kVec;
    *c = i / kPerCol;
  }

  __device__ __forceinline__ void fetch(const int8_t* __restrict__ wq, const T* __restrict__ hid,
                                        int R, int W, int V, int r0, int k0, int c0) {
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
      h[s] = (row < R && k < W) ? hid[(long long)row * W + k] : from_float<T>(0.f);
    }
  }

  // int8 -> T (exact) into the product's weight tile ws: bf16 as
  // [kTile, ldw] with k contiguous (a col-major WMMA operand), the 16
  // values packed into 32-bit words and stored 16 bytes at a time; f32 as
  // [kK, ldw] row-major, by transposing scalar stores.
  __device__ __forceinline__ void store(T* ws, int ldw, T* hs, int ldh) const {
#pragma unroll
    for (int s = 0; s < kW; ++s) {
      int kr, cr;
      coords(threadIdx.x + s * kThreads, &kr, &cr);
      union {
        uint4 v;
        int8_t b[kVec];
      } u;
      u.v = w[s];
      if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) ws[(kr + j) * ldw + cr] = from_float<T>((float)u.b[j]);
      } else {
        uint32_t wd[kVec / 2];
#pragma unroll
        for (int j = 0; j < kVec / 2; ++j)
          wd[j] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn((float)u.b[2 * j])) |
                  ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn((float)u.b[2 * j + 1])) << 16);
        uint4* d = reinterpret_cast<uint4*>(ws + cr * ldw + kr);
        d[0] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
        d[1] = make_uint4(wd[4], wd[5], wd[6], wd[7]);
      }
    }
#pragma unroll
    for (int s = 0; s < kH; ++s) {
      const int i = threadIdx.x + s * kThreads;
      hs[(i / kK) * ldh + i % kK] = h[s];
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
vocab_topk_kernel(const T* __restrict__ h, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  float* __restrict__ out, float* __restrict__ bmax,
                  float* __restrict__ bsum, int R, int W, int V, int nb) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  const int j = blockIdx.x;
  const int c0 = j * kTile;
  const int r0 = blockIdx.y * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // the chunk buffers during the product, then the accumulators: one region
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ws = reinterpret_cast<T*>(smem_raw);  // f32 [kK, ldw]; bf16 [kTile, ldw], k contiguous
  constexpr int ldw = kF32 ? kTile : kLdB;
  constexpr int ldh = kF32 ? kK : kLdH;
  T* hs = ws + (kF32 ? kK : kTile) * ldw;          // [kRows, ldh]
  float* cs = reinterpret_cast<float*>(smem_raw);  // [kRows, kLdC]
  Chunk<T> chunk;
  chunk.fetch(w, h, R, W, V, r0, 0, c0);

  if constexpr (kF32) {
    // thread t owns columns t and t + kThreads of all kRows rows
    float acc[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.f;
    for (int k0 = 0; k0 < W; k0 += kK) {
      __syncthreads();
      chunk.store(ws, ldw, hs, ldh);
      __syncthreads();
      if (k0 + kK < W) chunk.fetch(w, h, R, W, V, r0, k0 + kK, c0);
#pragma unroll 4
      for (int kk = 0; kk < kK; ++kk) {
        const float w0 = ws[kk * ldw + threadIdx.x], w1 = ws[kk * ldw + threadIdx.x + kThreads];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float hv = hs[r * ldh + kk];
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
  } else {
    // warp w owns rows 0..31 x columns [64w, 64w + 64): 2 x 4 fragments
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int rf = 0; rf < 2; ++rf)
#pragma unroll
      for (int cf = 0; cf < 4; ++cf) wmma::fill_fragment(acc[rf][cf], 0.f);
    const int wc = warp * kWarpCols;
    for (int k0 = 0; k0 < W; k0 += kK) {
      __syncthreads();
      chunk.store(ws, ldw, hs, ldh);
      __syncthreads();
      if (k0 + kK < W) chunk.fetch(w, h, R, W, V, r0, k0 + kK, c0);
#pragma unroll
      for (int kk = 0; kk < kK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
#pragma unroll
        for (int rf = 0; rf < 2; ++rf)
          wmma::load_matrix_sync(fa[rf], hs + rf * 16 * ldh + kk * 16, ldh);
#pragma unroll
        for (int cf = 0; cf < 4; ++cf) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, ws + (wc + cf * 16) * ldw + kk * 16, ldw);
#pragma unroll
          for (int rf = 0; rf < 2; ++rf) wmma::mma_sync(acc[rf][cf], fa[rf], fb, acc[rf][cf]);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int rf = 0; rf < 2; ++rf)
#pragma unroll
      for (int cf = 0; cf < 4; ++cf)
        wmma::store_matrix_sync(cs + rf * 16 * kLdC + wc + cf * 16, acc[rf][cf], kLdC,
                                wmma::mem_row_major);
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
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kColsPerLane; ++i)
      if (c0 + lane + 32 * i < V) s += expf(x[i] - m);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      bmax[(long long)row * nb + j] = m;
      bsum[(long long)row * nb + j] = s;
    }
  }
}

size_t smem_bytes(int act_bf16) {
  const size_t wtile = act_bf16 ? (size_t)kTile * kLdB : (size_t)kK * kTile;
  const size_t htile = act_bf16 ? (size_t)kRows * kLdH : (size_t)kRows * kK;
  const size_t gemm = (act_bf16 ? sizeof(__nv_bfloat16) : sizeof(float)) * (wtile + htile);
  const size_t accum = sizeof(float) * (size_t)kRows * kLdC;
  return gemm > accum ? gemm : accum;
}

template <typename T>
int launch(const void* h, const void* w, const float* scale, const float* bias, float* out,
           float* bmax, float* bsum, int R, int W, int V, cudaStream_t stream) {
  auto kern = vocab_topk_kernel<T>;
  const size_t smem = smem_bytes(sizeof(T) == 2);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int nb = (V + kTile - 1) / kTile;
  kern<<<dim3(nb, (R + kRows - 1) / kRows), kThreads, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const int8_t*>(w), scale, bias, out, bmax, bsum,
      R, W, V, nb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gitax_vocab_topk_tile() { return kTile; }

// Shared memory (bytes) one block needs: the larger of the product's chunk
// buffers and the f32 accumulator tile, which reuse one region.
size_t gitax_vocab_topk_smem(int act_bf16) { return smem_bytes(act_bf16); }

// h [R, W] (bf16 if act_bf16, else f32) and scale, bias [V] f32, contiguous;
// w the int8 [W, V] matrix, vocab-major (the storage of the transpose of a
// row-major [V, W]), 16-byte aligned, W a multiple of 16 -> out
// [R, NB*tile], bmax and bsum [R, NB] f32, NB = ceil(V / tile).  Returns
// cudaGetLastError() after the launch (0 = launched).
int gitax_vocab_topk(const void* h, const void* w, const void* scale, const void* bias,
                     void* out, void* bmax, void* bsum, int R, int W, int V, int tile,
                     int act_bf16, void* stream) {
  if (tile != kTile || R <= 0 || W <= 0 || V <= 0 || W % kVec != 0 ||
      reinterpret_cast<uintptr_t>(w) % kVec != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bz = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  float* mx = static_cast<float*>(bmax);
  float* sm = static_cast<float*>(bsum);
  if (act_bf16) return launch<__nv_bfloat16>(h, w, sc, bz, o, mx, sm, R, W, V, s);
  return launch<float>(h, w, sc, bz, o, mx, sm, R, W, V, s);
}

}  // extern "C"
