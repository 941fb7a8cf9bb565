// Decode-step attention for GIT's beam-search loop, written for Hopper
// (sm_90a).  Built with nvcc into a shared library with a plain C entry
// point and bound with ctypes (gitax_torch/ops/cuda_build.py); the
// Python wrapper and its plain PyTorch version live in
// gitax_torch/ops/decode_attention.py.
//
// Replaces the TPU kernel gitax/ops/decode_attention.py::_kernel.  It
// computes the same function, not a block-by-block copy:
//   * writes each beam's new k|v row into the time-major text cache
//     txt_kv [T, B*K, H*2Dh] at `pos`, in place;
//   * scores the pre-scaled query q [B*K, H*Dh] against the memory keys
//     mem_kv [B, H, M, 2Dh] (shared by the K beams of a batch element;
//     bf16/f32, or int8 with per-(batch, head) k and v scales) plus an
//     optional additive bias [B, M];
//   * scores it against the text keys the ancestry table selects: slot t
//     of beam k reads cache row b*K + anc[b*K+k, t], for t <= pos;
//   * one f32 softmax over [memory ; text], probabilities rounded to the
//     activation type, both contexts summed in f32 and cast once (the TPU
//     kernel's numerics, decode_attention.py:258-280).
// The TPU-only parts are gone: the zero-extended query, the 128-lane
// context, the 8-row cells and the liveness mask, the M%8 padding and
// the VMEM budget.
//
// Bound on the H100: bytes.  Per layer and step the memory K/V is read
// once per (batch element, head): B*H*M*2Dh elements, about 25 MB in
// bf16 at B=32, M=257 (8 us at 3.35 TB/s), against ~2*B*K*H*(M+T)*Dh*2
// FLOPs (~0.1 GFLOP).  The design reads each memory row once per block
// for all K beams of the group (one block per (b, h)), so the memory
// stream is not multiplied by the beam count, and keeps scores and
// probabilities in shared memory (~K*(M+T)*4 bytes), never in device
// memory.  Overlapping the loads with compute (cp.async/TMA rings) is
// later work.
//
// The race at `pos`: the ancestry at pos may point at another beam's
// row of the same group, so the block writes all K new rows of its
// (b, h) slice before any thread reads the cache (__syncthreads).  No
// other block touches that slice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxHeadDim = 256;
constexpr int kMaxLane = kMaxHeadDim / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// round a float to T's precision (an activation-dtype cast and back)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One memory element as the activation type sees it: int8 values are
// dequantized in the activation type (x.astype(dt) * scale.astype(dt)).
template <typename T, typename MT>
__device__ __forceinline__ float mem_val(MT x, float scale_t) {
  if constexpr (std::is_same<MT, int8_t>::value) {
    return round_to<T>(to_f(x) * scale_t);
  } else {
    return to_f(x);
  }
}

template <typename T, typename MT>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q,         // [BK, H*Dh]
                        const T* __restrict__ kv_new,    // [BK, H*2Dh]
                        T* txt_kv,                       // [T, BK, H*2Dh]
                        const int32_t* __restrict__ anc, // [BK, T]
                        const MT* __restrict__ mem_kv,   // [B, H, M, 2Dh]
                        const float* __restrict__ mem_bias,   // [B, M] or null
                        const float* __restrict__ mem_scale,  // [B, H, 2] or null
                        T* __restrict__ ctx,             // [BK, H*Dh]
                        int K, int H, int Dh, int M, int Tmax, int pos) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int BK = gridDim.y * K;
  const int lanes_kv = H * 2 * Dh;  // cache row width
  const int npos = pos + 1;         // live text slots
  const int S = M + npos;           // scores per beam

  extern __shared__ float smem[];
  float* qs = smem;                   // [K, Dh]
  float* sc = qs + K * Dh;            // [K, S] scores, then probabilities
  int* rows = reinterpret_cast<int*>(sc + K * S);  // [K, npos] cache rows

  float sk = 1.f, sv = 1.f;
  if constexpr (std::is_same<MT, int8_t>::value) {
    sk = round_to<T>(mem_scale[(b * H + h) * 2 + 0]);
    sv = round_to<T>(mem_scale[(b * H + h) * 2 + 1]);
  }

  // phase 1: queries to shared; the group's new rows into the cache;
  // the ancestry-selected rows of every live slot
  for (int i = tid; i < K * Dh; i += kThreads) {
    const int k = i / Dh, d = i % Dh;
    qs[i] = to_f(q[(size_t)(b * K + k) * H * Dh + h * Dh + d]);
  }
  for (int i = tid; i < K * 2 * Dh; i += kThreads) {
    const int k = i / (2 * Dh), d = i % (2 * Dh);
    const size_t off = (size_t)(b * K + k) * lanes_kv + h * 2 * Dh + d;
    txt_kv[(size_t)pos * BK * lanes_kv + off] = kv_new[off];
  }
  for (int i = tid; i < K * npos; i += kThreads) {
    const int k = i / npos, t = i % npos;
    rows[i] = b * K + anc[(size_t)(b * K + k) * Tmax + t];
  }
  __syncthreads();

  // phase 2a: memory scores, one warp per memory row; the row is loaded
  // once and scored against all K queries
  const MT* mem_bh = mem_kv + (size_t)(b * H + h) * M * 2 * Dh;
  for (int m = warp; m < M; m += kWarps) {
    float kval[kMaxLane];
#pragma unroll
    for (int i = 0; i < kMaxLane; ++i) {
      const int d = lane + 32 * i;
      kval[i] = d < Dh ? mem_val<T, MT>(mem_bh[(size_t)m * 2 * Dh + d], sk) : 0.f;
    }
    const float bias = mem_bias ? mem_bias[(size_t)b * M + m] : 0.f;
    for (int k = 0; k < K; ++k) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxLane; ++i) {
        const int d = lane + 32 * i;
        if (d < Dh) s += qs[k * Dh + d] * kval[i];
      }
      s = warp_sum(s);
      if (lane == 0) sc[k * S + m] = s + bias;
    }
  }

  // phase 2b: text scores, one warp per live (beam, slot)
  for (int i = warp; i < K * npos; i += kWarps) {
    const int k = i / npos, t = i % npos;
    const T* key = txt_kv + ((size_t)t * BK + rows[i]) * lanes_kv + h * 2 * Dh;
    float s = 0.f;
    for (int d = lane; d < Dh; d += 32) s += qs[k * Dh + d] * to_f(key[d]);
    s = warp_sum(s);
    if (lane == 0) sc[k * S + M + t] = s;
  }
  __syncthreads();

  // phase 3: f32 softmax over [memory ; text] per beam, probabilities
  // rounded to the activation type
  for (int k = warp; k < K; k += kWarps) {
    float* row = sc + k * S;
    float mx = __int_as_float(0xff800000);  // -inf
    for (int j = lane; j < S; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    const float inv = 1.f / warp_sum(sum);
    for (int j = lane; j < S; j += 32) row[j] = round_to<T>(row[j] * inv);
  }
  __syncthreads();

  // phase 4: both contexts in one f32 sum, one thread per (beam, lane)
  for (int o = tid; o < K * Dh; o += kThreads) {
    const int k = o / Dh, d = o % Dh;
    const float* p = sc + k * S;
    float acc = 0.f;
    const MT* vcol = mem_bh + Dh + d;
    for (int m = 0; m < M; ++m) acc += p[m] * mem_val<T, MT>(vcol[(size_t)m * 2 * Dh], sv);
    for (int t = 0; t < npos; ++t) {
      const T* val = txt_kv + ((size_t)t * BK + rows[k * npos + t]) * lanes_kv + h * 2 * Dh + Dh;
      acc += p[M + t] * to_f(val[d]);
    }
    ctx[(size_t)(b * K + k) * H * Dh + h * Dh + d] = from_f<T>(acc);
  }
}

template <typename T, typename MT>
int launch(const void* q, const void* kv_new, void* txt_kv, const void* anc,
           const void* mem_kv, const void* mem_bias, const void* mem_scale,
           void* ctx, int B, int K, int H, int Dh, int M, int Tmax, int pos,
           size_t smem, cudaStream_t stream) {
  auto kern = decode_attention_kernel<T, MT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(H, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv_new),
      static_cast<T*>(txt_kv), static_cast<const int32_t*>(anc),
      static_cast<const MT*>(mem_kv), static_cast<const float*>(mem_bias),
      static_cast<const float*>(mem_scale), static_cast<T*>(ctx), K, H, Dh, M,
      Tmax, pos);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory (bytes) one block needs.  The wrapper's smem_bytes
// (ops/decode_attention.py) holds the same formula and checks it against
// the card's limit before launching.
size_t gitax_decode_attention_smem(int K, int Dh, int M, int Tmax) {
  return sizeof(float) * ((size_t)K * Dh + (size_t)K * (M + Tmax)) +
         sizeof(int) * (size_t)K * Tmax;
}

int gitax_decode_attention_max_head_dim() { return kMaxHeadDim; }

// act_bf16: activations (q, kv_new, txt_kv, ctx) are bf16, else f32.
// mem_int8: mem_kv is int8 with mem_scale [B, H, 2], else the activation
// type.  Returns cudaGetLastError() after the launch (0 = launched).
int gitax_decode_attention(const void* q, const void* kv_new, void* txt_kv,
                           const void* anc, const void* mem_kv,
                           const void* mem_bias, const void* mem_scale,
                           void* ctx, int B, int K, int H, int Dh, int M,
                           int Tmax, int pos, int act_bf16, int mem_int8,
                           void* stream) {
  if (Dh > kMaxHeadDim || pos < 0 || pos >= Tmax) return (int)cudaErrorInvalidValue;
  const size_t smem = gitax_decode_attention_smem(K, Dh, M, Tmax);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act_bf16) {
    if (mem_int8)
      return launch<__nv_bfloat16, int8_t>(q, kv_new, txt_kv, anc, mem_kv, mem_bias,
                                           mem_scale, ctx, B, K, H, Dh, M, Tmax, pos, smem, s);
    return launch<__nv_bfloat16, __nv_bfloat16>(q, kv_new, txt_kv, anc, mem_kv, mem_bias,
                                                mem_scale, ctx, B, K, H, Dh, M, Tmax, pos, smem, s);
  }
  if (mem_int8)
    return launch<float, int8_t>(q, kv_new, txt_kv, anc, mem_kv, mem_bias, mem_scale,
                                 ctx, B, K, H, Dh, M, Tmax, pos, smem, s);
  return launch<float, float>(q, kv_new, txt_kv, anc, mem_kv, mem_bias, mem_scale,
                              ctx, B, K, H, Dh, M, Tmax, pos, smem, s);
}

}  // extern "C"
