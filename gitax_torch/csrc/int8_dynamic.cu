// w8a8: the per-token quantization and the epilogue of the encoder's
// dynamic int8 GEMMs, written for Hopper (sm_90a).  Built with nvcc into a
// shared library with a plain C interface and bound with ctypes
// (gitax_torch/ops/cuda_build.py); the Python wrappers and their plain
// PyTorch versions live in gitax_torch/ops/int8_dynamic.py, which also
// runs the int8 x int8 -> int32 product between the two (torch._int_mm).
//
// Replaces no Pallas kernel: gitax computes the same function in the XLA
// fusions of gitax/models/nn.py::_int8_dynamic_matmul (:53-71).
//   gitax_int8_quantize_rows_kernel (nn.py:61-65): for each row of x
//     [M, K] (f32 or bf16), amax = max|x| in f32 (or the amax the caller
//     gives, all-reduced over a tensor-parallel group), a_scale =
//     max(amax, 1e-12) / 127, q = clip(rint(x / a_scale), -127, 127) as
//     int8.  rint rounds halves to even, as torch.round and jnp.round do,
//     and the division is IEEE's (__fdiv_rn), so every code equals the
//     plain version's and gitax's.
//   gitax_int8_scale_rows_kernel (nn.py:69-70 and the bias of :44-50):
//     out = cast((float(y32) * a_scale[row]) * w_scale[col]) in that order
//     with round-to-nearest multiplies that are never contracted into an
//     FMA (__fmul_rn), then + bias in the activation type (added in f32
//     and rounded once, as torch adds two bf16 tensors).
//
// Bound on the H100: bytes; neither kernel has tensor-core work.  At the
// VQA encoder's M = 32 x 1201 = 38432 rows: quantizing c_proj's input
// (K = 4096, bf16) reads 315 MB and writes 157 MB, 0.141 ms at 3.35 TB/s;
// the epilogue of c_fc (N = 4096) reads 630 MB of int32 and writes 315 MB
// of bf16, 0.282 ms.  The int32 round trip through HBM is the cost of
// taking cuBLASLt's int8 GEMM as it is; a GEMM with the scales in its
// epilogue would not write it.
//
// Design: the quantization runs one CTA of 128 threads per row; each
// thread reads 16-byte vectors (8 bf16 or 2 x 4 f32), the row's max goes
// through warp shuffles and one shared-memory exchange, and the second
// pass over the row, which writes 8 codes a thread per vector, reads it
// again from L1/L2 (a row is at most 16 KB).  The epilogue gives each
// thread 8 consecutive columns of one row: two 16-byte loads of int32,
// the 8 column scales and biases, one 16-byte store of bf16 (two of f32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQuantThreads = 128;
constexpr int kScaleThreads = 256;

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  uint4 raw;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j] = __float2bfloat16_rn(v[j]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// v rounded to the activation type and back (the identity for f32)
__device__ __forceinline__ float to_act(float v, const float*) { return v; }
__device__ __forceinline__ float to_act(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
gitax_int8_quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                                float* __restrict__ a_scale, const float* __restrict__ amax_in,
                                int K) {
  const size_t row = blockIdx.x;
  const T* xr = x + row * K;
  int8_t* qr = q + row * K;
  const int vecs = K / 8;
  __shared__ float warp_max[kQuantThreads / 32];
  float amax;
  if (amax_in != nullptr) {
    amax = amax_in[row];
  } else {
    float m = 0.f;
    for (int i = threadIdx.x; i < vecs; i += kQuantThreads) {
      float v[8];
      load8(xr + 8 * i, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[j]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
    __syncthreads();
    m = warp_max[0];
#pragma unroll
    for (int w = 1; w < kQuantThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    amax = m;
  }
  const float s = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
  if (threadIdx.x == 0) a_scale[row] = s;
  for (int i = threadIdx.x; i < vecs; i += kQuantThreads) {
    float v[8];
    load8(xr + 8 * i, v);
    int8_t c[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float r = fminf(fmaxf(rintf(__fdiv_rn(v[j], s)), -127.f), 127.f);
      c[j] = static_cast<int8_t>(static_cast<int>(r));
    }
    const char4 lo = make_char4(c[0], c[1], c[2], c[3]);
    const char4 hi = make_char4(c[4], c[5], c[6], c[7]);
    int2 packed;
    packed.x = *reinterpret_cast<const int*>(&lo);
    packed.y = *reinterpret_cast<const int*>(&hi);
    *reinterpret_cast<int2*>(qr + 8 * i) = packed;
  }
}

template <typename T>
__global__ void __launch_bounds__(kScaleThreads)
gitax_int8_scale_rows_kernel(const int32_t* __restrict__ y, const float* __restrict__ a_scale,
                             const float* __restrict__ w_scale, const T* __restrict__ bias,
                             T* __restrict__ out, int M, int N) {
  const size_t groups = static_cast<size_t>(N / 8);
  const size_t idx = static_cast<size_t>(blockIdx.x) * kScaleThreads + threadIdx.x;
  if (idx >= static_cast<size_t>(M) * groups) return;
  const size_t row = idx / groups;
  const int c0 = static_cast<int>(idx % groups) * 8;
  const int4* yp = reinterpret_cast<const int4*>(y + row * N + c0);
  const int4 y0 = yp[0], y1 = yp[1];
  const int yi[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
  float ws[8];
  load8(w_scale + c0, ws);
  const float as = a_scale[row];
  float v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[j] = to_act(__fmul_rn(__fmul_rn(__int2float_rn(yi[j]), as), ws[j]), bias);
  }
  if (bias != nullptr) {
    float b[8];
    load8(bias + c0, b);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __fadd_rn(v[j], b[j]);
  }
  store8(out + row * N + c0, v);
}

}  // namespace

extern "C" {

// x [M, K] (bf16 when `bf16`, else f32), q [M, K] int8, a_scale [M] f32,
// amax [M] f32 or null; every pointer 16-byte aligned, K a multiple of 8.
int gitax_int8_quantize_rows(const void* x, void* q, void* a_scale, const void* amax, int M,
                             int K, int bf16, void* stream) {
  if (M <= 0 || K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    gitax_int8_quantize_rows_kernel<__nv_bfloat16><<<M, kQuantThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(a_scale), static_cast<const float*>(amax), K);
  } else {
    gitax_int8_quantize_rows_kernel<float><<<M, kQuantThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q), static_cast<float*>(a_scale),
        static_cast<const float*>(amax), K);
  }
  return static_cast<int>(cudaGetLastError());
}

// y [M, N] int32, a_scale [M] f32, w_scale [N] f32, bias [N] (the
// activation type) or null, out [M, N] (bf16 when `bf16`, else f32);
// every pointer 16-byte aligned, N a multiple of 8.
int gitax_int8_scale_rows(const void* y, const void* a_scale, const void* w_scale,
                          const void* bias, void* out, int M, int N, int bf16, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t work = static_cast<size_t>(M) * (N / 8);
  const unsigned blocks = static_cast<unsigned>((work + kScaleThreads - 1) / kScaleThreads);
  if (bf16) {
    gitax_int8_scale_rows_kernel<__nv_bfloat16><<<blocks, kScaleThreads, 0, s>>>(
        static_cast<const int32_t*>(y), static_cast<const float*>(a_scale),
        static_cast<const float*>(w_scale), static_cast<const __nv_bfloat16*>(bias),
        static_cast<__nv_bfloat16*>(out), M, N);
  } else {
    gitax_int8_scale_rows_kernel<float><<<blocks, kScaleThreads, 0, s>>>(
        static_cast<const int32_t*>(y), static_cast<const float*>(a_scale),
        static_cast<const float*>(w_scale), static_cast<const float*>(bias),
        static_cast<float*>(out), M, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
