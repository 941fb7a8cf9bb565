// Decode-step attention for GIT's beam-search loop, written for Hopper
// (sm_90a).  Built with nvcc into a shared library with a plain C entry
// point and bound with ctypes (gitax_torch/ops/cuda_build.py); the
// Python wrapper, its launch plan and its plain PyTorch version live in
// gitax_torch/ops/decode_attention.py.
//
// Replaces the TPU kernel gitax/ops/decode_attention.py::_kernel.  It
// computes the same function, not a block-by-block copy:
//   * writes each beam's new k|v row into the time-major text cache
//     txt_kv [T, B*K, H*2Dh] at `pos`, in place.  `pos` is an int in
//     device memory that each CTA reads once, so a captured CUDA graph
//     replays the launch at every step of the search (the launch shape
//     does not depend on it); a `pos` outside [0, T) launches nothing
//     but sets the error flag `err`, which the host reads when it likes;
//   * scores the pre-scaled query q [B*K, H*Dh] against the memory keys
//     mem_kv [B, H, M, 2Dh] (shared by the K beams of a batch element;
//     bf16/f32, or int8 with per-(batch, head) k and v scales) plus an
//     optional additive bias [B, M];
//   * scores it against the text keys the ancestry table selects: slot t
//     of beam k reads cache row b*K + anc[b*K+k, t], for t <= pos;
//   * one f32 softmax over [memory ; text], probabilities rounded to the
//     activation type as round(e * (1 / sum)), both contexts summed in f32
//     and cast once (the TPU kernel's numerics, decode_attention.py:258-280).
// The TPU-only parts are gone: the zero-extended query, the 128-lane
// context, the 8-row cells and the liveness mask, the M%8 padding and
// the VMEM budget.
//
// Bound on the H100: bytes.  Per layer and step the memory K/V is read
// once per (batch element, head): B*H*M*2Dh elements, 25.3 MB in bf16 at
// B=32, M=257 (7.6 us at 3.35 TB/s) and 151.6 MB at the video's M=1542
// (45 us), against ~2*B*K*H*(M+T)*Dh*2 FLOPs (0.1-0.6 GFLOP).
//
// Design: one thread block cluster of C CTAs per (batch element, head),
// C <= 8 chosen by the wrapper from M: the smallest cluster whose CTAs
// fit three to an SM (C = 1 at M=257, 7 at M=1542: 384 and 2688 CTAs),
// since fewer, fuller CTAs carry more bytes per cluster barrier.  Each CTA owns a contiguous chunk of memory rows and
// brings its k|v rows into shared memory once, with bulk asynchronous
// copies (cp.async.bulk, 32 rows per mbarrier, all issued at the start),
// scoring each 32-row piece as it lands; the K beams are scored from the
// same shared rows, so the memory stream is read exactly once and not
// multiplied by the beam count.  The text slots are spread over the
// cluster (slot t to CTA t mod C), so that no CTA waits on more global
// loads than the others: with all text on one CTA, that CTA came last to
// every cluster barrier.  Rank 0 writes the K new cache rows at `pos`;
// slot pos is read from kv_new, the rows being written, so no CTA reads a
// cache row this launch writes (the race at `pos`: the ancestry at pos
// may point at another beam's row of the same group; no other cluster
// reads or writes this (b, h) slice).  Text is scored first, while the
// memory rows are in flight.  The softmax spans the cluster: each CTA's
// max per beam and its sum of exponentials under that max are exchanged
// through distributed shared memory (one cluster barrier) and combined in
// rank order into the cluster's max g and sum, so every CTA forms the
// probabilities round(exp(s - g) * (1 / sum)) of its own columns and its
// partial P.V, from the V rows already in shared memory (each warp a
// share of the rows, summed in warp order).  Each CTA writes its partial
// context into rank 0's shared memory; after a second cluster barrier
// rank 0 sums them in rank order and writes ctx, and the other CTAs may
// leave, since no CTA reads another's shared memory after that barrier.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kDh = 64;         // the head dim the kernel takes
constexpr int kMaxBeams = 8;    // beams per batch element
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kSub = 32;        // memory rows per bulk copy and mbarrier
constexpr int kLanes = 8;       // lanes per row: 8 elements of Dh each
static_assert(kLanes * 8 == kDh, "a lane takes 8 elements of a row");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

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

// 8 consecutive elements at p (16-byte aligned for bf16/f32, 8 for int8)
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x, x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const int8_t* p, float (&x)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = static_cast<float>(c[i]);
}

// Memory elements as the activation type sees them: int8 values are
// dequantized in the activation type (x.astype(dt) * scale.astype(dt)).
template <typename T, typename MT>
__device__ __forceinline__ void mem8(const MT* p, float scale_t, float (&x)[8]) {
  load8(p, x);
  if constexpr (std::is_same<MT, int8_t>::value) {
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = round_to<T>(x[i] * scale_t);
  }
}

template <typename T, typename MT>
__device__ __forceinline__ float mem_val(MT x, float scale_t) {
  if constexpr (std::is_same<MT, int8_t>::value) {
    return round_to<T>(static_cast<float>(x) * scale_t);
  } else {
    return to_f(x);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Wait for the completion of the barrier's phase of parity `parity`.  A
// wait that never ends (a lost copy) traps after ~2^26 polls, so a fault
// shows as a launch error rather than a hung card.
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

// Shared memory layout of one CTA; the wrapper's smem_bytes
// (ops/decode_attention.py) holds the same formula.
struct Layout {
  size_t kv, bars, q, sc, rows, red, gpart, total;
  __host__ __device__ Layout(int K, int chunk, int Tmax, int mem_bytes, int cluster) {
    const int nsub = (chunk + kSub - 1) / kSub;
    const int tslots = (Tmax + cluster - 1) / cluster;  // text slots per CTA, at most
    // [chunk, 2Dh] k|v rows; once read, the warps' f32 partial contexts
    // [warps, K, Dh]
    const size_t rows_bytes = ((size_t)chunk * 2 * kDh * mem_bytes + 15) / 16 * 16;
    const size_t part_bytes = 4 * (size_t)kWarps * K * kDh;
    kv = 0;
    bars = rows_bytes > part_bytes ? rows_bytes : part_bytes;  // nsub mbarriers
    q = bars + 8 * (size_t)nsub;                                // f32 [K, Dh] queries
    sc = q + 4 * (size_t)K * kDh;  // f32 [K, chunk + tslots] scores, then probabilities
    rows = sc + 4 * (size_t)K * (chunk + tslots);  // int [K, tslots] cache rows
    red = rows + 4 * (size_t)K * tslots;           // f32 [2, K] max, sum
    gpart = red + 4 * 2 * (size_t)K;               // f32 [C, K, Dh] the CTAs' contexts (rank 0)
    total = gpart + 4 * (size_t)cluster * K * kDh;
  }
};

// Two memory elements of a V row (dims d, d + 1) as the activation type
// sees them.
template <typename T, typename MT>
__device__ __forceinline__ float2 mem2(const MT* p, float scale_t) {
  if constexpr (std::is_same<MT, float>::value) {
    return *reinterpret_cast<const float2*>(p);
  } else if constexpr (std::is_same<MT, __nv_bfloat16>::value) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  } else {
    const char2 c = *reinterpret_cast<const char2*>(p);
    return make_float2(mem_val<T, MT>(c.x, scale_t), mem_val<T, MT>(c.y, scale_t));
  }
}

template <typename T, typename MT>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q,          // [BK, H*Dh]
                        const T* __restrict__ kv_new,     // [BK, H*2Dh]
                        T* txt_kv,                        // [T, BK, H*2Dh]
                        const int32_t* __restrict__ anc,  // [BK, T]
                        const MT* __restrict__ mem_kv,    // [B, H, M, 2Dh]
                        const float* __restrict__ mem_bias,   // [B, M] or null
                        const float* __restrict__ mem_scale,  // [B, H, 2] or null
                        T* __restrict__ ctx,              // [BK, H*Dh]
                        const int* __restrict__ pos_ptr,  // the text position
                        int* __restrict__ err,            // set to 1 on a bad pos
                        int K, int H, int M, int Tmax, int chunk) {
  // the step's position, read once; out of range, every CTA of every
  // cluster leaves before its first barrier and the launch writes nothing
  const int pos = *pos_ptr;
  if (pos < 0 || pos >= Tmax) {
    if (threadIdx.x == 0) atomicExch(err, 1);
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int BK = gridDim.z * K;
  const int lanes_kv = H * 2 * kDh;  // cache row width
  const int npos = pos + 1;          // live text slots
  // this CTA's text slots: rank, rank + C, ... <= pos
  const int ntext = rank < npos ? (npos - rank + C - 1) / C : 0;
  const int tslots = (Tmax + C - 1) / C;
  const int scw = chunk + tslots;    // score row width: memory chunk, then text
  const int m0 = min(M, rank * chunk);
  const int nrows = min(M, m0 + chunk) - m0;
  const int nsub = (nrows + kSub - 1) / kSub;

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(K, chunk, Tmax, sizeof(MT), C);
  MT* kvs = reinterpret_cast<MT*>(smem + L.kv);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  int* rows = reinterpret_cast<int*>(smem + L.rows);
  float* red_max = reinterpret_cast<float*>(smem + L.red);
  float* red_sum = red_max + K;
  float* wpart = reinterpret_cast<float*>(smem + L.kv);  // after the k|v rows are read
  float* gpart = reinterpret_cast<float*>(smem + L.gpart);

  const MT* mem_bh = mem_kv + ((size_t)(b * H + h) * M + m0) * 2 * kDh;
  float sk = 1.f, sv = 1.f;
  if constexpr (std::is_same<MT, int8_t>::value) {
    sk = round_to<T>(mem_scale[(b * H + h) * 2 + 0]);
    sv = round_to<T>(mem_scale[(b * H + h) * 2 + 1]);
  }

  // the chunk's k|v rows: one bulk copy per 32 rows, all in flight at once
  if (tid == 0) {
    for (int i = 0; i < nsub; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&bars[i])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < nsub; ++i) {
      const int r = i * kSub, n = min(kSub, nrows - r);
      const uint32_t bytes = (uint32_t)n * 2 * kDh * sizeof(MT);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                       smem_u32(&bars[i])),
                   "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
              "r"(smem_u32(kvs + (size_t)r * 2 * kDh)),
          "l"(mem_bh + (size_t)r * 2 * kDh), "r"(bytes), "r"(smem_u32(&bars[i]))
          : "memory");
    }
  }

  // the queries; this CTA's ancestry rows; rank 0 writes the group's new
  // rows into the cache at pos.  Slot pos is read from kv_new, the rows
  // being written, so no CTA waits for that write.
  for (int i = tid; i < K * kDh; i += kThreads) {
    const int k = i / kDh, d = i % kDh;
    qs[i] = to_f(q[(size_t)(b * K + k) * H * kDh + h * kDh + d]);
  }
  for (int i = tid; i < K * ntext; i += kThreads) {
    const int k = i / ntext, t = rank + (i % ntext) * C;
    rows[i] = b * K + anc[(size_t)(b * K + k) * Tmax + t];
  }
  if (rank == 0) {
    for (int i = tid; i < K * 2 * kDh; i += kThreads) {
      const int k = i / (2 * kDh), d = i % (2 * kDh);
      const size_t off = (size_t)(b * K + k) * lanes_kv + h * 2 * kDh + d;
      txt_kv[(size_t)pos * BK * lanes_kv + off] = kv_new[off];
    }
  }
  __syncthreads();  // also orders the barrier init before any wait
  // text slot rank + i * C of beam k: its k|v row for this head
  auto text_row = [&](int k, int i) -> const T* {
    const int t = rank + i * C;
    const int row = rows[k * ntext + i];
    const T* base = t == pos ? kv_new + (size_t)row * lanes_kv
                             : txt_kv + ((size_t)t * BK + row) * lanes_kv;
    return base + h * 2 * kDh;
  };

  // scores: 8 lanes per row, each over 8 elements of Dh.  Text first,
  // while the memory rows are in flight: one (beam, slot) per 8 lanes; the
  // V half of each row is fetched into L2 for P.V
  const int grp = lane / kLanes, j = lane % kLanes;
  for (int base = warp * (32 / kLanes); base < K * ntext; base += kThreads / kLanes) {
    const int i = base + grp;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const bool live = i < K * ntext;
    const int k = live ? i / ntext : 0, slot = live ? i % ntext : 0;
    if (live) {
      const T* row = text_row(k, slot) + 8 * j;
      load8(row, x);
      asm volatile("prefetch.global.L2 [%0];" ::"l"(row + kDh));
    }
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) s = fmaf(qs[k * kDh + 8 * j + e], x[e], s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    if (live && j == 0) sc[k * scw + chunk + slot] = s;
  }
  // memory: warp w takes the 32-row pieces w, w + 8, ... as they land, 4
  // rows and 4 beams at a time (lane j keeps its 8 query elements of those
  // beams in registers)
  for (int i = warp; i < nsub; i += kWarps) {
    mbar_wait(&bars[i], 0);
    const int r1 = min(nrows, (i + 1) * kSub);
    for (int k0 = 0; k0 < K; k0 += 4) {
      float qr[4][8];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 8; ++e) qr[kk][e] = k0 + kk < K ? qs[(k0 + kk) * kDh + 8 * j + e] : 0.f;
      for (int r = i * kSub + grp; r < (i + 1) * kSub; r += 32 / kLanes) {
        float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        const bool live = r < r1;  // every lane shuffles, live rows write
        if (live) mem8<T, MT>(kvs + (size_t)r * 2 * kDh + 8 * j, sk, x);
        const float bias = live && mem_bias ? mem_bias[(size_t)b * M + m0 + r] : 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (k0 + kk < K) {
            float s = 0.f;
#pragma unroll
            for (int e = 0; e < 8; ++e) s = fmaf(qr[kk][e], x[e], s);
            s += __shfl_xor_sync(0xffffffffu, s, 1);
            s += __shfl_xor_sync(0xffffffffu, s, 2);
            s += __shfl_xor_sync(0xffffffffu, s, 4);
            if (live && j == 0) sc[(k0 + kk) * scw + r] = s + bias;
          }
        }
      }
    }
  }
  __syncthreads();

  // the softmax across the cluster: each CTA's max per beam and its sum of
  // exp(s - that max), exchanged through distributed shared memory; the
  // cluster's max g and sum, combined in rank order, give every CTA the
  // probabilities round(exp(s - g) * (1 / sum)) of its own columns
  for (int k = warp; k < K; k += kWarps) {
    const float* row = sc + k * scw;
    float mx = __int_as_float(0xff800000);  // -inf
    for (int c = lane; c < nrows; c += 32) mx = fmaxf(mx, row[c]);
    for (int t = lane; t < ntext; t += 32) mx = fmaxf(mx, row[chunk + t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < nrows; c += 32) sum += expf(row[c] - mx);
    for (int t = lane; t < ntext; t += 32) sum += expf(row[chunk + t] - mx);
    sum = warp_sum(sum);
    if (lane == 0) red_max[k] = mx, red_sum[k] = sum;
  }
  cluster.sync();
  for (int k = warp; k < K; k += kWarps) {
    // lane r < C reads CTA r's max and sum
    const float mr = lane < C ? *cluster.map_shared_rank(&red_max[k], lane)
                              : __int_as_float(0xff800000);
    const float sr = lane < C ? *cluster.map_shared_rank(&red_sum[k], lane) : 0.f;
    const float g = warp_max(mr);
    const float part = sr > 0.f ? sr * expf(mr - g) : 0.f;  // an empty CTA adds 0
    float sum = 0.f;
    for (int r = 0; r < C; ++r) sum += __shfl_sync(0xffffffffu, part, r);
    const float inv = 1.f / sum;
    float* row = sc + k * scw;
    for (int c = lane; c < nrows; c += 32) row[c] = round_to<T>(expf(row[c] - g) * inv);
    for (int t = lane; t < ntext; t += 32) row[chunk + t] = round_to<T>(expf(row[chunk + t] - g) * inv);
  }
  __syncthreads();

  // P.V: warp w sums memory rows w, w + 8, ... from the V rows in shared
  // memory, then its text slots (each beam's own ancestry row); lane l
  // takes dims 2l and 2l + 1 of every beam
  float acc[kMaxBeams][2];
#pragma unroll
  for (int k = 0; k < kMaxBeams; ++k) acc[k][0] = acc[k][1] = 0.f;
  for (int r = warp; r < nrows; r += kWarps) {
    const float2 v = mem2<T, MT>(kvs + (size_t)r * 2 * kDh + kDh + 2 * lane, sv);
#pragma unroll
    for (int k = 0; k < kMaxBeams; ++k) {
      if (k < K) {
        const float pk = sc[k * scw + r];
        acc[k][0] = fmaf(pk, v.x, acc[k][0]);
        acc[k][1] = fmaf(pk, v.y, acc[k][1]);
      }
    }
  }
  for (int i = warp; i < ntext; i += kWarps) {
#pragma unroll
    for (int k = 0; k < kMaxBeams; ++k) {
      if (k < K) {
        const T* val = text_row(k, i) + kDh + 2 * lane;
        const float pk = sc[k * scw + chunk + i];
        acc[k][0] = fmaf(pk, to_f(val[0]), acc[k][0]);
        acc[k][1] = fmaf(pk, to_f(val[1]), acc[k][1]);
      }
    }
  }
  __syncthreads();  // every warp is done with the k|v rows: their space takes the sums
#pragma unroll
  for (int k = 0; k < kMaxBeams; ++k) {
    if (k < K) {
      float* w = wpart + ((size_t)warp * K + k) * kDh + 2 * lane;
      w[0] = acc[k][0], w[1] = acc[k][1];
    }
  }
  __syncthreads();
  // this CTA's context, the warps' sums in warp order, written into rank
  // 0's shared memory
  for (int o = tid; o < K * kDh; o += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += wpart[w * K * kDh + o];
    *cluster.map_shared_rank(&gpart[rank * K * kDh + o], 0) = sum;
  }
  // after this barrier only rank 0 reads shared memory, its own
  cluster.sync();

  // rank 0: the CTAs' contexts in rank order, cast once
  if (rank == 0) {
    for (int o = tid; o < K * kDh; o += kThreads) {
      const int k = o / kDh, d = o % kDh;
      float sum = 0.f;
      for (int r = 0; r < C; ++r) sum += gpart[r * K * kDh + o];
      ctx[(size_t)(b * K + k) * H * kDh + h * kDh + d] = from_f<T>(sum);
    }
  }
}

template <typename T, typename MT>
int launch(const void* q, const void* kv_new, void* txt_kv, const void* anc, const void* mem_kv,
           const void* mem_bias, const void* mem_scale, void* ctx, const int* pos, int* err,
           int B, int K, int H, int M, int Tmax, int cluster, int chunk, cudaStream_t stream) {
  auto kern = decode_attention_kernel<T, MT>;
  const size_t smem = Layout(K, chunk, Tmax, sizeof(MT), cluster).total;
  static size_t allowed = 48 * 1024;  // the instantiation's dynamic smem limit so far
  cudaError_t e = cudaSuccess;
  if (smem > allowed) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, H, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(q), static_cast<const T*>(kv_new),
                         static_cast<T*>(txt_kv), static_cast<const int32_t*>(anc),
                         static_cast<const MT*>(mem_kv), static_cast<const float*>(mem_bias),
                         static_cast<const float*>(mem_scale), static_cast<T*>(ctx), pos, err,
                         K, H, M, Tmax, chunk);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory (bytes) one CTA needs for `chunk` memory rows of
// `mem_bytes`-byte elements in a cluster of `cluster` CTAs.  The wrapper's smem_bytes
// (ops/decode_attention.py) holds the same formula and checks it against
// the card's limit before launching; chip_smoke.py checks the two agree.
size_t gitax_decode_attention_smem(int K, int Dh, int chunk, int Tmax, int mem_bytes,
                                   int cluster) {
  return Dh == kDh ? Layout(K, chunk, Tmax, mem_bytes, cluster).total : 0;
}

int gitax_decode_attention_head_dim() { return kDh; }

// act_bf16: activations (q, kv_new, txt_kv, ctx) are bf16, else f32.
// mem_int8: mem_kv is int8 with mem_scale [B, H, 2], else the activation
// type.  pos: one int in device memory, the text position, read by the
// kernel (0 <= pos < Tmax, else the kernel writes nothing and sets *err to
// 1; err: one int in device memory).  cluster, chunk: the wrapper's plan
// (CTAs per (b, h), memory rows per CTA).  Returns cudaGetLastError()
// after the launch (0 = launched).
int gitax_decode_attention(const void* q, const void* kv_new, void* txt_kv, const void* anc,
                           const void* mem_kv, const void* mem_bias, const void* mem_scale,
                           void* ctx, const void* pos, void* err, int B, int K, int H, int Dh,
                           int M, int Tmax, int act_bf16, int mem_int8, int cluster, int chunk,
                           void* stream) {
  if (Dh != kDh || K < 1 || K > kMaxBeams || pos == nullptr || err == nullptr || cluster < 1 ||
      cluster > kMaxCluster || chunk < 0 || (long long)cluster * chunk < M)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  int* e = static_cast<int*>(err);
  if (act_bf16) {
    if (mem_int8)
      return launch<__nv_bfloat16, int8_t>(q, kv_new, txt_kv, anc, mem_kv, mem_bias, mem_scale,
                                           ctx, p, e, B, K, H, M, Tmax, cluster, chunk, s);
    return launch<__nv_bfloat16, __nv_bfloat16>(q, kv_new, txt_kv, anc, mem_kv, mem_bias,
                                                mem_scale, ctx, p, e, B, K, H, M, Tmax, cluster,
                                                chunk, s);
  }
  if (mem_int8)
    return launch<float, int8_t>(q, kv_new, txt_kv, anc, mem_kv, mem_bias, mem_scale, ctx, p, e,
                                 B, K, H, M, Tmax, cluster, chunk, s);
  return launch<float, float>(q, kv_new, txt_kv, anc, mem_kv, mem_bias, mem_scale, ctx, p, e, B,
                              K, H, M, Tmax, cluster, chunk, s);
}

}  // extern "C"
