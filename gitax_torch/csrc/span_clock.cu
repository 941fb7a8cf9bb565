// The device side of the port's spans (gitax_torch/runtime/profiling.py),
// for Hopper (sm_90a): a one-thread kernel that writes the GPU's global
// timer (%globaltimer, nanoseconds), given one the value of an int64
// counter in device memory, and last the stamp's sequence number into a
// slot of page-locked host memory.  A device span launches one at its
// start and one at its end on the current stream; the host reads a slot
// once its sequence number is the stamp's, with no CUDA event, no
// elapsed-time call and no wait.  Built with nvcc into a shared library
// with plain C entry points and bound with ctypes.  Host memory from
// cudaHostAlloc is addressed by the same pointer on the card under
// unified addressing, so the kernel writes the slot directly.
//
// No Pallas counterpart: gitax's spans are host-side (jax.profiler).

#include <cuda_runtime.h>

#include <cstring>

namespace {

// A slot: the timer, the counter's value, the sequence number, unused.
constexpr unsigned long long kWords = 4;

unsigned long long* g_slots = nullptr;
unsigned long long g_count = 0;

__global__ void span_stamp(unsigned long long* slot, const long long* counter,
                           unsigned long long seq) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  if (counter != nullptr) slot[1] = (unsigned long long)(*counter);
  slot[0] = t;
  __threadfence_system();  // the host sees the timer and counter before the number
  slot[2] = seq;
}

}  // namespace

extern "C" {

// n slots, page-locked and zeroed, kept for gitax_span_stamp; their
// address, or null on failure.
void* gitax_span_slots(unsigned long long n) {
  void* p = nullptr;
  if (cudaHostAlloc(&p, n * kWords * sizeof(unsigned long long), cudaHostAllocPortable) !=
      cudaSuccess)
    return nullptr;
  memset(p, 0, n * kWords * sizeof(unsigned long long));
  g_slots = (unsigned long long*)p;
  g_count = n;
  return p;
}

// Launch stamp number `seq` (from 1) on `stream` into slot seq mod n,
// copying *counter when counter is not null.  Returns 0 or the cudaError
// of the launch.
int gitax_span_stamp(void* stream, unsigned long long seq, const void* counter) {
  span_stamp<<<1, 1, 0, (cudaStream_t)stream>>>(g_slots + kWords * (seq % g_count),
                                                (const long long*)counter, seq);
  return (int)cudaPeekAtLastError();
}

const char* gitax_span_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}

}  // extern "C"
