// The conditional step of the device-side search, written for Hopper
// (sm_90a) with CUDA's graph API: an executable graph
//
//     set_condition(pred)  ->  IF (*pred) { the body }
//
// whose body is a clone of a captured CUDA graph (one step of a search,
// captured by PyTorch).  `pred` is one bool in device memory that the
// body itself rewrites (gitax's `cond`: a position is left and some row
// is running), so a launch after the search has ended runs one one-thread
// kernel and skips the body on the card.  Built with nvcc into a shared
// library with plain C entry points and bound with ctypes
// (gitax_torch/decode/device_loop.py); it counts as gitax's
// `lax.while_loop` condition (gitax/decode/beam.py:283-284, 488), which
// XLA evaluates on the device.
//
// PyTorch 2.11's CUDAGraph has no conditional-node methods in Python
// (`begin_capture_to_if_node` came later), so the IF node is built here
// from the runtime's own calls (CUDA 12.4+): a conditional handle, a
// kernel node that sets it from *pred, a conditional node of type IF and,
// in its body graph, a child graph node holding the step.

#include <cuda_runtime.h>

namespace {

// Set the IF node's condition from the predicate in device memory.
__global__ void set_condition(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" {

// body: a cudaGraph_t (cloned into the new graph; the caller keeps and
// frees its own); pred: a bool in device memory.  Writes the executable
// graph to *exec_out.  Returns 0 or the first cudaError.
int gitax_graph_if(void* body, const void* pred, void** exec_out) {
  if (body == nullptr || pred == nullptr || exec_out == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaGraph_t graph = nullptr;
  cudaError_t e = cudaGraphCreate(&graph, 0);
  if (e != cudaSuccess) return (int)e;
  cudaGraphConditionalHandle handle;
  // default 0 at every launch; the kernel node sets it before the IF
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault);
  cudaGraphNode_t set_node = nullptr, if_node = nullptr, step_node = nullptr;
  if (e == cudaSuccess) {
    cudaKernelNodeParams kp = {};
    void* args[] = {&handle, const_cast<void**>(&pred)};
    kp.func = reinterpret_cast<void*>(set_condition);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.sharedMemBytes = 0;
    kp.kernelParams = args;
    e = cudaGraphAddKernelNode(&set_node, graph, nullptr, 0, &kp);
  }
  cudaGraphNodeParams cp = {};
  if (e == cudaSuccess) {
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = handle;
    cp.conditional.type = cudaGraphCondTypeIf;
    cp.conditional.size = 1;
    e = cudaGraphAddNode(&if_node, graph, &set_node, 1, &cp);
  }
  if (e == cudaSuccess)
    e = cudaGraphAddChildGraphNode(&step_node, cp.conditional.phGraph_out[0], nullptr, 0,
                                   static_cast<cudaGraph_t>(body));
  cudaGraphExec_t exec = nullptr;
  if (e == cudaSuccess) e = cudaGraphInstantiate(&exec, graph, 0);
  cudaGraphDestroy(graph);
  if (e != cudaSuccess) return (int)e;
  *exec_out = exec;
  return 0;
}

// One launch of an executable graph on `stream`.
int gitax_graph_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream));
}

int gitax_graph_destroy(void* exec) {
  return (int)cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
}

// The types (cudaGraphNodeType) of a graph's nodes, depth first, each
// child graph's nodes after its own node: at most `cap` written to
// `types`.  Returns how many there are (more than cap when cut short), or
// minus the first cudaError.  What a conditional body may hold is
// limited (kernel, memset, memcpy, empty, child-graph and conditional
// nodes), so this tells why a body is refused.
int gitax_graph_node_types(void* graph, int* types, int cap) {
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr, &n);
  if (e != cudaSuccess) return -(int)e;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n > 0 ? n : 1];
  e = cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nodes, &n);
  int count = 0;
  for (size_t i = 0; e == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType type;
    e = cudaGraphNodeGetType(nodes[i], &type);
    if (e != cudaSuccess) break;
    if (count < cap) types[count] = (int)type;
    ++count;
    if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child = nullptr;
      e = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (e != cudaSuccess) break;
      int sub = gitax_graph_node_types(child, count < cap ? types + count : types,
                                       count < cap ? cap - count : 0);
      if (sub < 0) {
        e = (cudaError_t)(-sub);
        break;
      }
      count += sub;
    }
  }
  delete[] nodes;
  return e == cudaSuccess ? count : -(int)e;
}

// The runtime's name and text of a cudaError.
const char* gitax_graph_error_string(int error) {
  return cudaGetErrorString(static_cast<cudaError_t>(error));
}

}  // extern "C"
