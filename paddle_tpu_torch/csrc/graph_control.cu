// Conditional nodes of a CUDA graph: the card's own form of a branch and of
// a data-dependent loop inside a captured program.
//
// A to_static program captures its body into one CUDA graph
// (paddle_tpu_torch/jit).  Where that body meets `if` or `while` over a
// device value (paddle_tpu_torch/static/nn.py, cond and while_loop), the
// converter opens a conditional node here: the node is added to the graph
// the stream is capturing into, after the stream's current work, and the
// stream's later work is made to follow the node; the branch or loop body
// is then captured on a second stream into the node's body graph, and the
// host goes on capturing on the first stream when the body is closed.
//
// The node's condition is a cudaGraphConditionalHandle, set on the device
// by a one-thread kernel that reads a bool from device memory: once before
// the node (an IF runs its body when it is set; a WHILE tests it before its
// first trip) and, for a WHILE, again as the last work of the body (the
// test for the next trip).  Each launch of that kernel that sets the
// condition true adds one to an optional int64 counter, so the host can
// learn after a replay how many times a body ran (the launch counts of the
// kernels inside it).
//
// Plain C interface, bound with ctypes (ops/kernels.py).  Every function
// returns a cudaError_t (0 on success), or -2 when the first stream is not
// capturing.
#include <cuda_runtime.h>

namespace {

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle,
                                       const bool* pred, int negate,
                                       long long* count) {
  bool v = *pred;
  if (negate) v = !v;
  cudaGraphSetConditional(handle, v ? 1u : 0u);
  if (v && count != nullptr) *count += 1;
}

// cudaStreamBeginCaptureToGraph and cudaStreamCreate are refused on a
// thread whose capture mode is global while a capture is under way: relax
// the mode around them, as ATen's CUDAGraph does.
struct RelaxedCapture {
  cudaStreamCaptureMode mode = cudaStreamCaptureModeRelaxed;
  RelaxedCapture() { cudaThreadExchangeStreamCaptureMode(&mode); }
  ~RelaxedCapture() { cudaThreadExchangeStreamCaptureMode(&mode); }
};

}  // namespace

extern "C" {

const char* pt_graph_error_string(int rc) {
  if (rc == -2) return "the stream is not capturing a CUDA graph";
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

// A stream of its own for conditional bodies (never one of torch's pooled
// streams, which another user may be capturing on).
int pt_graph_stream_create(void** out) {
  RelaxedCapture relaxed;
  cudaStream_t s = nullptr;
  cudaError_t e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *out = s;
  return static_cast<int>(e);
}

// Add a conditional node (`is_while`: WHILE, else IF) to the graph `parent`
// is capturing into, its condition set from `*pred` (negated if `negate`)
// just before it; `parent`'s later work follows the node, and `child`
// starts capturing into the node's body.  Writes the node's handle.
int pt_graph_node_begin(void* parent, void* child, int is_while,
                        const void* pred, int negate, void* count,
                        unsigned long long* handle_out) {
  cudaStream_t ps = static_cast<cudaStream_t>(parent);
  cudaStream_t cs = static_cast<cudaStream_t>(child);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t e = cudaStreamGetCaptureInfo(ps, &status, nullptr, &graph,
                                           &deps, &n_deps);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (status != cudaStreamCaptureStatusActive) return -2;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  set_conditional_kernel<<<1, 1, 0, ps>>>(
      handle, static_cast<const bool*>(pred), negate,
      static_cast<long long*>(count));
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // the node follows the kernel that set its condition
  e = cudaStreamGetCaptureInfo(ps, &status, nullptr, &graph, &deps,
                               &n_deps);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type =
      is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraph_t body = params.conditional.phGraph_out[0];
  e = cudaStreamUpdateCaptureDependencies(ps, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return static_cast<int>(e);
  {
    RelaxedCapture relaxed;
    e = cudaStreamBeginCaptureToGraph(cs, body, nullptr, nullptr, 0,
                                      cudaStreamCaptureModeThreadLocal);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  *handle_out = static_cast<unsigned long long>(handle);
  return 0;
}

// Close the body that `child` is capturing.  A WHILE body ends with the
// kernel that sets the condition for the next trip from `*pred`.
int pt_graph_node_end(void* child, int is_while, unsigned long long handle,
                      const void* pred, void* count) {
  cudaStream_t cs = static_cast<cudaStream_t>(child);
  if (is_while) {
    set_conditional_kernel<<<1, 1, 0, cs>>>(
        static_cast<cudaGraphConditionalHandle>(handle),
        static_cast<const bool*>(pred), 0, static_cast<long long*>(count));
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) {
      cudaGraph_t dropped;
      cudaStreamEndCapture(cs, &dropped);
      return static_cast<int>(e);
    }
  }
  cudaGraph_t body;
  return static_cast<int>(cudaStreamEndCapture(cs, &body));
}

}  // extern "C"
