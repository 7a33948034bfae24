// Conditional WHILE nodes inside PyTorch's CUDA graph captures.
//
// No TPU kernel is replaced here. The JAX package stops SHAKE and RATTLE
// on the device with lax.while_loop (openmmgridforce_tpu/mm/constraints.py
// :113-121, :152-153) inside the jitted segment. A CUDA graph replays a
// fixed sequence of launches, so the port's recorded segment needs the
// same device-side stop: a conditional WHILE node (CUDA 12.4+) whose body
// graph holds one block of constraint sweeps and ends with a one-thread
// kernel that writes the "run again" flag into the node's handle.
//
// PyTorch records into a graph by stream capture and offers no while
// node, so the node is added to the graph being captured from outside:
//   1. omgf_while_begin: read the capture's graph and its open dependencies
//      from the capturing stream, create a handle whose value is reset to
//      1 at every launch (the body runs at least once, as JAX's first
//      sweep always does), add the WHILE node after those dependencies and
//      make the node the stream's only dependency;
//   2. omgf_capture_to_graph_begin: capture a second stream into the
//      node's body graph; PyTorch's operations of the body are issued on
//      that stream;
//   3. omgf_set_condition: the last operation of the body, a one-thread
//      kernel that copies a device bool into the handle;
//   4. omgf_capture_end: end the body's capture.
// Beside them, omgf_capture_nodes counts the device nodes of the graph
// being captured, for the spans that split a recorded block into its
// terms (utils/observe.py).
// Every function returns the CUDA error code (0 on success); -1 means the
// stream was not capturing.

#include <cuda_runtime.h>

#include <vector>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

}  // namespace

extern "C" {

// Loads the kernel now, so that its first launch inside a capture needs
// no module load.
int omgf_graph_init() {
  cudaFuncAttributes attr;
  return static_cast<int>(cudaFuncGetAttributes(&attr, set_condition_kernel));
}

int omgf_while_begin(void* stream, unsigned long long* handle_out,
                     void** body_graph_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph,
                                             &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) return -1;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 1,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return static_cast<int>(err);
  *handle_out = static_cast<unsigned long long>(handle);
  *body_graph_out = static_cast<void*>(params.conditional.phGraph_out[0]);
  return 0;
}

int omgf_capture_to_graph_begin(void* stream, void* graph) {
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(stream), static_cast<cudaGraph_t>(graph),
      nullptr, nullptr, 0, cudaStreamCaptureModeRelaxed));
}

int omgf_set_condition(void* stream, unsigned long long handle,
                       const void* flag) {
  set_condition_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<cudaGraphConditionalHandle>(handle),
      static_cast<const bool*>(flag));
  return static_cast<int>(cudaGetLastError());
}

int omgf_capture_end(void* stream) {
  cudaGraph_t graph;
  return static_cast<int>(
      cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &graph));
}

// The device nodes (kernels, copies and fills: the nodes whose replays a
// trace shows as operations) of the graph being captured on ``stream`` so
// far, in *count. Returns -2 where the graph holds a child graph or a
// conditional node, whose operations a count of its own nodes misses.
int omgf_capture_nodes(void* stream, unsigned long long* count) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph,
                                             nullptr, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) return -1;
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::vector<cudaGraphNode_t> nodes(n);
  if (n) {
    err = cudaGraphGetNodes(graph, nodes.data(), &n);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  unsigned long long device = 0;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) return static_cast<int>(err);
    switch (type) {
      case cudaGraphNodeTypeKernel:
      case cudaGraphNodeTypeMemcpy:
      case cudaGraphNodeTypeMemset:
        ++device;
        break;
      case cudaGraphNodeTypeGraph:
      case cudaGraphNodeTypeConditional:
        return -2;
      default:
        break;
    }
  }
  *count = device;
  return 0;
}

}  // extern "C"
