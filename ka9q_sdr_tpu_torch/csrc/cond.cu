// IF nodes of a CUDA graph under stream capture: the device-side branch
// that ``utils/graphs.py`` ``cond`` captures as the port's ``lax.cond``.
//
// ``cond_if_begin`` adds to the graph that `stream` is capturing a kernel
// that copies the 0-d bool `pred` into a new conditional handle, then an
// IF node on that handle after it, moves the capture's frontier past the
// node, and starts capturing `body` into the node's body graph; the
// caller queues the true branch on `body` and calls ``cond_if_end``.  On
// each replay the device runs the body only where *pred held when the
// handle's kernel ran.  The same sequence as PyTorch's
// CUDAGraph::begin_capture_to_if_node, which torch 2.11 does not expose to
// Python.  Conditional nodes need CUDA 12.4 (runtime and driver).
//
// Entries return a cudaError_t (0 = success); ``cond_error`` names one.

#include <cuda_runtime.h>

namespace {

__global__ void set_if(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

cudaError_t capture_frontier(cudaStream_t stream, cudaGraph_t* graph,
                             const cudaGraphNode_t** deps, size_t* n) {
  cudaStreamCaptureStatus status;
  unsigned long long id;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, graph,
                                             deps, nullptr, n);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, graph,
                                             deps, n);
#endif
  if (err == cudaSuccess && status != cudaStreamCaptureStatusActive)
    err = cudaErrorIllegalState;   // not capturing: refuse
  return err;
}

}  // namespace

// Load the handle kernel on `device` before any capture (a module load
// inside a capture is not allowed everywhere).
extern "C" int cond_init(int device) {
  cudaError_t err = cudaSetDevice(device);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, set_if);
  return static_cast<int>(err);
}

extern "C" int cond_if_begin(int device, void* stream, const void* pred,
                             void* body) {
  auto st = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaGraphConditionalHandle handle;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = capture_frontier(st, &graph, &deps, &n);
  if (err == cudaSuccess)
    err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                           cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_if<<<1, 1, 0, st>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err == cudaSuccess) err = capture_frontier(st, &graph, &deps, &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n, &params);
  if (err == cudaSuccess)
    err = cudaStreamUpdateCaptureDependencies(
        st, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, n, &params);
  if (err == cudaSuccess)
    err = cudaStreamUpdateCaptureDependencies(
        st, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err == cudaSuccess)
    err = cudaStreamBeginCaptureToGraph(
        static_cast<cudaStream_t>(body), params.conditional.phGraph_out[0],
        nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
  return static_cast<int>(err);
}

// End the body's capture; the body graph belongs to its node.
extern "C" int cond_if_end(int device, void* body) {
  cudaGraph_t graph;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph);
  return static_cast<int>(err);
}

extern "C" const char* cond_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
