// CUDA-graph nodes under stream capture that torch 2.11 does not expose to
// Python: the IF nodes of ``utils/graphs.py`` ``cond`` (the port's
// ``lax.cond``), and the peer copies of ``utils/graphs.py`` ``fetch`` (a
// chain of per-device graphs reading another device's graph outputs).
//
// ``cond_if_begin`` adds to the graph that `stream` is capturing a kernel
// that copies the 0-d bool `pred` into a new conditional handle, then an
// IF node on that handle after it, moves the capture's frontier past the
// node, and starts capturing `body` into the node's body graph; the
// caller queues the true branch on `body` and calls ``cond_if_end``.  On
// each replay the device runs the body only where *pred held when the
// handle's kernel ran.  The same sequence as PyTorch's
// CUDAGraph::begin_capture_to_if_node.  Conditional nodes need CUDA 12.4
// or later.
//
// ``graph_copy`` queues a copy on `stream`: captured, a memcpy node of the
// graph, which torch's own cross-device copy is not (it queues on the
// source device's stream).  ``graph_peer`` enables peer access first.
// Outside a capture it is also the upload of a page-locked host block on
// a wrapper's copy stream (``utils/graphs.py`` ``StepGraphs.upload``).
//
// ``graph_stamp`` queues a one-thread kernel that writes the device's
// %globaltimer (ns) to `out`: captured, a kernel node that stamps where a
// stage of the step starts on every replay (``utils/trace.py`` marks).
//
// Entries return a cudaError_t (0 = success); ``cond_error`` names one.

#include <cuda_runtime.h>

namespace {

// Sets the calling thread's device for an entry and gives the caller's
// back on return: the current device is shared with PyTorch's runtime.
class OnDevice {
 public:
  explicit OnDevice(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) err_ = cudaSetDevice(device);
  }
  ~OnDevice() {
    if (prev_ >= 0) cudaSetDevice(prev_);
  }
  cudaError_t err() const { return err_; }

 private:
  int prev_ = -1;
  cudaError_t err_;
};

__global__ void set_if(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

__global__ void stamp(unsigned long long* out) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *out = t;
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

// Load the handle and stamp kernels on `device` before any capture (a
// module load inside a capture is not allowed everywhere).
extern "C" int cond_init(int device) {
  OnDevice on(device);
  cudaError_t err = on.err();
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, set_if);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, stamp);
  return static_cast<int>(err);
}

extern "C" int cond_if_begin(int device, void* stream, const void* pred,
                             void* body) {
  auto st = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaGraphConditionalHandle handle;
  OnDevice on(device);
  cudaError_t err = on.err();
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
  OnDevice on(device);
  cudaError_t err = on.err();
  if (err == cudaSuccess)
    err = cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph);
  return static_cast<int>(err);
}

// Let `device` read and write `peer`'s memory (both must be able to); an
// access already enabled is no error.
extern "C" int graph_peer(int device, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err == cudaSuccess && !can) err = cudaErrorInvalidDevice;
  OnDevice on(device);
  if (err == cudaSuccess) err = on.err();
  if (err == cudaSuccess) err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();            // clear it: not a fault
    err = cudaSuccess;
  }
  return static_cast<int>(err);
}

// `bytes` from `src` to `dst` (device pointers of any devices, unified
// addressing) on `stream` of `device`.
extern "C" int graph_copy(int device, void* dst, const void* src,
                          size_t bytes, void* stream) {
  OnDevice on(device);
  cudaError_t err = on.err();
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(dst, src, bytes, cudaMemcpyDefault,
                          static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// The device's %globaltimer into the 8 bytes at `out` (device memory of
// `device`), on `stream`.
extern "C" int graph_stamp(int device, void* out, void* stream) {
  OnDevice on(device);
  cudaError_t err = on.err();
  if (err != cudaSuccess) return static_cast<int>(err);
  stamp<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cond_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
