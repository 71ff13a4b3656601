// The step program's gates: CUDA graph conditional IF and WHILE nodes.
//
// Counterpart of the lax.cond and lax.while_loop inside the JAX Context's
// fused step program (the rebuild's lax.cond in
// openmm_tpu/forces/nonbonded.py refresh; a CustomIntegrator's if and while
// blocks, openmm_tpu/integrators/custom.py). Called while PyTorch captures
// the MD step: omm_graph_body_begin launches, on the capturing `stream`, a
// one-thread kernel that copies the device predicate (a torch.bool scalar)
// into a new conditional handle of the graph being captured, appends an IF
// or a WHILE node after it, makes that node what the stream's next
// captured work depends on, and starts capturing `body_stream` into the
// node's body graph. The caller then captures the body on `body_stream` and
// calls omm_graph_body_end, which, for a WHILE node, first appends the
// kernel that copies the predicate into the handle again (the body
// recomputed it as its last work: the loop runs again while it holds),
// and ends that capture. A body may itself begin bodies on a further
// stream, which nests the conditional nodes. At every replay the card
// itself decides whether, and how often, each body runs; the host reads
// nothing.
//
// Conditional nodes and capture into a graph need CUDA 12.4; a body may
// hold kernel, memcpy, memset, empty, child-graph and conditional nodes
// only, which is what a PyTorch capture on one stream gives.
#include <cuda_runtime.h>

namespace {

__global__ void set_gate(cudaGraphConditionalHandle handle,
                         const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* ndeps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, nullptr, ndeps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, ndeps);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive
             ? cudaSuccess
             : cudaErrorIllegalState;
}

}  // namespace

extern "C" int omm_graph_body_begin(const void* pred, int is_while,
                                    void* stream_, void* body_stream_,
                                    unsigned long long* handle_out) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t err = capture_info(stream, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_gate<<<1, 1, 0, stream>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = capture_info(stream, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type =
      is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
#endif
  if (err != cudaSuccess) return err;
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(
      stream, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(
      stream, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  *handle_out = handle;
  return cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream_),
      params.conditional.phGraph_out[0], nullptr, nullptr, 0,
      cudaStreamCaptureModeRelaxed);
}

extern "C" int omm_graph_body_end(const void* pred, int is_while,
                                  unsigned long long handle,
                                  void* body_stream_) {
  cudaStream_t body_stream = static_cast<cudaStream_t>(body_stream_);
  if (is_while) {
    set_gate<<<1, 1, 0, body_stream>>>(handle,
                                       static_cast<const bool*>(pred));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  cudaGraph_t body;
  return cudaStreamEndCapture(body_stream, &body);
}
