// The step program's rebuild gate: a CUDA graph conditional (IF) node.
//
// Counterpart of the lax.cond on needs_rebuild inside the JAX Context's
// fused step program (openmm_tpu/forces/nonbonded.py refresh). Called while
// PyTorch captures the MD step on `stream`: it launches a one-thread kernel
// that copies the device predicate (a torch.bool scalar) into a conditional
// handle of the graph being captured, appends an IF node after it whose
// body is a copy of `body` (the captured candidate-state build and commit,
// as a child graph), and makes the IF node what the stream's next captured
// work depends on. At every replay the card itself decides whether the
// build runs; the host reads nothing.
//
// Conditional nodes need CUDA 12.4; the body may hold kernel, memcpy,
// memset, empty, child-graph and conditional nodes only, which is what a
// PyTorch capture of the build gives.
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

extern "C" int omm_graph_if(const void* pred, void* body_graph,
                            void* stream_) {
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
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
#endif
  if (err != cudaSuccess) return err;
  cudaGraphNode_t child;
  err = cudaGraphAddChildGraphNode(&child, params.conditional.phGraph_out[0],
                                   nullptr, 0,
                                   static_cast<cudaGraph_t>(body_graph));
  if (err != cudaSuccess) return err;
#if CUDART_VERSION >= 13000
  return cudaStreamUpdateCaptureDependencies(
      stream, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  return cudaStreamUpdateCaptureDependencies(
      stream, &node, 1, cudaStreamSetCaptureDependencies);
#endif
}
