// Stage marks of the compiled request: a one-thread kernel that writes the card's clock.
//
// Not a port of a TPU kernel: the JAX package has none like it. A CUDA
// graph's replay runs no host code between the request's stages, so the
// boundary of a stage has to be a node of the graph itself. Each mark is
// one such node: stage_mark_kernel reads %globaltimer (ns, the clock the
// profiler's device timestamps come from) and writes it to slots[k] when
// the stream reaches it. far_tpu_torch/utils/prof.py places the marks;
// pipeline.CompiledRequest.stage_ms reads the slots of the last request.
//
// far_stage_mark also reports, while the stream is being captured, how
// many operation nodes (kernels, copies, memsets: the nodes that do work on
// the card; child graphs counted through) the capturing graph holds before
// this mark, so the capture can count each stage's operations. The count
// takes copies and memsets with the kernels because a replay runs some of
// a graph's small copy and memset nodes as kernels, and a profiler trace
// shows each such node as one device operation either way. Outside a
// capture it reports -1.
//
// Bound: launch latency. One thread writes 8 bytes; in a graph the node
// costs about one kernel launch of the replay's chain.

#include <cuda_runtime.h>

#include <vector>

namespace {

__global__ void stage_mark_kernel(long long* slots, int k) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  slots[k] = (long long)t;
}

// Kernel, copy and memset nodes of `graph`, child graphs' included, added to *count.
cudaError_t count_operation_nodes(cudaGraph_t graph, long long* count) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess || n == 0) return err;
  std::vector<cudaGraphNode_t> nodes(n);
  err = cudaGraphGetNodes(graph, nodes.data(), &n);
  if (err != cudaSuccess) return err;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) return err;
    if (type == cudaGraphNodeTypeKernel || type == cudaGraphNodeTypeMemcpy ||
        type == cudaGraphNodeTypeMemset) {
      ++*count;
    } else if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      err = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (err == cudaSuccess) err = count_operation_nodes(child, count);
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace

// slots: int64 on the card with more than k entries. *nodes: the operation
// nodes of the graph `stream` captures into, before this mark, or -1 where
// the stream is not capturing.
extern "C" int far_stage_mark(void* slots, int k, long long* nodes, void* stream) {
  if (k < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph);
  if (err != cudaSuccess) return (int)err;
  *nodes = -1;
  if (status == cudaStreamCaptureStatusActive) {
    long long n = 0;
    err = count_operation_nodes(graph, &n);
    if (err != cudaSuccess) return (int)err;
    *nodes = n;
  }
  stage_mark_kernel<<<1, 1, 0, s>>>((long long*)slots, k);
  return (int)cudaGetLastError();
}
