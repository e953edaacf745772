// The value of a CUDA-graph conditional IF node, set on the device from a
// bool predicate: `utils/capture.iterate` records one launch before each
// IF node it adds under capture, so a replay runs the node's body only
// where the predicate holds. Plain C interface for ctypes.

#include <cuda_runtime.h>

__global__ void graph_if_set_kernel(cudaGraphConditionalHandle handle,
                                    const bool* go) {
  cudaGraphSetConditional(handle, *go ? 1u : 0u);
}

// `handle`: a cudaGraphConditionalHandle of the graph being captured on
// `stream`; `go`: one bool on the device.
extern "C" int graph_if_set(unsigned long long handle, const void* go,
                            void* stream) {
  graph_if_set_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (cudaGraphConditionalHandle)handle, (const bool*)go);
  return (int)cudaGetLastError();
}
