// Build-and-launch check for the port's CUDA kernels.
//
// Replaces the probe kernel of spark_scheduler_tpu/ops/pallas_fifo.py
// `pallas_available` (o = x + 1 over an [8, 128] int32 tile). Here it is not
// a gate that picks another path: ops/probe.py launches it once and raises
// if the library does not load, the launch is refused, or the result is
// wrong. Bounded by launch latency (8 KB of traffic).
#include <cuda_runtime.h>

namespace {

__global__ void probe_add_one_kernel(const int* x, int* o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] + 1;
}

}  // namespace

// One launch on `device` (set first: this library's current device is its
// own, apart from PyTorch's).
extern "C" int probe_add_one(int device, const int* x, int* o, int n, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  probe_add_one_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(x, o, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* probe_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
