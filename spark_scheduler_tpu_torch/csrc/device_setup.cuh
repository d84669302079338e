// Per-device launch set-up shared by the port's kernel libraries.
//
// Each library links nvcc's static CUDA runtime, so it keeps a current
// device of its own, apart from PyTorch's (and the library must not depend
// on which runtime PyTorch bundles). Every C entry point therefore takes
// the device index of the tensors it was handed and sets it first
// (`cudaSetDevice`), and an attribute that is held per device, the dynamic
// shared memory a block may opt into, is set on each device the first time
// a launch there needs more than it allows.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

constexpr int kMaxDevices = 64;

// The dynamic shared memory allowed so far, per device and per kernel
// instantiation (`slot`, fewer than kSlots); raised with
// cudaFuncSetAttribute only when a launch needs more.
template <int kSlots>
class SmemAllowance {
 public:
  cudaError_t ensure(int device, int slot, const void* kernel, int bytes) {
    if (device < 0 || device >= kMaxDevices || slot < 0 || slot >= kSlots)
      return cudaErrorInvalidValue;
    std::lock_guard<std::mutex> lock(mu_);
    int& allowed = allowed_[device][slot];
    if (bytes <= allowed) return cudaSuccess;
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess) allowed = bytes;
    return e;
  }

 private:
  std::mutex mu_;
  int allowed_[kMaxDevices][kSlots] = {};
};
