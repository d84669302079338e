// Per-device launch set-up shared by the port's kernel libraries.
//
// Each library links nvcc's static CUDA runtime, so it keeps a current
// device of its own, apart from PyTorch's (and the library must not depend
// on which runtime PyTorch bundles). Every C entry point therefore takes
// the device index of the tensors it was handed and sets it first
// (`cudaSetDevice`), and an attribute that is held per device, the dynamic
// shared memory a block may opt into, is set on each device the first time
// a launch there needs more than it allows. Both gang-step kernels launch
// TEAMS of blocks, one block or one thread-block cluster a team, through
// `team_config`, and report what the card says of an instantiation through
// `team_info`.
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

// The launch shape of `teams` teams of `k` blocks of `threads` threads,
// `dynamic` bytes of dynamic shared memory a block; for k > 1 each team is
// one thread-block cluster of k blocks. `attr` must outlive the config.
inline cudaLaunchConfig_t team_config(int k, int teams, int threads, int dynamic,
                                      cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(teams * k, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = dynamic;
  cfg.stream = stream;
  if (k > 1) {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = k;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cfg;
}

// What `device` (already current) reports for `kernel` launched as teams of
// `k` blocks with `dynamic` bytes a block: out[0] registers a thread,
// out[1] local (spill) bytes a thread, out[2] static shared bytes a block,
// out[3] how many such teams can be resident at once
// (cudaOccupancyMaxActiveClusters for a cluster, resident blocks over all
// SMs for one block; 0 means the launch cannot run). Returns the CUDA
// error (cudaSuccess on success).
template <class Kernel>
cudaError_t team_info(int device, Kernel kernel, int k, int threads, int dynamic, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  int teams = 0;
  if (k > 1) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = team_config(k, 1, threads, dynamic, nullptr, &attr);
    e = cudaOccupancyMaxActiveClusters(&teams, kernel, &cfg);
  } else {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, dynamic);
    teams = sms * per_sm;
  }
  out[3] = teams;
  return e;
}
