// The dynamic shared-memory opt-in shared by the kernels that need more
// than the default 48 KB a block (fused_scan.cu, graph_search.cu).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kDevices = 64;    // devices whose smem limits are cached

// Raise a kernel's dynamic shared-memory limit on the current device to
// `bytes` once: set[device] holds what was set (a call that needs no more
// sets no attribute, which costs a few microseconds a launch).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* set) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kDevices) return cudaErrorInvalidDevice;
  if (bytes <= set[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess) set[dev] = bytes;
  return e;
}

}  // namespace
