// Raise a kernel's dynamic shared-memory limit once per kernel instance and
// device, so that a launch does no other host work and is safe inside a
// CUDA graph capture. The caller keeps one flag word per kernel instance
// (a function-local static): bit d is set once device d is configured.

#pragma once

#include <cuda_runtime.h>

#include <atomic>

inline cudaError_t set_smem_once(std::atomic<unsigned long long>& configured,
                                 const void* kernel, size_t bytes) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (configured.load() & bit) return cudaSuccess;
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (set == cudaSuccess) configured.fetch_or(bit);
  return set;
}
