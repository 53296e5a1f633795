// Per-device facts for the kernels' launchers, looked up once per device
// rather than at every launch: the SM count, and a kernel's opt-in to more
// than 48 KB of dynamic shared memory.
#pragma once
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>

inline int device_sms() {
  static std::mutex mu;
  static std::map<int, int> sms;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> lock(mu);
  auto it = sms.find(dev);
  if (it == sms.end()) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    it = sms.emplace(dev, n).first;
  }
  return it->second;
}

// Lets `kernel` launch with `bytes` of dynamic shared memory (above 48 KB a
// kernel must opt in); the largest opt-in so far is kept per (kernel, device).
inline cudaError_t allow_smem(const void *kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  static std::mutex mu;
  static std::map<std::pair<const void *, int>, size_t> allowed;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> lock(mu);
  size_t &have = allowed[{kernel, dev}];
  if (have >= bytes) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) have = bytes;
  return e;
}
