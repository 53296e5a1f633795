// Per-device facts for the kernels' launchers, looked up once per device
// rather than at every launch: the SM count, a kernel's opt-in to more than
// 48 KB of dynamic shared memory, and the block width of a fold over tiles.
#pragma once
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>
#include <vector>

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

// The block width of a kernel that runs fb_fold_tile (fixed_base_query.cuh)
// once per block over `tiles` tiles of T points (T * 48 bytes of dynamic
// shared memory: three planes of T / 2 points): the widest power of two from
// 32 to min(T / 2, most) at which all `tiles` blocks are resident
// at once (one wave), or the widest if none is.  The blocks resident on the
// card at each width are queried once per (kernel, device, T).
inline int fold_threads(const void *kernel, long long tiles, int T, int most) {
  static std::mutex mu;
  static std::map<std::tuple<const void *, int, int>, std::vector<long long>> resident;
  int widest = 32;
  while (widest * 2 <= T / 2 && widest * 2 <= most) widest *= 2;
  int dev = 0;
  cudaGetDevice(&dev);
  std::vector<long long> at;  // at[i]: blocks of 32 << i threads resident at once
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = resident.find({kernel, dev, T});
    if (it == resident.end()) {
      int sms = 0;
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      std::vector<long long> v;
      for (int b = 32; b <= widest; b *= 2) {
        int per_sm = 0;
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, b, (size_t)T * 48);
        v.push_back((long long)per_sm * sms);
      }
      it = resident.emplace(std::make_tuple(kernel, dev, T), v).first;
    }
    at = it->second;
  }
  for (int i = (int)at.size() - 1; i >= 0; i--)
    if (at[i] >= tiles) return 32 << i;
  return widest;
}
