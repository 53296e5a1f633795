// The fixed-base query over BN254 G1: the MSM over the signed-window table,
// the device half of msm/fixed_base.py::FixedBaseTable.msm_mont.  Per-lane
// arithmetic in fixed_base_query.cuh; the level's batch inversion is
// fixed_base.cu's fq_batch_inv.
//
// fb_select replaces msm/fixed_base.py::_select_kernel (uzkge_tpu, :607).  The
//   TPU streams the whole vertical (D, 32, K) table through a D-way where-chain
//   because its gathers of 64 B rows were slow; here one thread per (MSM p,
//   leaf k) reads the one 64 B row |d| - 1 of its leaf's block of D rows and
//   writes x and y (negated for d < 0) and the identity flag.  Bound: bytes,
//   P*K rows of 64 B gathered (268 MB at P = 8, K = 524288, against 4.29 GB
//   for a stream of the table), the digits read and the leaves written; rows
//   are 64 B aligned, so a row is two whole 32 B sectors.
// fb_pair_den replaces _pair_den_kernel (:630) and _pair_den_small_kernel
//   (:737): one thread per (p, pair j) of a level pairs leaf j with leaf
//   j + H of its MSM and writes den = x2 - x1 (1 where substituted) and the
//   flags.  Bound: bytes (no product).  One kernel for every H: the TPU's
//   small variant existed only for levels narrower than its 128 lanes.
// fb_pair_combine replaces _pair_combine_kernel (:652) and
//   _pair_combine_small_kernel (:757): one thread per (p, pair), three
//   Montgomery products.  Bound: bytes (232 B per pair against 792 32-bit
//   multiplies: at the card's rates the bytes take longer).
// fb_fold replaces _fold8_kernel (:680) and the XLA halving of the remainder
//   (:1164-1174): block b folds the tile of T consecutive points b*T ..
//   b*T + T - 1 (T a power of two up to 512 dividing each MSM's count) to
//   one, by 8-to-1 halving trees while 8 divides the count, then one tree
//   over the 2 or 4 left.  Bound: operations (12 products per addition
//   against 96 B per point), but a thread's additions are a dependent chain
//   of ~20 us each, so the time is the depth of the tree in additions, and
//   the design cuts that depth: the tree runs across threads.  In each
//   halving step thread t adds pairs t, t + B, ... (fb_fold_pair), the first
//   step from device memory, later ones from the T / 2 sums in shared memory
//   (X, Y and Z in separate planes), each round of B pairs reading before a
//   barrier and rewriting after it (fb_fold_tile, which the CPU suite also
//   runs).  The launch takes the widest block B that lets every tile's
//   block be resident at once (one wave): at P = 8 MSMs of 65,536 points,
//   1024 blocks of 64 threads, 13 additions deep, then one block of 64 per
//   MSM over the 128 left, 7 deep; a thread per group of 8 ran 7 additions
//   in a row per 8-to-1 fold, 36 in all, over several waves.  Values stay
//   canonical, where the TPU kept afield's lazy [0, 2p).
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <utility>
#include <vector>

#include "fixed_base_query.cuh"

namespace {

__global__ void __launch_bounds__(256)
fb_select_kernel(const uint32_t *__restrict__ table, const int32_t *__restrict__ digits,
                 uint32_t *__restrict__ x, uint32_t *__restrict__ y, int32_t *__restrict__ inf,
                 long long P, long long K, int D) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;  // t = p * K + k
  if (t < P * K) fb_select_lane(table, digits, x, y, inf, t, K, D);
}

__global__ void __launch_bounds__(256)
fb_pair_den_kernel(const uint32_t *__restrict__ x, const int32_t *__restrict__ inf,
                   uint32_t *__restrict__ den, int32_t *__restrict__ flags, long long P,
                   long long H) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;  // t = p * H + j
  if (t < P * H) fb_pair_den_lane(x, inf, den, flags, t, H);
}

__global__ void __launch_bounds__(128)
fb_pair_combine_kernel(const uint32_t *__restrict__ x, const uint32_t *__restrict__ y,
                       const uint32_t *__restrict__ dinv, const int32_t *__restrict__ flags,
                       uint32_t *__restrict__ xo, uint32_t *__restrict__ yo,
                       int32_t *__restrict__ info, long long P, long long H) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < P * H) fb_pair_combine_lane(x, y, dinv, flags, xo, yo, info, t, H);
}

#define FB_FOLD_TILE 512  // the largest tile: 8^3 points
#define FB_FOLD_THREADS 256  // the widest block

// The CUDA block as fb_fold_tile sees it: the calling thread and its point.
struct FoldBlock {
  int B;
  G1Proj r;
  template <class F> ZK_HD void each(F f) {
#ifdef __CUDA_ARCH__
    f((int)threadIdx.x, r);
#endif
  }
  ZK_HD void sync() {
#ifdef __CUDA_ARCH__
    __syncthreads();
#endif
  }
};

__global__ void __launch_bounds__(FB_FOLD_THREADS, 2)
fb_fold_kernel(const uint32_t *__restrict__ X, const uint32_t *__restrict__ Y,
               const uint32_t *__restrict__ Z, uint32_t *__restrict__ oX,
               uint32_t *__restrict__ oY, uint32_t *__restrict__ oZ, int T) {
  extern __shared__ uint4 fold_smem[];  // three planes of T / 2 points
  uint32_t *sX = reinterpret_cast<uint32_t *>(fold_smem);
  uint32_t *sY = sX + (T / 2) * 8, *sZ = sY + (T / 2) * 8;
  FoldBlock blk;
  blk.B = (int)blockDim.x;
  fb_fold_tile(blk, X, Y, Z, sX, sY, sZ, oX, oY, oZ, (long long)blockIdx.x, T);
}

// The widest block (a power of two from 32 to min(T / 2, 256)) at which all
// `tiles` blocks are resident at once, or the widest if none is.  The blocks
// resident on the card at each width are queried once per (device, T).
int fold_threads(long long tiles, int T) {
  static std::mutex mu;
  static std::map<std::pair<int, int>, std::vector<long long>> resident;
  int widest = 32;
  while (widest * 2 <= T / 2 && widest * 2 <= FB_FOLD_THREADS) widest *= 2;
  int dev = 0;
  cudaGetDevice(&dev);
  std::vector<long long> at;  // at[i]: blocks of 32 << i threads resident at once
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = resident.find({dev, T});
    if (it == resident.end()) {
      int sms = 0;
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      std::vector<long long> v;
      for (int b = 32; b <= widest; b *= 2) {
        int per_sm = 0;
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fb_fold_kernel, b, (size_t)T * 48);
        v.push_back((long long)per_sm * sms);
      }
      it = resident.emplace(std::make_pair(dev, T), v).first;
    }
    at = it->second;
  }
  for (int i = (int)at.size() - 1; i >= 0; i--)
    if (at[i] >= tiles) return 32 << i;
  return widest;
}

unsigned blocks_for(long long lanes, int threads) {
  return (unsigned)((lanes + threads - 1) / threads);
}

}  // namespace

extern "C" int fb_select_launch(const void *table, const void *digits, void *x, void *y, void *inf,
                                long long P, long long K, int D, void *stream) {
  if (P < 1 || K < 1 || D < 1) return (int)cudaErrorInvalidValue;
  fb_select_kernel<<<blocks_for(P * K, 256), 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)table, (const int32_t *)digits, (uint32_t *)x, (uint32_t *)y,
      (int32_t *)inf, P, K, D);
  return (int)cudaGetLastError();
}

extern "C" int fb_pair_den_launch(const void *x, const void *inf, void *den, void *flags,
                                  long long P, long long H, void *stream) {
  if (P < 1 || H < 1) return (int)cudaErrorInvalidValue;
  fb_pair_den_kernel<<<blocks_for(P * H, 256), 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)x, (const int32_t *)inf, (uint32_t *)den, (int32_t *)flags, P, H);
  return (int)cudaGetLastError();
}

extern "C" int fb_pair_combine_launch(const void *x, const void *y, const void *dinv,
                                      const void *flags, void *xo, void *yo, void *info,
                                      long long P, long long H, void *stream) {
  if (P < 1 || H < 1) return (int)cudaErrorInvalidValue;
  fb_pair_combine_kernel<<<blocks_for(P * H, 128), 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)x, (const uint32_t *)y, (const uint32_t *)dinv, (const int32_t *)flags,
      (uint32_t *)xo, (uint32_t *)yo, (int32_t *)info, P, H);
  return (int)cudaGetLastError();
}

// tiles = P * Kc / T: the output's elements
extern "C" int fb_fold_launch(const void *X, const void *Y, const void *Z, void *oX, void *oY,
                              void *oZ, long long tiles, int T, void *stream) {
  if (tiles < 1 || T < 2 || T > FB_FOLD_TILE || (T & (T - 1))) return (int)cudaErrorInvalidValue;
  fb_fold_kernel<<<(unsigned)tiles, fold_threads(tiles, T), (size_t)T * 48,
                   (cudaStream_t)stream>>>(
      (const uint32_t *)X, (const uint32_t *)Y, (const uint32_t *)Z, (uint32_t *)oX,
      (uint32_t *)oY, (uint32_t *)oZ, T);
  return (int)cudaGetLastError();
}
