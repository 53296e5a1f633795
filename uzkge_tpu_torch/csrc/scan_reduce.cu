// The chain MSM's scan reductions over BN254 G1, the device half of
// msm/fixed_base.py::reduce_leaves (msm_chain).  Per-lane arithmetic in
// scan_reduce.cuh.
//
// scan_leaf_reduce replaces msm/fixed_base.py::_scan_leaf_kernel (uzkge_tpu,
//   :195).  The TPU gathers every leaf's affine point out of the doubling chain
//   in XLA first (gx, gy: 64 B per leaf, 1.07 GB at n = 16384, P = 8) and then
//   folds (L, S, G) blocks of them.  Here one thread per (MSM p, lane j) reads
//   its S digits and, for each nonzero one, the one 64 B chain row it names,
//   so the gathered copy is never written.  Bound: operations (a mixed
//   addition, 11 products, per nonzero leaf against ~68 B read); the rows are
//   scattered, two 32 B sectors each.  Small blocks (128 threads) spread the
//   lanes over every SM.
// scan_proj_reduce replaces _scan_proj_kernel (:215): one thread per output
//   lane sums S consecutive projective points.  Bound: operations (12 products
//   per addition against 96 B per point).
#include <cuda_runtime.h>

#include "scan_reduce.cuh"

namespace {

__global__ void __launch_bounds__(128)
scan_leaf_reduce_kernel(const uint32_t *__restrict__ ax, const uint32_t *__restrict__ ay,
                        const int32_t *__restrict__ digits, uint32_t *__restrict__ ox,
                        uint32_t *__restrict__ oy, uint32_t *__restrict__ oz, long long lanes,
                        long long K, long long n, int S) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;  // t = p * J + j
  if (t < lanes) scan_leaf_lane(ax, ay, digits, ox, oy, oz, t, K, n, S);
}

__global__ void __launch_bounds__(128)
scan_proj_reduce_kernel(const uint32_t *__restrict__ X, const uint32_t *__restrict__ Y,
                        const uint32_t *__restrict__ Z, uint32_t *__restrict__ oX,
                        uint32_t *__restrict__ oY, uint32_t *__restrict__ oZ, long long lanes,
                        int S) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < lanes) scan_proj_lane(X, Y, Z, oX, oY, oZ, t, S);
}

unsigned blocks_for(long long lanes, int threads) {
  return (unsigned)((lanes + threads - 1) / threads);
}

bool pow2(long long v) { return v >= 1 && (v & (v - 1)) == 0; }

}  // namespace

// P MSMs of K = W * n leaves each over a chain of 2W * n rows; S divides K.
extern "C" int scan_leaf_reduce_launch(const void *ax, const void *ay, const void *digits,
                                       void *ox, void *oy, void *oz, long long P, long long K,
                                       long long n, int S, void *stream) {
  if (P < 1 || n < 1 || K < n || K % n || !pow2(S) || K % S) return (int)cudaErrorInvalidValue;
  const long long lanes = P * (K / S);
  scan_leaf_reduce_kernel<<<blocks_for(lanes, 128), 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)ax, (const uint32_t *)ay, (const int32_t *)digits, (uint32_t *)ox,
      (uint32_t *)oy, (uint32_t *)oz, lanes, K, n, S);
  return (int)cudaGetLastError();
}

// lanes output points, each the sum of S consecutive input points.
extern "C" int scan_proj_reduce_launch(const void *X, const void *Y, const void *Z, void *oX,
                                       void *oY, void *oZ, long long lanes, int S, void *stream) {
  if (lanes < 1 || !pow2(S)) return (int)cudaErrorInvalidValue;
  scan_proj_reduce_kernel<<<blocks_for(lanes, 128), 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)X, (const uint32_t *)Y, (const uint32_t *)Z, (uint32_t *)oX,
      (uint32_t *)oY, (uint32_t *)oZ, lanes, S);
  return (int)cudaGetLastError();
}
