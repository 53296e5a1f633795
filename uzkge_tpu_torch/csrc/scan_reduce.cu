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
//   addition, 11 products, per nonzero leaf against ~68 B read).  What holds
//   it back on this card is latency: a lane's additions are a dependent
//   chain, and the warps resident on an SM (set by registers) are too few to
//   issue at the product's ceiling.  Two things follow.  A warp issues an
//   addition whenever one of its lanes has a leaf to add, so a walk over all
//   S leaves spent the slots of the zero ones (a quarter of signed base-4
//   digits) on every warp with one nonzero lane; the lane instead walks its
//   nonzero leaves by a mask of its digits (scan_leaf_lane), and a warp runs
//   as many additions as its busiest lane (on an H100 the walk over all
//   leaves, in the same block, took 21 % longer).  And the
//   block is 512 threads at 128 registers a thread, 16 warps an SM, though
//   the lane then spills about 150 bytes: 256 threads (185 registers, 8
//   warps) and 384 took 24 % and 7 % longer.  Rows are indexed with 32 bits
//   by a shift and a mask (n a power of two).
// scan_proj_reduce replaces _scan_proj_kernel (:215): block t folds the S
//   consecutive projective points t*S .. t*S + S - 1 (S a power of two up to
//   512) to output t.  Bound: operations (12 products per addition against
//   96 B per point).  The TPU's two running sums per output made each S = 32
//   round 17 additions deep on one thread; at 512, 16 and 8 outputs the last
//   rounds ran a few hundred threads on 132 SMs, and a launch took the same
//   ~0.58 ms whatever its width: its time is the depth in additions.  Here
//   the sum is fb_fold's halving tree spread over the block's threads
//   (fb_fold_tile, shared with fixed_base_query.cu's fb_fold_kernel), about
//   9 additions deep per 512 points, and the rounds are tiles of up to 512
//   (msm/fixed_base.py::fold_tiles): at P = 8 MSMs of 65,536 points, 1024
//   blocks of 512 points then 8 of 128, 2 launches about 16 additions deep
//   instead of 4 launches about 52 deep.  Its own __global__, so that a
//   profile keeps its time apart from fb_fold's.
#include <cuda_runtime.h>

#include "fixed_base_query.cuh"
#include "launch.cuh"
#include "scan_reduce.cuh"

namespace {

constexpr int LEAF_THREADS = 512;

__global__ void __launch_bounds__(LEAF_THREADS)
scan_leaf_reduce_kernel(const uint32_t *__restrict__ ax, const uint32_t *__restrict__ ay,
                        const int32_t *__restrict__ digits, uint32_t *__restrict__ ox,
                        uint32_t *__restrict__ oy, uint32_t *__restrict__ oz, int lanes, int K,
                        int lg_n, int S) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;  // t = p * J + j
  if (t < (unsigned)lanes) scan_leaf_lane(ax, ay, digits, ox, oy, oz, (int)t, K, lg_n, S);
}

__global__ void __launch_bounds__(FB_FOLD_THREADS, 2)
scan_proj_reduce_kernel(const uint32_t *__restrict__ X, const uint32_t *__restrict__ Y,
                        const uint32_t *__restrict__ Z, uint32_t *__restrict__ oX,
                        uint32_t *__restrict__ oY, uint32_t *__restrict__ oZ, int S) {
  extern __shared__ uint4 proj_smem[];  // three planes of S / 2 points
  uint32_t *sX = reinterpret_cast<uint32_t *>(proj_smem);
  uint32_t *sY = sX + (S / 2) * 8, *sZ = sY + (S / 2) * 8;
  FoldBlock blk;
  blk.B = (int)blockDim.x;
  fb_fold_tile(blk, X, Y, Z, sX, sY, sZ, oX, oY, oZ, (long long)blockIdx.x, S);
}

unsigned blocks_for(long long lanes, int threads) {
  return (unsigned)((lanes + threads - 1) / threads);
}

bool pow2(long long v) { return v >= 1 && (v & (v - 1)) == 0; }

}  // namespace

// P MSMs of K = W * n leaves each over a chain of 2W * n rows; n and S powers
// of two dividing K, S <= 32 (a lane's digit mask); K and the P * K / S lanes
// below 2^31 (32-bit leaves, rows and lanes).
extern "C" int scan_leaf_reduce_launch(const void *ax, const void *ay, const void *digits,
                                       void *ox, void *oy, void *oz, long long P, long long K,
                                       long long n, int S, void *stream) {
  if (P < 1 || !pow2(n) || K < n || K % n || !pow2(S) || S > 32 || K % S ||
      K >= (1LL << 31) || P * (K / S) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  int lg_n = 0;
  while ((1LL << lg_n) < n) lg_n++;
  const long long lanes = P * (K / S);
  scan_leaf_reduce_kernel<<<blocks_for(lanes, LEAF_THREADS), LEAF_THREADS, 0,
                            (cudaStream_t)stream>>>(
      (const uint32_t *)ax, (const uint32_t *)ay, (const int32_t *)digits, (uint32_t *)ox,
      (uint32_t *)oy, (uint32_t *)oz, (int)lanes, (int)K, lg_n, S);
  return (int)cudaGetLastError();
}

// lanes output points, each the sum of S consecutive input points (S a
// power of two from 2 to FB_FOLD_TILE), one block each.
extern "C" int scan_proj_reduce_launch(const void *X, const void *Y, const void *Z, void *oX,
                                       void *oY, void *oZ, long long lanes, int S, void *stream) {
  if (lanes < 1 || lanes >= (1LL << 31) || S < 2 || S > FB_FOLD_TILE || !pow2(S))
    return (int)cudaErrorInvalidValue;
  const int B = fold_threads((const void *)scan_proj_reduce_kernel, lanes, S, FB_FOLD_THREADS);
  scan_proj_reduce_kernel<<<(unsigned)lanes, B, (size_t)S * 48, (cudaStream_t)stream>>>(
      (const uint32_t *)X, (const uint32_t *)Y, (const uint32_t *)Z, (uint32_t *)oX,
      (uint32_t *)oY, (uint32_t *)oZ, S);
  return (int)cudaGetLastError();
}
