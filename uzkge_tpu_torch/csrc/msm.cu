// Variable-base Pippenger MSM over BN254 G1: bucket accumulation and bucket
// reduction, the two halves of msm/msm.py::_msm_device.
//
// Window c = 8, so a 254-bit scalar has 32 unsigned 8-bit digits; digit w of
// scalar (p, i) is byte w of its 32-byte standard-form little-endian value.
// Points are Fq Montgomery limbs; buckets are projective (X : Y : Z) with the
// identity (0 : 1 : 0), and every addition is a complete RCB formula
// (field.cuh), so no lane ever branches on the identity or on doubling.
//
// The TPU version has no atomics, so it splits the points into K chunks and
// walks them in lockstep with a 512-step lax.scan of gather / mixed add /
// scatter over every (batch, window, chunk) lane (msm.py:155-195), then folds
// the chunks with a tree and runs a 255-step weighted-sum scan
// (msm.py:197-232).
//
// msm_bucket_accumulate replaces the TPU's bucket scan: the sum of each (p,
//   w, bucket)'s points, into (P, 1, 32, 256) buckets.  Bound: operations, a
//   mixed addition (11 products) per nonzero digit, against 68 B per point
//   read.  The kernel it replaces gave a thread a (p, chunk, w) lane and its
//   256 buckets in device memory, one load-add-store per point; it needed K
//   chunks for lanes (16,384 lanes at P = 8: 4 warps an SM), and the reduce
//   then folded the K chunks, more additions than the walk itself.  Here
//   (msm.cuh, "The accumulate") a counting sort in shared memory lists each
//   window's points by digit, and a thread sums a piece of at most L points
//   of one bucket in registers; the wrapper picks L per call so that the
//   pieces give at least 16 warps an SM at every batch, and a bucket's
//   pieces meet in a binary tree, one launch a level, which a window leaves
//   at once when its buckets need no more levels.  Skewed digits (a bucket
//   with all n points) add levels, never a longer chain.  The reduce gets
//   K = 1.
// msm_bucket_reduce replaces the TPU's chunk fold tree and weighted-sum scan:
//   the fold of each (p, w, bucket) over the K chunks, then sum_b b*B_b per
//   (p, w), into (P, 32, 3, 8) window sums.  Bound: operations, P*K*8192
//   projective additions of 12 products against 96 B read per addition (the
//   accumulate hands it K = 1: the weighted sum alone).  What costs
//   time on this card is depth: a thread's additions are a dependent chain,
//   and an SM issues at its ceiling only with a few warps busy on each
//   scheduler.  A block per (p, w) with a thread per bucket, as before,
//   folded K - 1 chunks in a row and had P*32 blocks: 32 at P = 1 on 132
//   SMs, 511 additions deep, then a weighted sum 80 additions deep on 16
//   threads and then one.  Here (msm.cuh) each window is T blocks of 256
//   threads, T = msm_reduce_slices(K), each thread folding a slice of about
//   K / T chunks of one bucket, so that every batch runs P*32*T blocks of
//   equal work; the slices meet in a tree in shared memory, and the weighted
//   sum is taken bit by bit by trees across the block, the window's last
//   block (an atomic count per window) adding the T blocks' shares, about 20
//   additions deep after the fold.
#include <cuda_runtime.h>

#include "msm.cuh"

namespace {

// A CUDA block as msm.cuh's block functions see it: the calling thread and
// its point.
struct ThreadBlock {
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

// Block pw * T + g: group g of window pw (msm_reduce_group); the window's
// last group to finish, by the count in done[pw], adds up its sums.
__global__ void __launch_bounds__(MSM_BUCKETS)
msm_bucket_reduce_kernel(const uint32_t *__restrict__ buckets, uint32_t *__restrict__ out,
                         uint32_t *__restrict__ part, int *__restrict__ done, int K, int T) {
  __shared__ uint4 sF4[MSM_BUCKETS * MSM_PT / 4];      // the group's folded buckets
  __shared__ uint4 sT4[MSM_BUCKETS / 2 * MSM_PT / 4];  // tree scratch
  __shared__ int last;
  uint32_t *sF = reinterpret_cast<uint32_t *>(sF4);
  uint32_t *sT = reinterpret_cast<uint32_t *>(sT4);
  const int pw = (int)blockIdx.x / T, g = (int)blockIdx.x % T;
  ThreadBlock blk;
  blk.B = MSM_BUCKETS;
  msm_reduce_group(blk, buckets, sF, sT, part, pw, g, T, K);
  __threadfence();  // this group's sums reach L2 before the count says so
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done + pw, 1) == T - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  msm_window_sum(blk, part, sT, out, pw, T);
}

constexpr int ACC_PIECE_THREADS = 128;

__global__ void __launch_bounds__(ACC_SORT_THREADS)
msm_bucket_accumulate_sort_kernel(const uint8_t *__restrict__ std_bytes, int32_t *__restrict__ idx,
                                  int32_t *__restrict__ meta, uint32_t *__restrict__ buckets,
                                  int n, int L) {
  __shared__ int sh[ACC_SORT_SHARED];
  ThreadBlock blk;
  blk.B = ACC_SORT_THREADS;
  msm_acc_sort(blk, std_bytes, idx, meta, buckets, sh, (int)blockIdx.x, n, L);
}

// Block (x, pw): pieces x * ACC_PIECE_THREADS .. of window pw.
__global__ void __launch_bounds__(ACC_PIECE_THREADS, 4)
msm_bucket_accumulate_piece_kernel(const uint32_t *__restrict__ bx, const uint32_t *__restrict__ by,
                                   const int32_t *__restrict__ idx,
                                   const int32_t *__restrict__ meta, uint32_t *__restrict__ buckets,
                                   uint32_t *__restrict__ extra, int n, int XS) {
  __shared__ int32_t pst[ACC_META];
  const int pw = (int)blockIdx.y;
  const int32_t *m = meta + (size_t)pw * ACC_META_INTS;
  for (int k = threadIdx.x; k < ACC_META; k += blockDim.x) pst[k] = m[ACC_META + k];
  __syncthreads();
  const int s = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  msm_acc_piece(bx, by, idx, m, pst, buckets, extra, pw, s, n, XS);
}

// The merge level at stride h; the blocks of a window whose buckets have at
// most h pieces each return at once.
__global__ void __launch_bounds__(ACC_PIECE_THREADS, 4)
msm_bucket_accumulate_merge_kernel(const int32_t *__restrict__ meta, uint32_t *buckets,
                                   uint32_t *extra, int h, int XS) {
  __shared__ int32_t pst[ACC_META];
  const int pw = (int)blockIdx.y;
  const int32_t *m = meta + (size_t)pw * ACC_META_INTS;
  if (m[3 * ACC_META] <= h) return;
  for (int k = threadIdx.x; k < ACC_META; k += blockDim.x) pst[k] = m[ACC_META + k];
  __syncthreads();
  const int s = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  msm_acc_merge(m, pst, buckets, extra, pw, s, h, XS);
}

}  // namespace

// The extra points a window needs at piece length L: ceil(n / L).
extern "C" int msm_bucket_accumulate_extra(int n, int L) { return (n + L - 1) / L; }

// buckets: P * 32 * 256 points; idx: P * 32 * n ints; meta: P * 32 *
// ACC_META_INTS ints; extra: P * 32 * msm_bucket_accumulate_extra(n, L)
// points.  One sort launch, one piece launch, then a merge launch for each
// stride 1, 2, 4, ... below ceil(n / L), the most pieces a bucket can have.
extern "C" int msm_bucket_accumulate_launch(const void *bx, const void *by, const void *std_limbs,
                                            void *buckets, void *idx, void *meta, void *extra,
                                            int P, int n, int L, void *stream) {
  if (P < 1 || P * MSM_WINDOWS > 65535 || n < 1 || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int XS = (n + L - 1) / L, slots = XS + MSM_BUCKETS - 1;  // the most pieces a window
  msm_bucket_accumulate_sort_kernel<<<P * MSM_WINDOWS, ACC_SORT_THREADS, 0, st>>>(
      (const uint8_t *)std_limbs, (int32_t *)idx, (int32_t *)meta, (uint32_t *)buckets, n, L);
  const dim3 grid((unsigned)((slots + ACC_PIECE_THREADS - 1) / ACC_PIECE_THREADS),
                  (unsigned)(P * MSM_WINDOWS));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  msm_bucket_accumulate_piece_kernel<<<grid, ACC_PIECE_THREADS, 0, st>>>(
      (const uint32_t *)bx, (const uint32_t *)by, (const int32_t *)idx, (const int32_t *)meta,
      (uint32_t *)buckets, (uint32_t *)extra, n, XS);
  for (int h = 1; h < XS; h *= 2) {
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    msm_bucket_accumulate_merge_kernel<<<grid, ACC_PIECE_THREADS, 0, st>>>(
        (const int32_t *)meta, (uint32_t *)buckets, (uint32_t *)extra, h, XS);
  }
  return (int)cudaGetLastError();
}

// The points of scratch (`part`) the reduce needs a window at K chunks.
extern "C" int msm_bucket_reduce_parts(int K) { return msm_reduce_slices(K) * MSM_PARTS; }

// part: P * 32 * msm_bucket_reduce_parts(K) points of scratch; done: P * 32
// ints, zero.
extern "C" int msm_bucket_reduce_launch(const void *buckets, void *out, void *part, void *done,
                                        int P, int K, void *stream) {
  if (P < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const int T = msm_reduce_slices(K);
  msm_bucket_reduce_kernel<<<(unsigned)(P * MSM_WINDOWS * T), MSM_BUCKETS, 0,
                             (cudaStream_t)stream>>>(
      (const uint32_t *)buckets, (uint32_t *)out, (uint32_t *)part, (int *)done, K, T);
  return (int)cudaGetLastError();
}
