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
// msm_bucket_accumulate: one thread owns one (p, k, w) lane and its 256
//   buckets in device memory, laid out (P, K, 32, 256, 3, 8).  It sets them to
//   the identity and walks chunk k's points in order, adding point i into
//   bucket digit(p, i, w) with the mixed addition (digit 0 is skipped).  The
//   32 threads of a warp are the 32 windows of one (p, k): they read the same
//   point and the same 32 scalar bytes, so those loads are shared.  Bound:
//   Fq multiplications (11 per mixed addition); the wrapper picks K so that
//   P*32*K lanes fill the card while the fold below stays no larger than the
//   walk.
// msm_bucket_reduce replaces the TPU's chunk fold tree and weighted-sum scan:
//   the fold of each (p, w, bucket) over the K chunks, then sum_b b*B_b per
//   (p, w), into (P, 32, 3, 8) window sums.  Bound: operations, P*K*8192
//   projective additions of 12 products (4.2-5.2 M a call, as the prover
//   keeps P*K at 512 or 640) against 96 B read per addition.  What costs
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

__global__ void msm_bucket_accumulate_kernel(const uint32_t *__restrict__ bx,
                                             const uint32_t *__restrict__ by,
                                             const uint8_t *__restrict__ std_bytes,
                                             uint32_t *__restrict__ buckets, int P, int n,
                                             int K, int Cn) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (long long)P * K * MSM_WINDOWS) return;
  const int w = (int)(lane % MSM_WINDOWS);
  const long long pk = lane / MSM_WINDOWS;
  const int k = (int)(pk % K);
  const int p = (int)(pk / K);
  uint32_t *B = buckets + lane * MSM_BUCKETS * MSM_PT;

  G1Proj acc;
  g1_set_identity(acc);
  for (int b = 0; b < MSM_BUCKETS; b++) msm_st(B + b * MSM_PT, acc);

  const int i0 = k * Cn;
  const int i1 = min(n, i0 + Cn);
  const uint8_t *digits = std_bytes + ((size_t)p * n) * 32 + w;
  for (int i = i0; i < i1; i++) {
    const int d = digits[(size_t)i * 32];
    if (d == 0) continue;
    uint32_t x[8], y[8];
    ld_fp(x, bx + (size_t)i * 8);
    ld_fp(y, by + (size_t)i * 8);
    uint32_t *slot = B + d * MSM_PT;
    msm_ld(acc, slot);
    g1_madd(acc, acc, x, y);
    msm_st(slot, acc);
  }
}

struct ReduceBlock {
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
  ReduceBlock blk;
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

}  // namespace

extern "C" int msm_bucket_accumulate_launch(const void *bx, const void *by, const void *std_limbs,
                                            void *buckets, int P, int n, int K, void *stream) {
  if (P < 1 || n < 1 || K < 1 || K > n) return (int)cudaErrorInvalidValue;
  const int Cn = (n + K - 1) / K;
  const long long lanes = (long long)P * K * MSM_WINDOWS;
  const int threads = 128;
  const unsigned blocks = (unsigned)((lanes + threads - 1) / threads);
  msm_bucket_accumulate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)bx, (const uint32_t *)by, (const uint8_t *)std_limbs,
      (uint32_t *)buckets, P, n, K, Cn);
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
