// Variable-base Pippenger MSM over BN254 G2, one MSM (P = 1): bucket
// accumulation and the windows' weighted bucket sums, the device half of
// msm/msm_g2.py.  A Groth16 proof's B = beta_g2 + <z, b_g2_query> +
// s delta_g2 runs as one such MSM (groth16/ark_prove.py::device_g2_msm).
//
// It replaces no TPU kernel: the JAX package computes this MSM on the host
// (uzkge_tpu/groth16/ark_prove.py::g2_msm_host, a Jacobian Pippenger over
// Python integers), 5.9 s of a 7.5 s reveal on the card's host.  Window
// c = 8 as for G1: 32 windows of 256 buckets, digit w of a scalar being
// byte w of its 32-byte standard form.  Bound: operations, 13 Fq2 products
// (39 Montgomery products) a mixed addition per nonzero digit, against
// 128 B an affine base and 32 B a scalar read.
//
// g2_bucket_accumulate: the G1 accumulate's shape (msm.cu) at P = 1 with
//   G2 additions.  A block of 1024 threads a window sorts its points by digit
//   (msm.cuh's msm_acc_sort, the G1 sort kernel's code under this kernel's
//   own name); a thread sums a piece of at most L points of one bucket by
//   mixed additions; a bucket's pieces meet in a binary tree, one launch a
//   level.
// g2_bucket_reduce: a block of 256 threads a window forms sum_b b * B_b bit
//   by bit (msm_g2.cuh, g2_window_sum), 11 additions and 7 doublings deep.
//   The 32 window sums go to the host, which combines them (one Fq2
//   inversion).
//
// Registers: a projective G2 point is 48 words and an affine one 32, and an
// addition holds up to 8 Fq2 temporaries.  With every Fq2 product inlined
// the kernels ran at 255 registers and spilled; reading the operands from
// shared memory did not change that.  g2.cuh's Fq2 product is therefore a
// called function: the formulas keep their operands and temporaries in
// each thread's stack frame (L1) and the product's registers are its own.
#include <cuda_runtime.h>

#include "msm_g2.cuh"

namespace {

// A CUDA block as the block functions see it: the calling thread and its
// point (G1Proj for msm_acc_sort, which does not use it; G2Proj for the
// reduce).
template <class Pt>
struct ThreadBlock {
  int B;
  Pt r;
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

constexpr int G2_PIECE_THREADS = 128;

// Block w: the counting sort of window w; `buckets` is the buckets' c0
// plane, into which it writes the identity's c0 halves for each empty bucket.
__global__ void __launch_bounds__(ACC_SORT_THREADS)
g2_bucket_accumulate_sort_kernel(const uint8_t *__restrict__ std_bytes, int32_t *__restrict__ idx,
                                 int32_t *__restrict__ meta, uint32_t *__restrict__ buckets,
                                 int n, int L) {
  __shared__ int sh[ACC_SORT_SHARED];
  ThreadBlock<G1Proj> blk;
  blk.B = ACC_SORT_THREADS;
  msm_acc_sort(blk, std_bytes, idx, meta, buckets, sh, (int)blockIdx.x, n, L);
}

// Block (x, w): pieces x * G2_PIECE_THREADS .. of window w.
__global__ void __launch_bounds__(G2_PIECE_THREADS)
g2_bucket_accumulate_piece_kernel(const uint32_t *__restrict__ bases,
                                  const int32_t *__restrict__ idx,
                                  const int32_t *__restrict__ meta, uint32_t *__restrict__ buckets,
                                  uint32_t *__restrict__ extra, int n, int XS) {
  __shared__ int32_t pst[ACC_META];
  const int w = (int)blockIdx.y;
  const int32_t *m = meta + (size_t)w * ACC_META_INTS;
  for (int k = threadIdx.x; k < ACC_META; k += blockDim.x) pst[k] = m[ACC_META + k];
  __syncthreads();
  const int s = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  g2_acc_piece(bases, idx, m, pst, buckets, extra, w, s, n, XS);
}

// The merge level at stride h; the blocks of a window whose buckets have at
// most h pieces each return at once.
__global__ void __launch_bounds__(G2_PIECE_THREADS)
g2_bucket_accumulate_merge_kernel(const int32_t *__restrict__ meta, uint32_t *buckets,
                                  uint32_t *extra, int h, int XS) {
  __shared__ int32_t pst[ACC_META];
  const int w = (int)blockIdx.y;
  const int32_t *m = meta + (size_t)w * ACC_META_INTS;
  if (m[3 * ACC_META] <= h) return;
  for (int k = threadIdx.x; k < ACC_META; k += blockDim.x) pst[k] = m[ACC_META + k];
  __syncthreads();
  const int s = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  g2_acc_merge(m, pst, buckets, extra, w, s, h, XS);
}

// Block w: window w's weighted bucket sum.
__global__ void __launch_bounds__(G2_REDUCE_THREADS)
g2_bucket_reduce_kernel(const uint32_t *__restrict__ buckets, uint32_t *__restrict__ out) {
  __shared__ G2Proj slot[G2_REDUCE_THREADS];  // 48 KB
  ThreadBlock<G2Proj> blk;
  blk.B = G2_REDUCE_THREADS;
  g2_window_sum(blk, buckets, slot, out, (int)blockIdx.x);
}

}  // namespace

// bases: (n, 4, 8); std_limbs: (n, 8) standard-form scalars; buckets: 2 *
// 32 * 256 * 24 words, its c1 plane zero; idx: 32 * n ints; meta: 32 *
// ACC_META_INTS ints; extra: 2 * 32 * ceil(n / L) * 24 words.  One sort
// launch, one piece launch, then a merge launch for each stride 1, 2, 4, ...
// below ceil(n / L).
extern "C" int g2_bucket_accumulate_launch(const void *bases, const void *std_limbs, void *buckets,
                                           void *idx, void *meta, void *extra, int n, int L,
                                           void *stream) {
  if (n < 1 || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int XS = (n + L - 1) / L, slots = XS + MSM_BUCKETS - 1;  // the most pieces a window
  g2_bucket_accumulate_sort_kernel<<<MSM_WINDOWS, ACC_SORT_THREADS, 0, st>>>(
      (const uint8_t *)std_limbs, (int32_t *)idx, (int32_t *)meta, (uint32_t *)buckets, n, L);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((slots + G2_PIECE_THREADS - 1) / G2_PIECE_THREADS), MSM_WINDOWS);
  g2_bucket_accumulate_piece_kernel<<<grid, G2_PIECE_THREADS, 0, st>>>(
      (const uint32_t *)bases, (const int32_t *)idx, (const int32_t *)meta, (uint32_t *)buckets,
      (uint32_t *)extra, n, XS);
  for (int h = 1; h < XS; h *= 2) {
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    g2_bucket_accumulate_merge_kernel<<<grid, G2_PIECE_THREADS, 0, st>>>(
        (const int32_t *)meta, (uint32_t *)buckets, (uint32_t *)extra, h, XS);
  }
  return (int)cudaGetLastError();
}

// buckets: as the accumulate leaves them; out: 2 * 32 * 24 words, the 32
// window sums in planes.
extern "C" int g2_bucket_reduce_launch(const void *buckets, void *out, void *stream) {
  g2_bucket_reduce_kernel<<<MSM_WINDOWS, G2_REDUCE_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)buckets, (uint32_t *)out);
  return (int)cudaGetLastError();
}
