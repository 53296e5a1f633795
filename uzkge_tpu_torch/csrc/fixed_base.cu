// The fixed-base table build over BN254 G1: window bases, multiple chains and
// the batch inversion that normalises them, the device half of
// msm/fixed_base.py::FixedBaseTable.  Per-lane arithmetic in fixed_base.cuh.
//
// fb_bases replaces msm/fixed_base.py::_bases_kernel (uzkge_tpu, :232).  One
//   thread per base point runs the doubling chain T = 2T, (W-1)*c complete
//   doublings, and emits T = 2^(c*w) P at every window.  Bound: the chain is
//   serial and there are few lanes (n = 16384 points: one warp per
//   scheduler), so one warp's instruction issue: on an H100 80GB HBM3 at
//   700 W every variant measured issued 1.40-1.45 warp instructions per
//   clock per SM, and time followed the doubling's instruction count.  The
//   doubling is field.cuh's g1_dbl_ls (equal to g1_padd(T, T, T) limb for
//   limb): its first stage is six Montgomery squarings (fp_sqr_n: 36 word
//   products instead of 64 each), which cut the instructions by 7 %; its
//   products run in lockstep pairs, 1.5 % faster than one at a time (ptxas
//   already interleaves the serial formula's independent products).  112
//   registers, no spill (ptxas, sm_90a); the block is as wide as spreads
//   the n lanes evenly over the SMs (128 at n = 16384 on 132 SMs: one block
//   of four warps per SM).
// fb_mult_chunk replaces _mult_chunk_kernel (:254).  One thread per
//   (window, point) lane keeps T and B in registers and emits CH consecutive
//   multiples T, T + B, ..., with one complete mixed addition each (11
//   Montgomery products: the two by b3 are fp_mul9), then writes the
//   advanced T.  Bound: 32-bit integer multiplies (524288 lanes x 16
//   additions per chunk at n = 16384, c = 8); the 96 B written per emitted
//   point is well under the byte bound.  In practice instruction issue: on
//   that H100, one block of 256 threads per SM (8 warps) issued 2.11-2.15
//   warp instructions per clock per SM, blocks of 128 (8 to 12 warps)
//   1.88-1.91.  The addition is g1_madd_ls (equal to g1_madd limb for limb),
//   its products in lockstep pairs, 3 % faster than one at a time; 154
//   registers, no spill.  Row j of the output is (K, 8) contiguous, so a
//   warp's 32 lanes store 1 KB together.
// The lockstep widths, squarings and block shapes were chosen by timing
//   edited copies of these sources beside one another, with their
//   registers, SASS counts and issue rates (PERF.md).
// fq_batch_inv replaces _prod_kernel (:274) and _inv_kernel (:283), the
//   product-tree inversion of pbatch_inv_fq, and _prefix_kernel (:334),
//   _invback_kernel (:345) and _fermat_bits_kernel (:355) of
//   pbatch_inv_fq_fast.  The TPU walks a 32-long scan axis inside one VMEM
//   block and inverts the roots by a Fermat power; here each thread owns one
//   strided group {t, t + M, ...} of G elements (consecutive threads touch
//   consecutive rows: coalesced), so no block has to see another's data.
//   Three kinds of launch: fq_inv_down (prefix products and group product)
//   per tree level, fq_inv_root for the last level, where each thread sweeps
//   its group forward, inverts the group's product by safegcd (fq_inv_mont,
//   ~18 rounds of 30 divsteps: a dependent chain many times shorter than
//   the ~375 products of a Fermat power) and sweeps back, and fq_inv_up per
//   level (two products per element).  With the root that cheap, the tree
//   stops at up to INV_ROOTS groups: one launch up to N = INV_ROOTS * G,
//   three for the table build's 8.4M.  Bound: 3 Montgomery products per
//   element against 64 B of traffic per element: multiplies, by a margin.
//   The wrapper counts one launch of the kernel per inversion.
#include <cuda_runtime.h>

#include "fixed_base.cuh"
#include "launch.cuh"

// fb_bases' widest block and fb_mult_chunk's block.
constexpr int BASES_THREADS = 128;
constexpr int CHUNK_THREADS = 256;

namespace {

__global__ void __launch_bounds__(BASES_THREADS)
fb_bases_kernel(const uint32_t *__restrict__ x, const uint32_t *__restrict__ y,
                uint32_t *__restrict__ ox, uint32_t *__restrict__ oy, uint32_t *__restrict__ oz,
                int n, int W, int c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t o = (size_t)i * 8;
  fb_bases_lane(x + o, y + o, ox + o, oy + o, oz + o, W, c, (size_t)n);
}

__global__ void __launch_bounds__(CHUNK_THREADS)
fb_mult_chunk_kernel(const uint32_t *__restrict__ tx, const uint32_t *__restrict__ ty,
                     const uint32_t *__restrict__ tz, const uint32_t *__restrict__ bx,
                     const uint32_t *__restrict__ by, uint32_t *__restrict__ ox,
                     uint32_t *__restrict__ oy, uint32_t *__restrict__ oz,
                     uint32_t *__restrict__ fx, uint32_t *__restrict__ fy,
                     uint32_t *__restrict__ fz, long long K, int CH) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const size_t o = (size_t)k * 8;
  fb_mult_chunk_lane(tx + o, ty + o, tz + o, bx + o, by + o, ox + o, oy + o, oz + o, fx + o,
                     fy + o, fz + o, CH, (size_t)K);
}

// pref may alias out in fq_inv_up_kernel and fq_inv_root_kernel (the
// in-place backward sweep), so neither carries __restrict__ there.
__global__ void fq_inv_down_kernel(const uint32_t *__restrict__ a, uint32_t *__restrict__ pref,
                                   uint32_t *__restrict__ prod, long long M, long long N) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < M) fq_inv_down_lane(a, pref, prod, t, M, N);
}

__global__ void fq_inv_root_kernel(const uint32_t *__restrict__ a, uint32_t *pref, uint32_t *out,
                                   long long M, long long N) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < M) fq_inv_root_lane(a, pref, out, t, M, N);
}

__global__ void fq_inv_up_kernel(const uint32_t *__restrict__ a, const uint32_t *pref,
                                 const uint32_t *__restrict__ pinv, uint32_t *out, long long M,
                                 long long N) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < M) fq_inv_up_lane(a, pref, pinv, out, t, M, N);
}

unsigned blocks_for(long long lanes, int threads) {
  return (unsigned)((lanes + threads - 1) / threads);
}

}  // namespace

extern "C" int fb_bases_launch(const void *x, const void *y, void *ox, void *oy, void *oz, int n,
                               int W, int c, void *stream) {
  if (n < 1 || W < 1 || c < 1) return (int)cudaErrorInvalidValue;
  // the narrowest whole-warp block that needs no more blocks than SMs (up to
  // BASES_THREADS): the lanes spread evenly over the SMs
  const int sms = device_sms(), per_sm = (n + sms - 1) / sms;
  int threads = (per_sm + 31) / 32 * 32;
  threads = threads < BASES_THREADS ? threads : BASES_THREADS;
  fb_bases_kernel<<<blocks_for(n, threads), threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)x, (const uint32_t *)y, (uint32_t *)ox, (uint32_t *)oy, (uint32_t *)oz, n,
      W, c);
  return (int)cudaGetLastError();
}

extern "C" int fb_mult_chunk_launch(const void *tx, const void *ty, const void *tz, const void *bx,
                                    const void *by, void *ox, void *oy, void *oz, void *fx,
                                    void *fy, void *fz, long long K, int CH, void *stream) {
  if (K < 1 || CH < 1) return (int)cudaErrorInvalidValue;
  fb_mult_chunk_kernel<<<blocks_for(K, CHUNK_THREADS), CHUNK_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)tx, (const uint32_t *)ty, (const uint32_t *)tz, (const uint32_t *)bx,
      (const uint32_t *)by, (uint32_t *)ox, (uint32_t *)oy, (uint32_t *)oz, (uint32_t *)fx,
      (uint32_t *)fy, (uint32_t *)fz, K, CH);
  return (int)cudaGetLastError();
}

extern "C" int fq_inv_down_launch(const void *a, void *pref, void *prod, long long N, long long M,
                                  void *stream) {
  if (N < 1 || M < 1 || M > N) return (int)cudaErrorInvalidValue;
  fq_inv_down_kernel<<<blocks_for(M, 128), 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)a, (uint32_t *)pref, (uint32_t *)prod, M, N);
  return (int)cudaGetLastError();
}

extern "C" int fq_inv_root_launch(const void *a, void *pref, void *out, long long N, long long M,
                                  void *stream) {
  if (N < 1 || M < 1 || M > N) return (int)cudaErrorInvalidValue;
  fq_inv_root_kernel<<<blocks_for(M, 128), 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)a, (uint32_t *)pref, (uint32_t *)out, M, N);
  return (int)cudaGetLastError();
}

extern "C" int fq_inv_up_launch(const void *a, const void *pref, const void *pinv, void *out,
                                long long N, long long M, void *stream) {
  if (N < 1 || M < 1 || M > N) return (int)cudaErrorInvalidValue;
  fq_inv_up_kernel<<<blocks_for(M, 128), 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)a, (const uint32_t *)pref, (const uint32_t *)pinv, (uint32_t *)out, M, N);
  return (int)cudaGetLastError();
}
