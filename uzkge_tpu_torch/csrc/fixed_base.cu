// The fixed-base table build over BN254 G1: window bases, multiple chains and
// the batch inversion that normalises them, the device half of
// msm/fixed_base.py::FixedBaseTable.  Per-lane arithmetic in fixed_base.cuh.
//
// fb_bases replaces msm/fixed_base.py::_bases_kernel (uzkge_tpu, :232).  One
//   thread per base point runs the doubling chain T = 2T, (W-1)*c complete
//   projective additions, and emits T = 2^(c*w) P at every window.  Bound: the
//   chain is serial, so with n = 16384 points there are only 16384 threads
//   (about four warps per SM): latency of dependent Montgomery products, not
//   the multiply rate or bytes.  Small blocks (64 threads) spread the lanes
//   over every SM; nothing else in the design can shorten the chain.
// fb_mult_chunk replaces _mult_chunk_kernel (:254).  One thread per
//   (window, point) lane keeps T and B in registers and emits CH consecutive
//   multiples T, T + B, ..., with one complete mixed addition each (13
//   Montgomery products), then writes the advanced T.  Bound: 32-bit integer
//   multiplies (524288 lanes x 16 additions per chunk at n = 16384, c = 8);
//   the 96 B written per emitted point is well under the byte bound.  Row j of
//   the output is (K, 8) contiguous, so a warp's 32 lanes store 1 KB
//   together.
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

namespace {

__global__ void __launch_bounds__(64)
fb_bases_kernel(const uint32_t *__restrict__ x, const uint32_t *__restrict__ y,
                uint32_t *__restrict__ ox, uint32_t *__restrict__ oy, uint32_t *__restrict__ oz,
                int n, int W, int c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t o = (size_t)i * 8;
  fb_bases_lane(x + o, y + o, ox + o, oy + o, oz + o, W, c, (size_t)n);
}

__global__ void __launch_bounds__(128)
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
  fb_bases_kernel<<<blocks_for(n, 64), 64, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)x, (const uint32_t *)y, (uint32_t *)ox, (uint32_t *)oy, (uint32_t *)oz, n,
      W, c);
  return (int)cudaGetLastError();
}

extern "C" int fb_mult_chunk_launch(const void *tx, const void *ty, const void *tz, const void *bx,
                                    const void *by, void *ox, void *oy, void *oz, void *fx,
                                    void *fy, void *fz, long long K, int CH, void *stream) {
  if (K < 1 || CH < 1) return (int)cudaErrorInvalidValue;
  fb_mult_chunk_kernel<<<blocks_for(K, 128), 128, 0, (cudaStream_t)stream>>>(
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
