// ntt_pass: one on-chip radix-2 sub-FFT over Fr, natural order in and out.
//
// Replaces ntt/pallas_ntt.py::_direct_kernel (the TPU's VMEM-resident
// Stockham pass).  Same math: along axis -2 of a contiguous (OUT, S, IN)
// array of 32-byte Montgomery elements, log2(S) Stockham stages
//     a = x[r], b = x[r + S/2], s = a + b, d = (a - b) * w^(stride*j*l)
//     y[2jl + k] = s, y[2jl + l + k] = d        (r = jl + k, l = 2^t)
// with an optional pre-ladder multiply on load (coset k^j), an optional
// post-ladder multiply on store (n^-1 k^-j, or the four-step inter-factor
// twiddle T) and an optional constant multiply (n^-1).
//
// What bounds it: Montgomery multiplications (one 8x8-limb CIOS per
// butterfly per stage), not bytes — each element is read and written once
// per pass.  Design, simple first: one block owns one (o, g) column, keeps
// its S <= 1024 elements (<= 32 KB) in shared memory and runs the stages
// with one butterfly per thread and __syncthreads() between them.  The
// twiddle of stage t is entry (r >> t) << t of the stage-0 table
// w^(stride*e), e < S/2, so one table serves every stage.  Sizes above 1024
// recurse four-step in Python (ntt/cuda_ntt.py::fft_mid).
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

__device__ __forceinline__ void ld8(uint32_t v[8], const uint32_t *p) {
  const uint4 *q = reinterpret_cast<const uint4 *>(p);
  uint4 a = q[0], b = q[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void st8(uint32_t *p, const uint32_t v[8]) {
  uint4 *q = reinterpret_cast<uint4 *>(p);
  q[0] = make_uint4(v[0], v[1], v[2], v[3]);
  q[1] = make_uint4(v[4], v[5], v[6], v[7]);
}

__global__ void ntt_pass_kernel(const uint32_t *__restrict__ x, uint32_t *__restrict__ y,
                                const uint32_t *__restrict__ tw,
                                const uint32_t *__restrict__ pre,
                                const uint32_t *__restrict__ post,
                                const uint32_t *__restrict__ cst, int S, int logS, int IN) {
  extern __shared__ uint4 smem4[];
  uint32_t *sm = reinterpret_cast<uint32_t *>(smem4);
  const long long col = blockIdx.x;
  const long long o = col / IN;
  const int g = (int)(col % IN);
  const size_t base = ((size_t)o * S * IN + g) * 8;
  const size_t stride = (size_t)IN * 8;
  const int half = S >> 1;
  const int r = threadIdx.x;  // butterfly index, blockDim.x == S / 2

  uint32_t a[8], b[8], w[8];
  // load both halves, with the pre ladder
  ld8(a, x + base + (size_t)r * stride);
  ld8(b, x + base + (size_t)(r + half) * stride);
  if (pre != nullptr) {
    ld8(w, pre + ((size_t)r * IN + g) * 8);
    fp_mul<Fr>(a, a, w);
    ld8(w, pre + ((size_t)(r + half) * IN + g) * 8);
    fp_mul<Fr>(b, b, w);
  }

  for (int t = 0; t < logS; t++) {
    uint32_t s[8], d[8];
    fp_add<Fr>(s, a, b);
    fp_sub<Fr>(d, a, b);
    if (t < logS - 1) {  // the last stage's twiddle is w^0 = 1
      ld8(w, tw + (size_t)((r >> t) << t) * 8);
      fp_mul<Fr>(d, d, w);
    }
    const int l = 1 << t;
    const int j = r >> t, k = r & (l - 1);
    if (t > 0) __syncthreads();  // every thread has read the previous stage
    st8(sm + (size_t)(2 * j * l + k) * 8, s);
    st8(sm + (size_t)(2 * j * l + l + k) * 8, d);
    __syncthreads();
    ld8(a, sm + (size_t)r * 8);
    ld8(b, sm + (size_t)(r + half) * 8);
  }

  // store both halves, with the post ladder and the constant
  uint32_t c[8];
  if (cst != nullptr) ld8(c, cst);
  if (post != nullptr) {
    ld8(w, post + ((size_t)r * IN + g) * 8);
    fp_mul<Fr>(a, a, w);
    ld8(w, post + ((size_t)(r + half) * IN + g) * 8);
    fp_mul<Fr>(b, b, w);
  }
  if (cst != nullptr) {
    fp_mul<Fr>(a, a, c);
    fp_mul<Fr>(b, b, c);
  }
  st8(y + base + (size_t)r * stride, a);
  st8(y + base + (size_t)(r + half) * stride, b);
}

}  // namespace

extern "C" int ntt_pass_launch(const void *x, void *y, const void *tw, const void *pre,
                               const void *post, const void *cst, int out, int S, int IN,
                               void *stream) {
  int logS = 0;
  while ((1 << logS) < S) logS++;
  if (S < 2 || (1 << logS) != S || S > 1024) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((long long)out * IN));
  ntt_pass_kernel<<<grid, S / 2, (size_t)S * 32, (cudaStream_t)stream>>>(
      (const uint32_t *)x, (uint32_t *)y, (const uint32_t *)tw, (const uint32_t *)pre,
      (const uint32_t *)post, (const uint32_t *)cst, S, logS, IN);
  return (int)cudaGetLastError();
}
