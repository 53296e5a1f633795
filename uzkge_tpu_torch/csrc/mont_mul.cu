// fp_mont_mul: elementwise Montgomery product a * b * 2^-256 mod p over Fr
// or Fq, on contiguous (N, 8) arrays of 32-bit little-endian limbs.
//
// Replaces ff/pallas_field.py::_mul_kernel (uzkge_tpu, :69, through _pmul_flat
// and pmul): the TPU blocks the lane axis into VMEM tiles and runs the
// delayed-carry 16-bit CIOS of pallas_rows.RowCtx.mul on them; here one
// thread owns one element and runs field.cuh's 32-bit CIOS in registers.
// Bound: bytes.  One product is 264 32-bit multiplies against 96 B moved (two
// reads, one write), and at the card's rates 96 B take longer than 264
// multiplies; each thread reads and writes its 32 B with two 16-byte vector
// accesses, neighbouring threads on neighbouring rows.
//
// fp_mul_chain is a measuring kernel, not a port: the product rate of
// field.cuh's fp_mul on the card.  Each thread runs FP_CHAINS independent
// chains acc_k <- acc_k * b, `iters` products each, with nothing but
// registers between them, so that the time is the products' and not the
// memory's (chip_smoke.py reports products per second).
#include <cuda_runtime.h>

#include "fixed_base.cuh"

namespace {

template <class F>
__global__ void __launch_bounds__(256)
fp_mont_mul_kernel(const uint32_t *__restrict__ a, const uint32_t *__restrict__ b,
                   uint32_t *__restrict__ out, long long N) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  uint32_t x[8], y[8];
  ld_fp(x, a + i * 8);
  ld_fp(y, b + i * 8);
  fp_mul<F>(x, x, y);
  st_fp(out + i * 8, x);
}

#define FP_CHAINS 4

// a: (FP_CHAINS, N, 8) chain starts; b: (N, 8); out: (FP_CHAINS, N, 8)
template <class F>
__global__ void __launch_bounds__(256)
fp_mul_chain_kernel(const uint32_t *__restrict__ a, const uint32_t *__restrict__ b,
                    uint32_t *__restrict__ out, long long N, int iters) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  uint32_t acc[FP_CHAINS][8], y[8];
#pragma unroll
  for (int k = 0; k < FP_CHAINS; k++) ld_fp(acc[k], a + (k * N + i) * 8);
  ld_fp(y, b + i * 8);
  for (int it = 0; it < iters; it++) {
#pragma unroll
    for (int k = 0; k < FP_CHAINS; k++) fp_mul<F>(acc[k], acc[k], y);
  }
#pragma unroll
  for (int k = 0; k < FP_CHAINS; k++) st_fp(out + (k * N + i) * 8, acc[k]);
}

}  // namespace

extern "C" int fp_mul_chain_launch(const void *a, const void *b, void *out, long long N,
                                   int iters, int field, void *stream) {
  if (N < 1 || iters < 0 || (field != 0 && field != 1)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((N + 255) / 256);
  if (field == 0)
    fp_mul_chain_kernel<Fr><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)a, (const uint32_t *)b, (uint32_t *)out, N, iters);
  else
    fp_mul_chain_kernel<Fq><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)a, (const uint32_t *)b, (uint32_t *)out, N, iters);
  return (int)cudaGetLastError();
}

// field: 0 = Fr, 1 = Fq
extern "C" int fp_mont_mul_launch(const void *a, const void *b, void *out, long long N, int field,
                                  void *stream) {
  if (N < 1 || (field != 0 && field != 1)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((N + 255) / 256);
  if (field == 0)
    fp_mont_mul_kernel<Fr><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)a, (const uint32_t *)b, (uint32_t *)out, N);
  else
    fp_mont_mul_kernel<Fq><<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const uint32_t *)a, (const uint32_t *)b, (uint32_t *)out, N);
  return (int)cudaGetLastError();
}
