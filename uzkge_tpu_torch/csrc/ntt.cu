// ntt_pass: one on-chip sub-FFT over Fr, natural order in and out.
//
// Replaces ntt/pallas_ntt.py::_direct_kernel (the TPU's VMEM-resident
// Stockham pass).  Same function: along axis -2 of a contiguous (OUT, S, IN)
// array of 32-byte Montgomery elements, the DFT of size S with root
// w^stride (ntt_pass_plain: log2(S) radix-2 Stockham stages), with an
// optional pre-ladder multiply on load (coset k^j), an optional post-ladder
// multiply on store (n^-1 k^-j, or the four-step inter-factor twiddle T) and
// an optional constant multiply (n^-1).
//
// What bounds it: Montgomery products (about 4.25 per element of an S =
// 1024 pass: one per radix-4 step but the last), not bytes: each element is
// read and written once per pass.  Design (ntt.cuh, whose schedule the CPU suite
// also runs): a block takes G adjacent columns of one o (ntt_geometry),
// copies their rows into shared memory 16 bytes a thread, and runs the pass
// as radix-4 Stockham steps with 4 elements per thread in registers: 2
// radix-2 stages a step, 3 independent products in flight between
// barriers, 5 exchanges for S = 1024 instead of 10.  The twiddles sit in
// shared memory.  Sizes above 1024 recurse four-step in Python (ntt/cuda_ntt.py::fft_mid).
#include <cuda_runtime.h>

#include "launch.cuh"
#include "ntt.cuh"

namespace {

// The CUDA block as ntt_tile sees it: the calling thread and its elements.
template <int R>
struct NttThread {
  int B;
  uint32_t v[R][8];
  template <class Fn> ZK_HD void each(Fn f) {
#ifdef __CUDA_ARCH__
    f((int)threadIdx.x, v);
#endif
  }
  ZK_HD void sync() {
#ifdef __CUDA_ARCH__
    __syncthreads();
#endif
  }
};

template <int R>
__global__ void __launch_bounds__(NTT_THREADS, 3)
ntt_pass_kernel(const uint32_t *__restrict__ x, uint32_t *__restrict__ y,
                const uint32_t *__restrict__ tw, const uint32_t *__restrict__ pre,
                const uint32_t *__restrict__ post, const uint32_t *__restrict__ cst, int S, int IN,
                int G) {
  extern __shared__ uint4 ntt_smem[];
  NttThread<R> blk;
  blk.B = (int)blockDim.x;
  ntt_tile<R>(blk, x, y, tw, pre, post, cst, S, IN, G, (long long)blockIdx.x,
              reinterpret_cast<uint32_t *>(ntt_smem));
}

template <int R>
int launch(const void *x, void *y, const void *tw, const void *pre, const void *post,
           const void *cst, int out, int S, int IN, int G, void *stream) {
  const size_t smem = (size_t)NttLayout{S, G}.units() * 16;
  const cudaError_t e = allow_smem((const void *)ntt_pass_kernel<R>, smem);
  if (e != cudaSuccess) return (int)e;
  ntt_pass_kernel<R><<<(unsigned)((long long)out * (IN / G)), S * G / R, smem,
                       (cudaStream_t)stream>>>(
      (const uint32_t *)x, (uint32_t *)y, (const uint32_t *)tw, (const uint32_t *)pre,
      (const uint32_t *)post, (const uint32_t *)cst, S, IN, G);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ntt_pass_launch(const void *x, void *y, const void *tw, const void *pre,
                               const void *post, const void *cst, int out, int S, int IN,
                               void *stream) {
  int logS = 0;
  while ((1 << logS) < S) logS++;
  if (S < 2 || (1 << logS) != S || S > 1024 || out < 1 || IN < 1)
    return (int)cudaErrorInvalidValue;
  const NttGeometry g = ntt_geometry(out, S, IN, device_sms());
  return g.R == 2 ? launch<2>(x, y, tw, pre, post, cst, out, S, IN, g.G, stream)
                  : launch<4>(x, y, tw, pre, post, cst, out, S, IN, g.G, stream);
}
