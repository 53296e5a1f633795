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
// (msm.py:197-232).  On the card each lane becomes a thread.
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
// msm_bucket_reduce: one block per (p, w), 256 threads.  Thread b folds
//   bucket b over the K chunks; then 16 threads each reduce a segment of 16
//   buckets to tot_s = sum_u u*B[16s+u] and agg_s = sum_u B[16s+u], and
//   thread 0 forms sum_b b*B_b = sum_s tot_s + 16 * sum_s s*agg_s with two
//   short running sums and four doublings.  Bucket 0 carries weight 0 and is
//   never read.  Output (P, 32, 3, 8) window sums.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int NWIN = 32;
constexpr int NBUCKET = 256;
constexpr int PT_WORDS = 24;  // 3 coordinates x 8 limbs

__device__ __forceinline__ void load_proj(G1Proj &q, const uint32_t *p) {
  const uint4 *s = reinterpret_cast<const uint4 *>(p);
  uint4 v[6];
#pragma unroll
  for (int i = 0; i < 6; i++) v[i] = s[i];
  const uint32_t *w = reinterpret_cast<const uint32_t *>(v);
#pragma unroll
  for (int j = 0; j < 8; j++) {
    q.x[j] = w[j];
    q.y[j] = w[8 + j];
    q.z[j] = w[16 + j];
  }
}

__device__ __forceinline__ void store_proj(uint32_t *p, const G1Proj &q) {
  uint32_t w[PT_WORDS];
#pragma unroll
  for (int j = 0; j < 8; j++) {
    w[j] = q.x[j];
    w[8 + j] = q.y[j];
    w[16 + j] = q.z[j];
  }
  uint4 *d = reinterpret_cast<uint4 *>(p);
#pragma unroll
  for (int i = 0; i < 6; i++) d[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
}

__device__ __forceinline__ void load8(uint32_t v[8], const uint32_t *p) {
  const uint4 *q = reinterpret_cast<const uint4 *>(p);
  uint4 a = q[0], b = q[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__global__ void msm_bucket_accumulate_kernel(const uint32_t *__restrict__ bx,
                                             const uint32_t *__restrict__ by,
                                             const uint8_t *__restrict__ std_bytes,
                                             uint32_t *__restrict__ buckets, int P, int n,
                                             int K, int Cn) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (long long)P * K * NWIN) return;
  const int w = (int)(lane % NWIN);
  const long long pk = lane / NWIN;
  const int k = (int)(pk % K);
  const int p = (int)(pk / K);
  uint32_t *B = buckets + lane * NBUCKET * PT_WORDS;

  G1Proj acc;
  g1_set_identity(acc);
  for (int b = 0; b < NBUCKET; b++) store_proj(B + b * PT_WORDS, acc);

  const int i0 = k * Cn;
  const int i1 = min(n, i0 + Cn);
  const uint8_t *digits = std_bytes + ((size_t)p * n) * 32 + w;
  for (int i = i0; i < i1; i++) {
    const int d = digits[(size_t)i * 32];
    if (d == 0) continue;
    uint32_t x[8], y[8];
    load8(x, bx + (size_t)i * 8);
    load8(y, by + (size_t)i * 8);
    uint32_t *slot = B + d * PT_WORDS;
    load_proj(acc, slot);
    g1_madd(acc, acc, x, y);
    store_proj(slot, acc);
  }
}

constexpr int SEG = 16;  // buckets per segment in the weighted sum

__global__ void __launch_bounds__(NBUCKET)
msm_bucket_reduce_kernel(const uint32_t *__restrict__ buckets, uint32_t *__restrict__ out,
                         int K) {
  __shared__ uint4 folded4[NBUCKET * PT_WORDS / 4];
  __shared__ uint4 segs4[2 * SEG * PT_WORDS / 4];
  uint32_t *folded = reinterpret_cast<uint32_t *>(folded4);
  uint32_t *segs = reinterpret_cast<uint32_t *>(segs4);
  const int pw = blockIdx.x;  // p * 32 + w
  const int p = pw / NWIN, w = pw % NWIN;
  const int b = threadIdx.x;

  // 1. fold bucket b over the K chunks
  G1Proj acc, q;
  load_proj(acc, buckets + ((((size_t)p * K) * NWIN + w) * NBUCKET + b) * PT_WORDS);
  for (int k = 1; k < K; k++) {
    load_proj(q, buckets + ((((size_t)p * K + k) * NWIN + w) * NBUCKET + b) * PT_WORDS);
    g1_padd(acc, acc, q);
  }
  store_proj(folded + b * PT_WORDS, acc);
  __syncthreads();

  // 2. per segment s: tot_s = sum_{u>=1} u*B[16s+u], agg_s = sum_u B[16s+u]
  if (b < SEG) {
    G1Proj run, tot;
    g1_set_identity(run);
    g1_set_identity(tot);
    for (int u = SEG - 1; u >= 1; u--) {
      load_proj(q, folded + (b * SEG + u) * PT_WORDS);
      g1_padd(run, run, q);
      g1_padd(tot, tot, run);
    }
    if (b > 0) {  // bucket 0 has weight 0 and is never read
      load_proj(q, folded + (b * SEG) * PT_WORDS);
      g1_padd(run, run, q);
    }
    store_proj(segs + (2 * b) * PT_WORDS, tot);
    store_proj(segs + (2 * b + 1) * PT_WORDS, run);
  }
  __syncthreads();

  // 3. sum_s tot_s + 16 * sum_{s>=1} s*agg_s
  if (b == 0) {
    G1Proj sum, run, tot;
    g1_set_identity(sum);
    g1_set_identity(run);
    g1_set_identity(tot);
    for (int s = SEG - 1; s >= 1; s--) {
      load_proj(q, segs + (2 * s + 1) * PT_WORDS);
      g1_padd(run, run, q);
      g1_padd(tot, tot, run);
    }
    for (int i = 0; i < 4; i++) g1_padd(tot, tot, tot);  // * 16
    for (int s = 0; s < SEG; s++) {
      load_proj(q, segs + (2 * s) * PT_WORDS);
      g1_padd(sum, sum, q);
    }
    g1_padd(sum, sum, tot);
    store_proj(out + (size_t)pw * PT_WORDS, sum);
  }
}

}  // namespace

extern "C" int msm_bucket_accumulate_launch(const void *bx, const void *by, const void *std_limbs,
                                            void *buckets, int P, int n, int K, void *stream) {
  if (P < 1 || n < 1 || K < 1 || K > n) return (int)cudaErrorInvalidValue;
  const int Cn = (n + K - 1) / K;
  const long long lanes = (long long)P * K * NWIN;
  const int threads = 128;
  const unsigned blocks = (unsigned)((lanes + threads - 1) / threads);
  msm_bucket_accumulate_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)bx, (const uint32_t *)by, (const uint8_t *)std_limbs,
      (uint32_t *)buckets, P, n, K, Cn);
  return (int)cudaGetLastError();
}

extern "C" int msm_bucket_reduce_launch(const void *buckets, void *out, int P, int K,
                                        void *stream) {
  if (P < 1 || K < 1) return (int)cudaErrorInvalidValue;
  msm_bucket_reduce_kernel<<<(unsigned)(P * NWIN), NBUCKET, 0, (cudaStream_t)stream>>>(
      (const uint32_t *)buckets, (uint32_t *)out, K);
  return (int)cudaGetLastError();
}
