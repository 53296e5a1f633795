// Per-block arithmetic of msm_bucket_reduce (csrc/msm.cu), the second half of
// the variable-base Pippenger over BN254 G1, as __host__ __device__ code on
// top of fixed_base.cuh.
//
// The input is the accumulate kernel's (P, K, 32, 256) projective buckets,
// 24 words each (X, Y, Z, 8 limbs apiece, Fq Montgomery).  For window (p, w)
// the output is sum_b b * F_b, F_b = sum_k B[p, k, w, b] (bucket 0 has weight
// 0 and is never read).  The work of a window is split over T blocks of 256
// threads, T = msm_reduce_slices(K): block g takes the NB = 256 / T buckets
// g*NB .. g*NB + NB - 1, and thread s*NB + i of it folds chunks s, s + T,
// s + 2T, ... of bucket g*NB + i (one slice of K), so that about as many
// threads fold at every batch P (the prover keeps P*K at 512 or 640).  A
// halving tree in shared memory adds the T slices (msm_block_tree).  The
// weighted sum is taken bit by bit: sum_b b * F_b = sum_k 2^k C_k with C_k =
// the sum of the F_b whose bucket index b has bit k set.  The block forms its
// share of each C_k (for the low m = log2(NB) bits a sum over NB / 2 of its
// buckets, for the high bits, which are g's, the sum of all of them), 32
// threads to a bit and then a tree, and writes those partial sums out; the
// window's last block to finish adds the T shares of each C_k and weighs the
// eight sums by a tree of doublings, 10 additions deep (msm_window_sum).
//
// A block is `blk`: blk.B threads, blk.each(f) calls f(t, r) for its threads
// t, r being thread t's point, and blk.sync() is the barrier between them.
// On the card each thread runs these functions with each() calling f for
// itself alone; the CPU suite (tests/test_torch_msm_header.py) runs them
// once per block with each() looping over t and a no-op sync().
#pragma once

#include "fixed_base.cuh"

constexpr int MSM_WINDOWS = 32;
constexpr int MSM_BUCKETS = 256;  // buckets a window, and threads a block
constexpr int MSM_BITS = 8;       // bits of a bucket index
constexpr int MSM_PT = 24;        // words of a projective point
constexpr int MSM_SLICE = 64;     // chunks a thread folds, where the slices allow
constexpr int MSM_MAX_SLICES = 8;
constexpr int MSM_PARTS = MSM_BITS + 1;  // partial sums a block writes: C_k shares, then all

// Slices of each bucket's K chunks: the least power of two T with ceil(K / T)
// <= MSM_SLICE, at most MSM_MAX_SLICES and at most K.
ZK_HD int msm_reduce_slices(int K) {
  int T = 1;
  while (T < MSM_MAX_SLICES && 2 * T <= K && (K + T - 1) / T > MSM_SLICE) T *= 2;
  return T;
}

ZK_HD int msm_log2(int v) {
  int m = 0;
  while ((1 << m) < v) m++;
  return m;
}

ZK_HD void msm_ld(G1Proj &q, const uint32_t *p) {
  ld_fp(q.x, p);
  ld_fp(q.y, p + 8);
  ld_fp(q.z, p + 16);
}

ZK_HD void msm_st(uint32_t *p, const G1Proj &q) {
  st_fp(p, q.x);
  st_fp(p + 8, q.y);
  st_fp(p + 16, q.z);
}

// A point another block of this launch wrote: read through L2, past this
// SM's L1, which is not coherent with the other SMs'.
ZK_HD void msm_ld_l2(G1Proj &q, const uint32_t *p) {
#ifdef __CUDA_ARCH__
  const uint4 *s = reinterpret_cast<const uint4 *>(p);
  uint4 v[6];
#pragma unroll
  for (int i = 0; i < 6; i++) v[i] = __ldcg(s + i);
  const uint32_t *w = reinterpret_cast<const uint32_t *>(v);
#pragma unroll
  for (int j = 0; j < 8; j++) {
    q.x[j] = w[j];
    q.y[j] = w[8 + j];
    q.z[j] = w[16 + j];
  }
#else
  msm_ld(q, p);
#endif
}

// r += q: RCB Alg. 7 (g1_padd; its products in lockstep pairs, tune_reduce.py's
// padd_ls2, need 178 registers here against 116, one block a SM instead of
// two, and were no faster).
ZK_HD void msm_add(G1Proj &r, const G1Proj &q) { g1_padd(r, r, q); }

// Sums each thread's point r over the threads t, t + stride, t + 2 stride,
// ... (blk.B / stride of them, a power of two) into thread t < stride:
// halving rounds in which the upper half of the live threads stores its
// points into `s` (blk.B / 2 points) and the lower half adds them.
template <class Block>
ZK_HD void msm_block_tree(Block &blk, uint32_t *s, int stride) {
  for (int h = blk.B / 2; h >= stride; h /= 2) {
    blk.each([&](int t, G1Proj &r) {
      if (t >= h && t < 2 * h) msm_st(s + (t - h) * MSM_PT, r);
    });
    blk.sync();
    blk.each([&](int t, G1Proj &r) {
      if (t < h) {
        G1Proj q;
        msm_ld(q, s + t * MSM_PT);
        msm_add(r, q);
      }
    });
    blk.sync();
  }
}

// Block g of window pw = p * 32 + w (T blocks a window): folds its NB = 256 /
// T buckets over the K chunks (sF: their NB sums; sT: blk.B / 2 points of
// tree scratch), then writes its partial sums to slots (pw * T + g) *
// MSM_PARTS + k of `part`: for k < m = log2(NB) the sum of its buckets with
// bit k set; if T > 1, in slot MSM_BITS, the sum of all of them.
template <class Block>
ZK_HD void msm_reduce_group(Block &blk, const uint32_t *__restrict__ buckets, uint32_t *sF,
                            uint32_t *sT, uint32_t *__restrict__ part, int pw, int g, int T,
                            int K) {
  const int NB = MSM_BUCKETS / T, m = msm_log2(NB);
  const int p = pw / MSM_WINDOWS, w = pw % MSM_WINDOWS;
  blk.each([&](int t, G1Proj &r) {  // thread s * NB + i: slice s of bucket g * NB + i
    const int s = t / NB, b = g * NB + t % NB;
    g1_set_identity(r);
    if (b == 0 || s >= K) return;
    const uint32_t *at = buckets + (((size_t)p * K * MSM_WINDOWS + w) * MSM_BUCKETS + b) * MSM_PT;
    const size_t step = (size_t)MSM_WINDOWS * MSM_BUCKETS * MSM_PT;  // one chunk on
    msm_ld(r, at + s * step);
    for (int k = s + T; k < K; k += T) {
      G1Proj q;
      msm_ld(q, at + k * step);
      msm_add(r, q);
    }
  });
  msm_block_tree(blk, sT, NB);
  blk.each([&](int t, G1Proj &r) {
    if (t < NB) msm_st(sF + t * MSM_PT, r);
  });
  blk.sync();
  // thread j * 8 + k, j < 32: members j, j + 32, ... of bit k's subset
  blk.each([&](int t, G1Proj &r) {
    const int k = t % MSM_BITS, j = t / MSM_BITS;
    const int count = k < m ? NB / 2 : (k == m && T > 1 ? NB : 0);
    g1_set_identity(r);
    for (int c = j; c < count; c += blk.B / MSM_BITS) {
      // k < m: the c-th index below NB with bit k set; else every index
      const int i = k < m ? ((c >> k) << (k + 1)) | (1 << k) | (c & ((1 << k) - 1)) : c;
      G1Proj q;
      msm_ld(q, sF + i * MSM_PT);
      if (c == j) r = q;
      else msm_add(r, q);
    }
  });
  msm_block_tree(blk, sT, MSM_BITS);
  blk.each([&](int t, G1Proj &r) {
    if (t < m || (t == m && T > 1))
      msm_st(part + (((size_t)pw * T + g) * MSM_PARTS + (t < m ? t : MSM_BITS)) * MSM_PT, r);
  });
}

// Window pw's sum, once all T of its blocks have written their partial sums
// (sT: 8 points of scratch): thread k < 8 adds the T shares of C_k (a high
// bit k >= m is bit k - m of the group g, whose share is then its sum of
// all), then rounds s = 1, 2, 4 set C_t += 2^s C_{t+s} for t a multiple of
// 2s (s doublings), leaving sum_k 2^k C_k in thread 0, which writes it to
// element pw of `out`.
template <class Block>
ZK_HD void msm_window_sum(Block &blk, const uint32_t *part, uint32_t *sT,
                          uint32_t *__restrict__ out, int pw, int T) {
  const int m = msm_log2(MSM_BUCKETS / T);
  blk.each([&](int t, G1Proj &r) {
    g1_set_identity(r);
    if (t >= MSM_BITS) return;
    bool first = true;
    for (int g = 0; g < T; g++) {
      if (t >= m && !((g >> (t - m)) & 1)) continue;
      G1Proj q;
      msm_ld_l2(q, part + (((size_t)pw * T + g) * MSM_PARTS + (t < m ? t : MSM_BITS)) * MSM_PT);
      if (first) r = q;
      else msm_add(r, q);
      first = false;
    }
  });
  for (int s = 1; s < MSM_BITS; s *= 2) {
    blk.each([&](int t, G1Proj &r) {
      if (t < MSM_BITS && t % (2 * s) == s) {
        for (int d = 0; d < s; d++) g1_dbl_ls<2>(r, r);
        msm_st(sT + t * MSM_PT, r);
      }
    });
    blk.sync();
    blk.each([&](int t, G1Proj &r) {
      if (t < MSM_BITS && t % (2 * s) == 0) {
        G1Proj q;
        msm_ld(q, sT + (t + s) * MSM_PT);
        msm_add(r, q);
      }
    });
    blk.sync();
  }
  blk.each([&](int t, G1Proj &r) {
    if (t == 0) msm_st(out + (size_t)pw * MSM_PT, r);
  });
}
