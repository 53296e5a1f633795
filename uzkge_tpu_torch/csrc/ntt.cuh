// The block schedule of ntt_pass (ntt.cu): one on-chip FFT of size S over Fr
// along axis 1 of a contiguous (OUT, S, IN) array of 32-byte Montgomery
// elements, natural order in and out, for a tile of G adjacent columns
// (o, g0 .. g0 + G - 1).  As __host__ __device__ code on field.cuh: the card
// runs it with one CUDA thread per schedule thread (NttThread in ntt.cu),
// g++ runs it for the CPU test suite with the threads in turn
// (tests/test_torch_ntt_header.py).
//
// The schedule.  Field arithmetic has no rounding, so any schedule that
// computes the DFT y[k] = sum_s x[s] w^(s k) (w the root whose powers w^e,
// e < S/2, are the twiddle table) returns the same canonical limbs as the
// radix-2 Stockham passes of ntt_pass_plain.  This one is a Stockham FFT of
// radix R (4, or 2 where S = 2 or the pass is small), its last step of radix
// 2 where log2(S) is odd.  A step of radix Q with span l (the product of the
// radices before it) and m = S / (Q l) computes, for j < m, k < l,
//     c_h = sum_i x[j l + k + i m l] w^(i h S / Q),   h < Q
//     y[(Q j + h) l + k] = c_h w^(h j l)
// (w^e for e >= S/2 is -w^(e - S/2)).  Each thread holds R elements of one
// column, slot q at position r + q S / R (r < S / R): a step of radix Q is
// R / Q of the DFTs above, each on slots b, b + R/Q, ..., computed in
// registers as a radix-2 decimation-in-frequency tree (one product for Q =
// 4) and followed by the Q - 1 independent products by w^(h j l) (none where
// the exponent is 0: the last step's).  So an S = 1024 pass is 5 exchanges
// through shared memory, each one read and one write per element and two
// barriers, against 10 stages with one butterfly per thread between
// barriers.  (Radix 8 ran slower on the H100: 64 registers of elements
// left 512 threads per SM and spilled.)
//
// Memory.  The tile's rows are G * 32 contiguous bytes in device memory; the
// block copies them in and out 16 bytes a thread, neighbouring threads on
// neighbouring addresses.  In shared memory an element is two 16-byte halves
// in two planes (limbs 0-3, limbs 4-7), element i of the tile (row s, column
// g: i = s G + g) at entry i + i / 8 of its plane: consecutive threads read
// consecutive entries, and the padding entry every 8 spreads a step's strided
// writes over the banks.  The twiddles come into shared memory once per
// block, in the same two planes, as w^e for every e < S (the upper half
// negated from the table's w^e, e < S/2).  The pre ladder is read from
// device memory into the thread's registers while the tile is copied in;
// the post ladder and the constant where they are applied, on the last
// step's store.
#pragma once
#include <stddef.h>

#include "field.cuh"

#define NTT_RADIX 4         // elements per thread (and the widest step)
#define NTT_THREADS 256     // the widest block

// 16 bytes: one vector access on the card, four words on the host.
ZK_HD void ntt_cp16(uint32_t *dst, const uint32_t *src) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4 *>(dst) = *reinterpret_cast<const uint4 *>(src);
#else
  for (int j = 0; j < 4; j++) dst[j] = src[j];
#endif
}

ZK_HD void ntt_ld(uint32_t v[8], const uint32_t *lo, const uint32_t *hi) {
#ifdef __CUDA_ARCH__
  const uint4 a = *reinterpret_cast<const uint4 *>(lo), b = *reinterpret_cast<const uint4 *>(hi);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
#else
  for (int j = 0; j < 4; j++) {
    v[j] = lo[j];
    v[4 + j] = hi[j];
  }
#endif
}

ZK_HD void ntt_st(uint32_t *lo, uint32_t *hi, const uint32_t v[8]) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4 *>(lo) = make_uint4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<uint4 *>(hi) = make_uint4(v[4], v[5], v[6], v[7]);
#else
  for (int j = 0; j < 4; j++) {
    lo[j] = v[j];
    hi[j] = v[4 + j];
  }
#endif
}

// Entry of tile element i in its plane (16-byte units): one padding entry
// after every 8.
ZK_HD int ntt_pad(int i) { return i + (i >> 3); }

// The shared-memory layout of a tile of E = S G elements, in 16-byte units:
// the high plane starts at hi_at() (4 entries past a multiple of 8, so that
// the copies' 8 consecutive threads, 4 low and 4 high halves, hit 8
// different bank groups), the twiddle planes (w^e for every e < S) at
// 2 hi_at() and 2 hi_at() + S.
struct NttLayout {
  int S, G;
  ZK_HD int hi_at() const {
    const int E = S * G;
    return (ntt_pad(E - 1) + 1 + 7) / 8 * 8 + 4;
  }
  ZK_HD int units() const { return 2 * hi_at() + 2 * S; }
};

// The pass's geometry on a card of `sms` SMs: R elements a thread and G
// columns a block.  R = min(4, S), halved (down to 2, and not below S /
// NTT_THREADS) while the pass would give fewer than NTT_FILL threads per SM:
// a small pass is latency-bound, and more threads with fewer elements each
// shorten it.  G is the largest power of two dividing IN with at most
// NTT_THREADS threads a block and at least 2 blocks per SM where the pass
// has that many columns.  Any geometry gives the same limbs.
#define NTT_FILL 512

struct NttGeometry {
  int R, G;
};

ZK_HD NttGeometry ntt_geometry(long long OUT, int S, int IN, int sms) {
  int R = S < NTT_RADIX ? S : NTT_RADIX;
  while (R > 2 && R > S / NTT_THREADS && OUT * S * IN / R < (long long)sms * NTT_FILL) R /= 2;
  int G = 1;
  while (S * G * 2 / R <= NTT_THREADS && IN % (G * 2) == 0 && OUT * IN / (G * 2) >= 2LL * sms)
    G *= 2;
  return {R, G};
}

// The radix of step `step` of an S-point pass with R = 2^logR elements a
// thread: R while log2(R) stages are left, then the rest (0 past the last).
ZK_HD int ntt_step_radix(int logS, int logR, int step) {
  const int left = logS - logR * step;
  return left <= 0 ? 0 : (1 << (left < logR ? left : logR));
}

// rev(h) over log2(Q) bits: where the in-register tree leaves c_h.
ZK_HD constexpr int ntt_bitrev(int h, int Q) {
  int r = 0;
  for (int q = Q; q > 1; q >>= 1, h >>= 1) r = (r << 1) | (h & 1);
  return r;
}

// w^e, 0 <= e < S, from the shared twiddle planes.
ZK_HD void ntt_twiddle(uint32_t w[8], const uint32_t *twlo, const uint32_t *twhi, int e) {
  ntt_ld(w, twlo + 4 * e, twhi + 4 * e);
}

// One step of radix Q on a thread's R slots: R / Q DFTs of size Q, then the
// products by w^(h j l).  r: the thread's row (< S / R); l = 2^logl: the
// step's span.
template <int R, int Q>
ZK_HD void ntt_step(uint32_t v[R][8], const uint32_t *twlo, const uint32_t *twhi, int S,
                    int logl, int r) {
  constexpr int NB = R / Q;  // DFTs per thread; DFT b takes slots b, b + NB, ...
#pragma unroll
  for (int b = 0; b < NB; b++) {
#pragma unroll
    for (int q = Q; q >= 2; q >>= 1) {  // decimation in frequency, natural in, bit-reversed out
#pragma unroll
      for (int g0 = 0; g0 < Q; g0 += q) {
#pragma unroll
        for (int i = 0; i < q / 2; i++) {
          uint32_t *a = v[b + (g0 + i) * NB], *c = v[b + (g0 + i + q / 2) * NB];
          uint32_t s[8], d[8];
          fp_add<Fr>(s, a, c);
          fp_sub<Fr>(d, a, c);
          fp_copy(a, s);
          if (i == 0) {
            fp_copy(c, d);
          } else {  // w^(i S / q): i S / q < S / 2
            uint32_t w[8];
            ntt_twiddle(w, twlo, twhi, i * (S / q));
            fp_mul<Fr>(c, d, w);
          }
        }
      }
    }
    const int j = (r + b * (S / R)) >> logl;
#pragma unroll
    for (int h = 1; h < Q; h++) {
      const int e = (h * j) << logl;
      if (e != 0) {
        uint32_t w[8];
        ntt_twiddle(w, twlo, twhi, e);
        uint32_t *c = v[b + ntt_bitrev(h, Q) * NB];
        fp_mul<Fr>(c, c, w);
      }
    }
  }
}

template <int R>
ZK_HD void ntt_step_any(uint32_t v[R][8], const uint32_t *twlo, const uint32_t *twhi, int S,
                        int logl, int r, int Q) {
  if (Q == 4) {
    if constexpr (R >= 4) ntt_step<R, 4>(v, twlo, twhi, S, logl, r);
  } else {
    ntt_step<R, 2>(v, twlo, twhi, S, logl, r);
  }
}

ZK_HD int ntt_log2(int n) {  // n a power of two
  int k = 0;
  while ((1 << k) < n) k++;
  return k;
}

// The pass over tile `tile` (o = tile / (IN / G), columns g0 = (tile % (IN /
// G)) G ..): x -> y, with the optional pre / post ladders ((S, IN) elements)
// and constant.  The block is `blk`: blk.B = S G / R threads, blk.each(f)
// calls f(t, v) for its threads t, v being thread t's R elements, and
// blk.sync() is the barrier between them.  `sm`: NttLayout{S, G}.units()
// 16-byte units of shared memory.
template <int R, class Block>
ZK_HD void ntt_tile(Block &blk, const uint32_t *__restrict__ x, uint32_t *__restrict__ y,
                    const uint32_t *__restrict__ tw, const uint32_t *__restrict__ pre,
                    const uint32_t *__restrict__ post, const uint32_t *__restrict__ cst, int S,
                    int IN, int G, long long tile, uint32_t *sm) {
  const NttLayout lay{S, G};
  uint32_t *lo = sm, *hi = sm + 4 * lay.hi_at();
  uint32_t *twlo = sm + 8 * lay.hi_at(), *twhi = twlo + 4 * S;
  const int B = blk.B, E = S * G, logS = ntt_log2(S), logG = ntt_log2(G);
  constexpr int logR = R == 4 ? 2 : 1;
  const long long o = tile / (IN / G);
  const int g0 = (int)(tile % (IN / G)) * G;
  // element (s, g) of the tile in device memory, in 32-bit words
  auto at = [&](int s, int g) { return ((size_t)(o * S + s) * IN + g0 + g) * 8; };
  auto ladder = [&](int s, int g) { return ((size_t)s * IN + g0 + g) * 8; };

  blk.each([&](int t, uint32_t(&v)[R][8]) {
    for (int c = t; c < 2 * E; c += B) {  // 16-byte chunk c = (row, column, half)
      const int s = c >> (logG + 1), g = (c >> 1) & (G - 1), half = c & 1;
      ntt_cp16((half ? hi : lo) + 4 * ntt_pad((s << logG) + g), x + at(s, g) + 4 * half);
    }
    for (int e = t; e < S; e += B) {  // w^e = -w^(e - S/2) for e >= S/2
      uint32_t w[8];
      const int i = e < S / 2 ? e : e - S / 2;
      ntt_ld(w, tw + 8 * i, tw + 8 * i + 4);
      if (e >= S / 2) fp_neg<Fr>(w, w);
      ntt_st(twlo + 4 * e, twhi + 4 * e, w);
    }
    if (pre != nullptr) {  // the thread's pre-ladder elements, fetched early
      const int r = t >> logG, g = t & (G - 1);
#pragma unroll
      for (int q = 0; q < R; q++) {
        const size_t i = ladder(r + q * (S / R), g);
        ntt_ld(v[q], pre + i, pre + i + 4);
      }
    }
  });
  blk.sync();
  for (int step = 0, logl = 0;; step++) {
    const int Q = ntt_step_radix(logS, logR, step), logQ = ntt_log2(Q);
    const bool first = step == 0, last = ntt_step_radix(logS, logR, step + 1) == 0;
    blk.each([&](int t, uint32_t(&v)[R][8]) {
      const int r = t >> logG, g = t & (G - 1);
#pragma unroll
      for (int q = 0; q < R; q++) {
        const int i = ntt_pad(((r + q * (S / R)) << logG) + g);
        if (first && pre != nullptr) {
          uint32_t a[8];
          ntt_ld(a, lo + 4 * i, hi + 4 * i);
          fp_mul<Fr>(v[q], a, v[q]);
        } else {
          ntt_ld(v[q], lo + 4 * i, hi + 4 * i);
        }
      }
      ntt_step_any<R>(v, twlo, twhi, S, logl, r, Q);
    });
    blk.sync();  // every thread has read the step's inputs
    blk.each([&](int t, uint32_t(&v)[R][8]) {
      const int r = t >> logG, g = t & (G - 1), logNB = logR - logQ;
      uint32_t c[8];
      if (last && cst != nullptr) ntt_ld(c, cst, cst + 4);
#pragma unroll
      for (int b = 0; b < R; b++) {  // slot b + NB rev(h) holds c_h of DFT b % NB
        const int d = b & ((1 << logNB) - 1), h = ntt_bitrev(b >> logNB, Q);
        const int rp = r + d * (S / R), j = rp >> logl, k = rp & ((1 << logl) - 1);
        const int s = (((j << logQ) + h) << logl) + k;
        if (last && post != nullptr) {
          uint32_t w[8];
          ntt_ld(w, post + ladder(s, g), post + ladder(s, g) + 4);
          fp_mul<Fr>(v[b], v[b], w);
        }
        if (last && cst != nullptr) fp_mul<Fr>(v[b], v[b], c);
        const int i = ntt_pad((s << logG) + g);
        ntt_st(lo + 4 * i, hi + 4 * i, v[b]);
      }
    });
    blk.sync();  // the step's outputs are in shared memory
    logl += logQ;
    if (last) break;
  }
  blk.each([&](int t, uint32_t(&)[R][8]) {  // copy out, as in
    for (int c = t; c < 2 * E; c += B) {
      const int s = c >> (logG + 1), g = (c >> 1) & (G - 1), half = c & 1;
      ntt_cp16(y + at(s, g) + 4 * half, (half ? hi : lo) + 4 * ntt_pad((s << logG) + g));
    }
  });
}
