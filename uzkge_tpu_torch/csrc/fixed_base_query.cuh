// Per-lane arithmetic of the fixed-base query over BN254 G1 (the MSM over the
// table of msm/fixed_base.py), as __host__ __device__ code on top of
// fixed_base.cuh.
//
// The kernels of fixed_base_query.cu run one leaf or pair per thread through
// these functions (fb_fold: a block per tile through fb_fold_tile); g++
// compiles the same functions for the CPU test suite (tests/test_torch_field.py), which holds
// them against the JAX package's kernel bodies.  Elements are 8 x 32-bit little-endian limbs in
// Fq Montgomery form; identity flags and pair flags are int32.
#pragma once

#include "fixed_base.cuh"

// Pair flags of one level of the batch-affine tree, the TPU kernels' bits.
#define FB_INF1 1  // the pair's first point is the identity
#define FB_INF2 2  // its second point is the identity
#define FB_BAD 4   // x1 == x2 with neither the identity: doubling or cancellation

ZK_HD bool fp_is_zero(const uint32_t a[8]) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) acc |= a[j];
  return acc == 0;
}

// fb_select, leaf t = p * K + k of P MSMs: the table row of digit d =
// digits[t], read from leaf k's own block of D rows (x || y, 16 words a row),
// y negated for d < 0; inf = (d == 0).  A digit outside [-D, D] \ {0} reads
// row 0 as the TPU's where-chain does (d = 0 carries row 0's values too).
ZK_HD void fb_select_lane(const uint32_t *table, const int32_t *digits, uint32_t *x, uint32_t *y,
                          int32_t *inf, long long t, long long K, int D) {
  const int d = digits[t];
  const int mag = d < 0 ? -d : d;
  const uint32_t *row = table + ((size_t)(t % K) * D + (mag >= 1 && mag <= D ? mag - 1 : 0)) * 16;
  uint32_t xv[8], yv[8];
  ld_fp(xv, row);
  ld_fp(yv, row + 8);
  if (d < 0) fp_neg<Fq>(yv, yv);
  st_fp(x + t * 8, xv);
  st_fp(y + t * 8, yv);
  inf[t] = d == 0;
}

// Pair t = p * H + j of a level over P MSMs of 2H points pairs point j of
// MSM p with point j + H: the index of point j in the (P, 2H) arrays.
ZK_HD long long fb_pair_first(long long t, long long H) { return t + (t / H) * H; }

// fb_pair_den, pair t: den = x2 - x1, or 1 where a side is the identity or
// x1 == x2 (so that the batch inversion stays valid), and the pair's flags.
ZK_HD void fb_pair_den_lane(const uint32_t *x, const int32_t *inf, uint32_t *den, int32_t *flags,
                            long long t, long long H) {
  const long long i = fb_pair_first(t, H);
  uint32_t a[8], b[8], d[8];
  ld_fp(a, x + i * 8);
  ld_fp(b, x + (i + H) * 8);
  fp_sub<Fq>(d, b, a);
  const bool i1 = inf[i] != 0, i2 = inf[i + H] != 0;
  const bool bad = fp_is_zero(d) && !i1 && !i2;
  if (i1 || i2 || bad)
    for (int j = 0; j < 8; j++) d[j] = Fq::one(j);
  st_fp(den + t * 8, d);
  flags[t] = (i1 ? FB_INF1 : 0) | (i2 ? FB_INF2 : 0) | (bad ? FB_BAD : 0);
}

// fb_pair_combine, one pair: the affine sum with lambda = (y2 - y1) * dinv,
// x3 = lambda^2 - x1 - x2, y3 = lambda * (x1 - x3) - y1.  The flags pass an
// identity side through (P1 + O = P1, O + P2 = P2), and a degenerate pair
// (x1 == x2) becomes the identity, keeping x3, y3 as computed: a doubling or
// cancellation between SRS multiples needs a discrete-log relation and comes
// by chance with probability ~2^-254.  Returns the pair's identity flag.
ZK_HD int32_t fb_pair_combine_pair(const uint32_t x1[8], const uint32_t x2[8],
                                   const uint32_t y1[8], const uint32_t y2[8],
                                   const uint32_t dinv[8], int32_t f, uint32_t xo[8],
                                   uint32_t yo[8]) {
  uint32_t lam[8], u[8], x3[8], y3[8];
  fp_sub<Fq>(lam, y2, y1);
  fp_mul<Fq>(lam, lam, dinv);
  fp_mul<Fq>(u, lam, lam);
  fp_sub<Fq>(u, u, x1);
  fp_sub<Fq>(x3, u, x2);
  fp_sub<Fq>(u, x1, x3);
  fp_mul<Fq>(u, lam, u);
  fp_sub<Fq>(y3, u, y1);
  const bool i1 = (f & FB_INF1) != 0, i2 = (f & FB_INF2) != 0, bad = (f & FB_BAD) != 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {  // limb by limb: no array is picked by pointer
    xo[j] = i2 ? x1[j] : (i1 ? x2[j] : x3[j]);
    yo[j] = i2 ? y1[j] : (i1 ? y2[j] : y3[j]);
  }
  return (i1 && i2) || bad;
}

// fb_pair_combine, pair t of the (P, 2H) arrays (what the g++ suite calls; the
// kernel reads the same operands from its shared-memory tiles).
ZK_HD void fb_pair_combine_lane(const uint32_t *x, const uint32_t *y, const uint32_t *dinv,
                                const int32_t *flags, uint32_t *xo, uint32_t *yo, int32_t *info,
                                long long t, long long H) {
  const long long i = fb_pair_first(t, H);
  uint32_t x1[8], x2[8], y1[8], y2[8], u[8], ox[8], oy[8];
  ld_fp(x1, x + i * 8);
  ld_fp(x2, x + (i + H) * 8);
  ld_fp(y1, y + i * 8);
  ld_fp(y2, y + (i + H) * 8);
  ld_fp(u, dinv + t * 8);
  info[t] = fb_pair_combine_pair(x1, x2, y1, y2, u, flags[t], ox, oy);
  st_fp(xo + t * 8, ox);
  st_fp(yo + t * 8, oy);
}

#define FB_FOLD_TILE 512     // the largest tile: 8^3 points
#define FB_FOLD_THREADS 256  // the widest block

// fb_fold: the width of the next fold of n points: 8-to-1 while 8 divides n
// (the TPU's _fold8 levels), then the 2 or 4 left in one halving tree (the
// XLA remainder).
ZK_HD int fb_fold_width(long long n) { return n % 8 == 0 ? 8 : (int)n; }

// fb_fold, pair q of one halving step over points in groups of w = 2h: the
// complete projective addition (RCB Alg. 7) of point g*w + j and point
// g*w + j + h of (X, Y, Z), g = q / h and j = q % h, left operand first, into
// `out`.  The step's sums are point q of the next, in groups of h; log2(w)
// steps make each group of w one point, whose tree over the group's even
// members is its left operand and the odd members' its right, as in the
// TPU's _fold8_kernel: G(a, s, W) = G(a, 2s, W/2) + G(a + s, 2s, W/2).
ZK_HD void fb_fold_pair(G1Proj &out, const uint32_t *X, const uint32_t *Y, const uint32_t *Z,
                        long long q, int h) {
  const long long i = (q / h) * 2 * h + q % h;
  G1Proj a, b;
  ld_fp(a.x, X + i * 8);
  ld_fp(a.y, Y + i * 8);
  ld_fp(a.z, Z + i * 8);
  ld_fp(b.x, X + (i + h) * 8);
  ld_fp(b.y, Y + (i + h) * 8);
  ld_fp(b.z, Z + (i + h) * 8);
  g1_padd(out, a, b);
}

ZK_HD void st_point(uint32_t *X, uint32_t *Y, uint32_t *Z, long long q, const G1Proj &p) {
  st_fp(X + q * 8, p.x);
  st_fp(Y + q * 8, p.y);
  st_fp(Z + q * 8, p.z);
}

// fb_fold, one tile: block `tile` folds points tile*T .. tile*T + T - 1 of
// (X, Y, Z) (T a power of two) to point `tile` of (oX, oY, oZ), by halving
// steps of fb_fold_width.  The block is `blk`: blk.B threads, blk.each(f)
// calls f(t, r) for its threads t, r being thread t's point, and blk.sync()
// is the barrier between them.  On the card each thread runs this with
// each() calling f for itself alone (fb_fold_kernel); the CPU suite runs it
// once per block with each() looping over t and a no-op sync().  In each
// step thread t adds pairs t, t + B, ...: the first step from (X, Y, Z),
// later ones from the T / 2 sums in (sX, sY, sZ), each round of B pairs read
// before a barrier and stored after it (pair q reads points >= q, so a
// round's sums land below the next round's inputs).
template <class Block>
ZK_HD void fb_fold_tile(Block &blk, const uint32_t *__restrict__ X,
                        const uint32_t *__restrict__ Y, const uint32_t *__restrict__ Z,
                        uint32_t *sX, uint32_t *sY, uint32_t *sZ, uint32_t *__restrict__ oX,
                        uint32_t *__restrict__ oY, uint32_t *__restrict__ oZ, long long tile,
                        int T) {
  const long long base = tile * T * 8;
  const int B = blk.B;
  int n = T, w = fb_fold_width(T);
  blk.each([&](int t, G1Proj &r) {  // the first step: no one reads (sX, sY, sZ) yet
    for (int q = t; q < n / 2; q += B) {
      fb_fold_pair(r, X + base, Y + base, Z + base, q, w / 2);
      if (n > 2) st_point(sX, sY, sZ, q, r);
    }
  });
  for (;;) {
    n /= 2;  // the points left, in (sX, sY, sZ) unless n == 1 (thread 0's r)
    w /= 2;
    if (w == 1) w = fb_fold_width(n);
    if (n == 1) break;
    blk.sync();
    for (int q0 = 0; q0 < n / 2; q0 += B) {
      blk.each([&](int t, G1Proj &r) {
        if (q0 + t < n / 2) fb_fold_pair(r, sX, sY, sZ, q0 + t, w / 2);
      });
      blk.sync();
      blk.each([&](int t, G1Proj &r) {
        if (q0 + t < n / 2 && n > 2) st_point(sX, sY, sZ, q0 + t, r);
      });
    }
  }
  blk.each([&](int t, G1Proj &r) {
    if (t == 0) st_point(oX, oY, oZ, tile, r);
  });
}

// The CUDA block as fb_fold_tile sees it: the calling thread and its point
// (fb_fold_kernel, and scan_proj_reduce_kernel in scan_reduce.cu).
struct FoldBlock {
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
