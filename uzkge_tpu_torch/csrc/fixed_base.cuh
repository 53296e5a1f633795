// Per-lane arithmetic of the fixed-base table build over BN254 G1, as
// __host__ __device__ code on top of field.cuh.
//
// The kernels of fixed_base.cu and mont_mul.cu run one lane per thread
// through these functions; g++ compiles the same functions for the CPU test
// suite (tests/test_torch_field.py), which holds them against the JAX
// package's reference.  Elements are 8 x 32-bit little-endian limbs in
// Montgomery form; arrays of elements are contiguous (N, 8) rows.
#pragma once
#include <stddef.h>

#include "field.cuh"

// One element: 16-byte vector accesses on the card, plain loads on the host.
ZK_HD void ld_fp(uint32_t v[8], const uint32_t *p) {
#ifdef __CUDA_ARCH__
  const uint4 *q = reinterpret_cast<const uint4 *>(p);
  const uint4 a = q[0], b = q[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
#else
  for (int j = 0; j < 8; j++) v[j] = p[j];
#endif
}

ZK_HD void st_fp(uint32_t *p, const uint32_t v[8]) {
#ifdef __CUDA_ARCH__
  uint4 *q = reinterpret_cast<uint4 *>(p);
  q[0] = make_uint4(v[0], v[1], v[2], v[3]);
  q[1] = make_uint4(v[4], v[5], v[6], v[7]);
#else
  for (int j = 0; j < 8; j++) p[j] = v[j];
#endif
}

// ------------------------------------------------ inversion by safegcd
// a^-1 mod q by the Bernstein-Yang divsteps (eprint 2019/266) in the
// variable-time form of libsecp256k1's modinv32: signed 30-bit limbs (9 of
// them for the 254-bit q), 30 divsteps at a time on the low words of f and g
// with a 2x2 transition matrix, which then updates f, g and the Bezout
// coefficients d, e over all limbs with 32 x 32 -> 64-bit products.  About
// 18 such rounds (157 passes of the inner loop, on the average of 10^5
// random inputs), ~6000 instructions in all, replace the ~375 dependent
// Montgomery products (~225,000 instructions) of a Fermat power.  Variable
// time: the count of inner steps depends on the value, which is fine for the
// public curve coordinates this inverts; a warp waits for its slowest lane.

struct Fq30 {
  int32_t v[9];
};

ZK_HD int32_t fq30_modulus(int i) {  // q in signed 30-bit limbs
  const int32_t Q[9] = {0x187cfd47, 0x3082305b, 0x071ca8d3, 0x205aa45a, 0x01585d97,
                        0x0116da06, 0x1a029b85, 0x139cb84c, 0x00003064};
  return Q[i];
}

#define FQ30_QINV 0x1b799c77u  // q^-1 mod 2^30
#define FQ30_M30 0x3fffffff

ZK_HD int ctz32(uint32_t x) {  // x != 0
#ifdef __CUDA_ARCH__
  return __ffs((int)x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

// 30 divsteps on the low 30 bits of f (odd) and g from eta = -delta:
// returns the new eta and the transition matrix (u, v; q, r), scaled by 2^30,
// that maps (f, g) to their values after the steps.  Each pass of the loop
// skips g's trailing zeros, swaps (f, g) -> (g, -f) when eta < 0, then
// cancels up to 6 low bits of g with a multiple of f (-f^-1 mod 64 =
// f (f^2 - 2)): the same as that many single divsteps.
ZK_HD int32_t fq30_divsteps(int32_t eta, uint32_t f, uint32_t g, int32_t t[4]) {
  uint32_t u = 1, v = 0, q = 0, r = 1;
  int i = 30;
  for (;;) {
    const int zeros = ctz32(g | (0xffffffffu << i));
    g >>= zeros;
    u <<= zeros;
    v <<= zeros;
    eta -= zeros;
    i -= zeros;
    if (i == 0) break;
    if (eta < 0) {
      uint32_t tmp;
      eta = -eta;
      tmp = f; f = g; g = 0u - tmp;
      tmp = u; u = q; q = 0u - tmp;
      tmp = v; v = r; r = 0u - tmp;
    }
    const int limit = (eta + 1) > i ? i : (eta + 1);
    const uint32_t m = (0xffffffffu >> (32 - limit)) & 63u;
    const uint32_t w = (f * g * (f * f - 2u)) & m;
    g += f * w;
    q += u * w;
    r += v * w;
  }
  t[0] = (int32_t)u;
  t[1] = (int32_t)v;
  t[2] = (int32_t)q;
  t[3] = (int32_t)r;
  return eta;
}

// (d, e) <- (t [d, e] + q [md, me]) / 2^30, md and me chosen so that the
// division is exact and d, e stay in (-2q, q).
ZK_HD void fq30_update_de(Fq30 &d, Fq30 &e, const int32_t t[4]) {
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  const int32_t sd = d.v[8] >> 31, se = e.v[8] >> 31;
  int32_t md = (u & sd) + (v & se);
  int32_t me = (q & sd) + (r & se);
  int64_t cd = (int64_t)u * d.v[0] + (int64_t)v * e.v[0];
  int64_t ce = (int64_t)q * d.v[0] + (int64_t)r * e.v[0];
  md -= (int32_t)((FQ30_QINV * (uint32_t)cd + (uint32_t)md) & FQ30_M30);
  me -= (int32_t)((FQ30_QINV * (uint32_t)ce + (uint32_t)me) & FQ30_M30);
  cd += (int64_t)fq30_modulus(0) * md;
  ce += (int64_t)fq30_modulus(0) * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < 9; i++) {
    const int32_t di = d.v[i], ei = e.v[i];
    cd += (int64_t)u * di + (int64_t)v * ei + (int64_t)fq30_modulus(i) * md;
    ce += (int64_t)q * di + (int64_t)r * ei + (int64_t)fq30_modulus(i) * me;
    d.v[i - 1] = (int32_t)cd & FQ30_M30;
    cd >>= 30;
    e.v[i - 1] = (int32_t)ce & FQ30_M30;
    ce >>= 30;
  }
  d.v[8] = (int32_t)cd;
  e.v[8] = (int32_t)ce;
}

// (f, g) <- t [f, g] / 2^30 (exact).
ZK_HD void fq30_update_fg(Fq30 &f, Fq30 &g, const int32_t t[4]) {
  const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
  int64_t cf = (int64_t)u * f.v[0] + (int64_t)v * g.v[0];
  int64_t cg = (int64_t)q * f.v[0] + (int64_t)r * g.v[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < 9; i++) {
    const int32_t fi = f.v[i], gi = g.v[i];
    cf += (int64_t)u * fi + (int64_t)v * gi;
    cg += (int64_t)q * fi + (int64_t)r * gi;
    f.v[i - 1] = (int32_t)cf & FQ30_M30;
    cf >>= 30;
    g.v[i - 1] = (int32_t)cg & FQ30_M30;
    cg >>= 30;
  }
  f.v[8] = (int32_t)cf;
  g.v[8] = (int32_t)cg;
}

// d in (-2q, q) -> d * sign(f) mod q in [0, q), limbs back in [0, 2^30).
ZK_HD void fq30_normalize(Fq30 &d, int32_t fsign) {
  int32_t add = d.v[8] >> 31;
#pragma unroll
  for (int i = 0; i < 9; i++) d.v[i] += fq30_modulus(i) & add;
  const int32_t neg = fsign >> 31;
#pragma unroll
  for (int i = 0; i < 9; i++) d.v[i] = (d.v[i] ^ neg) - neg;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    d.v[i + 1] += d.v[i] >> 30;
    d.v[i] &= FQ30_M30;
  }
  add = d.v[8] >> 31;
#pragma unroll
  for (int i = 0; i < 9; i++) d.v[i] += fq30_modulus(i) & add;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    d.v[i + 1] += d.v[i] >> 30;
    d.v[i] &= FQ30_M30;
  }
}

// x^-1 mod q for 0 <= x < q as plain integers (0 for 0): divsteps rounds
// until g = 0.  All nine limbs of f and g stay in every round (modinv32
// drops top limbs as they empty): a fixed count keeps them in registers.
ZK_HD void fq_inv_int(uint32_t r[8], const uint32_t x[8]) {
  Fq30 d = {{0, 0, 0, 0, 0, 0, 0, 0, 0}}, e = {{1, 0, 0, 0, 0, 0, 0, 0, 0}}, f, g;
#pragma unroll
  for (int i = 0; i < 9; i++) {
    const int bit = 30 * i, w = bit >> 5, s = bit & 31;
    uint32_t lo = x[w] >> s;
    if (s && w + 1 < 8) lo |= x[w + 1] << (32 - s);
    g.v[i] = (int32_t)(lo & FQ30_M30);
    f.v[i] = fq30_modulus(i);
  }
  int32_t eta = -1, t[4], any;
  do {
    eta = fq30_divsteps(eta, (uint32_t)f.v[0], (uint32_t)g.v[0], t);
    fq30_update_de(d, e, t);
    fq30_update_fg(f, g, t);
    any = 0;
#pragma unroll
    for (int j = 0; j < 9; j++) any |= g.v[j];
  } while (any != 0);
  fq30_normalize(d, f.v[8]);
  uint64_t acc = 0;  // 30-bit limbs back to 32-bit ones: limb i + 1 ends in word i
  int bits = 0;
#pragma unroll
  for (int i = 0; i < 9; i++) {
    acc |= (uint64_t)(uint32_t)d.v[i] << bits;
    bits += 30;
    if (i > 0) {
      r[i - 1] = (uint32_t)acc;
      acc >>= 32;
      bits -= 32;
    }
  }
}

// Montgomery in and out: aR -> a^-1 R, as (aR)^-1 = a^-1 R^-1 times R^3 in
// one Montgomery product (R = 2^256).  0 -> 0.
ZK_HD void fq_inv_mont(uint32_t r[8], const uint32_t a[8]) {
  const uint32_t R3[8] = {0xda1530dfu, 0xb1cd6dafu, 0xa7283db6u, 0x62f210e6u,
                          0x0ada0afbu, 0xef7f0b0cu, 0x2d592544u, 0x20fd6e90u};
  uint32_t x[8];
  fq_inv_int(x, a);
  fp_mul<Fq>(r, x, R3);
}

// fb_bases, one base point: T = (x : y : 1); for each window w < W, emit T as
// row w (rows `rs` elements apart) of (ox, oy, oz), then double T c times, so
// that row w holds 2^(c*w) * P projectively.  The doubling is the complete
// projective addition T + T (RCB Alg. 7), as in the TPU's _bases_kernel,
// with its products in lockstep pairs (g1_dbl_ls: equal to g1_padd(T, T,
// T)).
ZK_HD void fb_bases_lane(const uint32_t *x, const uint32_t *y, uint32_t *ox, uint32_t *oy,
                         uint32_t *oz, int W, int c, size_t rs) {
  G1Proj T;
  ld_fp(T.x, x);
  ld_fp(T.y, y);
  for (int j = 0; j < 8; j++) T.z[j] = Fq::one(j);
  for (int w = 0; w < W; w++) {
    st_fp(ox + (size_t)w * rs * 8, T.x);
    st_fp(oy + (size_t)w * rs * 8, T.y);
    st_fp(oz + (size_t)w * rs * 8, T.z);
    if (w + 1 < W)
      for (int s = 0; s < c; s++) g1_dbl_ls<2>(T, T);
  }
}

// fb_mult_chunk, one (window, point) lane: T enters as m * B; emit T as row j
// (rows `rs` elements apart) of (ox, oy, oz), then T += B by the complete
// mixed addition (RCB Alg. 8, products in lockstep pairs: g1_madd_ls, equal
// to g1_madd), for j < CH; the advanced T = (m + CH) * B goes to (fx, fy, fz).
ZK_HD void fb_mult_chunk_lane(const uint32_t *tx, const uint32_t *ty, const uint32_t *tz,
                              const uint32_t *bx, const uint32_t *by, uint32_t *ox,
                              uint32_t *oy, uint32_t *oz, uint32_t *fx, uint32_t *fy,
                              uint32_t *fz, int CH, size_t rs) {
  G1Proj T;
  uint32_t Bx[8], By[8];
  ld_fp(T.x, tx);
  ld_fp(T.y, ty);
  ld_fp(T.z, tz);
  ld_fp(Bx, bx);
  ld_fp(By, by);
  for (int j = 0; j < CH; j++) {
    st_fp(ox + (size_t)j * rs * 8, T.x);
    st_fp(oy + (size_t)j * rs * 8, T.y);
    st_fp(oz + (size_t)j * rs * 8, T.z);
    g1_madd_ls<2>(T, T, Bx, By);
  }
  st_fp(fx, T.x);
  st_fp(fy, T.y);
  st_fp(fz, T.z);
}

// fq_batch_inv, forward sweep of the strided group {t, t + M, t + 2M, ...} of
// the N elements of `a`: running prefix products into `pref`, the group's
// product into acc.
ZK_HD void fq_inv_prefix_group(const uint32_t *a, uint32_t *pref, uint32_t acc[8], long long t,
                               long long M, long long N) {
  uint32_t v[8];
  ld_fp(acc, a + t * 8);
  st_fp(pref + t * 8, acc);
  for (long long i = t + M; i < N; i += M) {
    ld_fp(v, a + i * 8);
    fp_mul<Fq>(acc, acc, v);
    st_fp(pref + i * 8, acc);
  }
}

// fq_batch_inv, backward sweep of the same group, given inv = the inverse of
// its product: from the last member i down, out[i] = inv * pref[i - M] and
// inv *= a[i]; finally out[t] = inv.  Two multiplies per member.  `out` may
// be `pref` itself: pref[i] is last read one step before out[i] is written.
ZK_HD void fq_inv_back_group(const uint32_t *a, const uint32_t *pref, uint32_t inv[8],
                             uint32_t *out, long long t, long long M, long long N) {
  uint32_t p[8], v[8];
  for (long long i = t + ((N - 1 - t) / M) * M; i > t; i -= M) {
    ld_fp(p, pref + (i - M) * 8);
    ld_fp(v, a + i * 8);
    fp_mul<Fq>(p, inv, p);
    fp_mul<Fq>(inv, inv, v);
    st_fp(out + i * 8, p);
  }
  st_fp(out + t * 8, inv);
}

// fq_batch_inv, one level of the product tree down: group t's prefixes, and
// its product as element t of the next level (`prod`).
ZK_HD void fq_inv_down_lane(const uint32_t *a, uint32_t *pref, uint32_t *prod, long long t,
                            long long M, long long N) {
  uint32_t acc[8];
  fq_inv_prefix_group(a, pref, acc, t, M, N);
  st_fp(prod + t * 8, acc);
}

// fq_batch_inv, one level back up: group t's inverses from pinv[t], the
// inverse of its product that the level below computed.
ZK_HD void fq_inv_up_lane(const uint32_t *a, const uint32_t *pref, const uint32_t *pinv,
                          uint32_t *out, long long t, long long M, long long N) {
  uint32_t inv[8];
  ld_fp(inv, pinv + t * 8);
  fq_inv_back_group(a, pref, inv, out, t, M, N);
}

// fq_batch_inv, the last level in one lane: group t's prefixes, the inverse
// of its product by fq_inv_mont, its members' inverses into out (which may
// be pref).
ZK_HD void fq_inv_root_lane(const uint32_t *a, uint32_t *pref, uint32_t *out, long long t,
                            long long M, long long N) {
  uint32_t acc[8];
  fq_inv_prefix_group(a, pref, acc, t, M, N);
  fq_inv_mont(acc, acc);
  fq_inv_back_group(a, pref, acc, out, t, M, N);
}
