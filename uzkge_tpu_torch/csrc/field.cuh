// BN254 Fr / Fq Montgomery arithmetic and G1 complete additions over 8 x 32-bit
// little-endian limbs, as __host__ __device__ code.
//
// Replaces ff/pallas_rows.py::RowCtx (mul / add / sub / neg): the in-kernel
// field library of every TPU kernel.  There it is a delayed-carry CIOS over
// 16 x 16-bit limbs, because the TPU's vector unit has no 32x32->64-bit
// product; here it is a CIOS over 32-bit limbs with 64-bit products.  Both
// compute a*b*R^-1 mod p with R = 2^256 and return canonical values (< p),
// so results agree bit for bit with the JAX package.
//
// The header has no CUDA dependency: g++ compiles it too, so the CPU test
// suite runs the kernels' own arithmetic (tests/test_torch_field.py).
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define ZK_HD __host__ __device__ __forceinline__
#else
#define ZK_HD inline
#endif

// Modulus traits: p and -p^-1 mod 2^32; Fq also R mod q.
struct Fr {
  ZK_HD static uint32_t p(int i) {
    const uint32_t P[8] = {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
                           0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return P[i];
  }
  ZK_HD static uint32_t inv() { return 0xefffffffu; }
};

struct Fq {
  ZK_HD static uint32_t p(int i) {
    const uint32_t P[8] = {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
                           0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u};
    return P[i];
  }
  ZK_HD static uint32_t inv() { return 0xe4866389u; }
  ZK_HD static uint32_t one(int i) {  // R mod q: the Montgomery form of 1
    const uint32_t O[8] = {0xc58f0d9du, 0xd35d438du, 0xf5c70b3du, 0x0a78eb28u,
                           0x7879462cu, 0x666ea36fu, 0x9a07df2fu, 0x0e0a77c1u};
    return O[i];
  }
};

// r = t - p if (hi, t) >= p else t, for t < 2p.
template <class F>
ZK_HD void fp_reduce_once(uint32_t r[8], const uint32_t t[8], uint32_t hi) {
  uint32_t d[8];
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    uint64_t v = (uint64_t)t[j] - F::p(j) - borrow;
    d[j] = (uint32_t)v;
    borrow = (v >> 32) & 1;
  }
  bool take = hi != 0 || borrow == 0;
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = take ? d[j] : t[j];
}

template <class F>
ZK_HD void fp_add(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t s[8];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    c += (uint64_t)a[j] + b[j];
    s[j] = (uint32_t)c;
    c >>= 32;
  }
  fp_reduce_once<F>(r, s, (uint32_t)c);
}

template <class F>
ZK_HD void fp_sub(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t d[8];
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    uint64_t v = (uint64_t)a[j] - b[j] - borrow;
    d[j] = (uint32_t)v;
    borrow = (v >> 32) & 1;
  }
  uint32_t mask = borrow ? 0xffffffffu : 0u;  // add p back on a borrow
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) {
    c += (uint64_t)d[j] + (F::p(j) & mask);
    r[j] = (uint32_t)c;
    c >>= 32;
  }
}

template <class F>
ZK_HD void fp_neg(uint32_t r[8], const uint32_t a[8]) {
  const uint32_t z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  fp_sub<F>(r, z, a);
}

// CIOS Montgomery multiplication: r = a * b * 2^-256 mod p for a, b < p
// (canonical inputs, as every kernel keeps them).  r may alias a/b.
//
// Word i of b at a time: T += a * b[i]; m = T[0] * (-p^-1); T = (T + m p) /
// 2^32, with 32 x 32 -> 64-bit products (one IMAD.WIDE each on the card).
// T is nine words, never ten: both BN254 moduli have a top limb below 2^30,
// so p < 2^254.  By induction T < 2p < 2^255 at the start of each round
// (T = 0 first; then (T + a * b[i] + m * p) / 2^32 < (2p + (2^32 - 1) p +
// (2^32 - 1) p) / 2^32 < 2p, using a < p).  Inside a round T + a * b[i] +
// m * p < 2p + 2^33 p < 2^288: nine words hold it, so the carry out of the
// ninth word is always 0 and the textbook CIOS's tenth word drops out; and
// T < 2^255 leaves the ninth word 0 at the end of a round.  The result
// T < 2p takes one conditional subtraction.  This form is the card's one
// Montgomery product: a PTX form with mad.lo.cc / madc.hi.cc carry chains
// was measured beside it on the H100 and ran slower inside the kernels
// (PERF.md).
//
// One fp_mul is one dependency chain through its carries.  Where a formula
// has independent products, fp_mul_n below issues N of them word by word in
// lockstep, and fp_sqr_n squares with fewer word products (the table
// build's fb_bases and fb_mult_chunk do, through g1_dbl_ls / g1_madd_ls in
// pairs; every other kernel calls fp_mul).  ptxas already interleaves the
// independent fp_mul calls of an unrolled formula: in the SASS of g1_padd
// and g1_madd (sm_90a) almost no multiply-add reads the result of the
// instruction just before it.  So the lockstep buys little: pairs ran
// 1.5 % (fb_bases) and 3 % (fb_mult_chunk) faster than one product at a
// time on an H100 80GB HBM3 at 700 W, where these kernels are bound by the
// count of instructions issued (PERF.md).
template <class F>
ZK_HD void fp_mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t t[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c += (uint64_t)a[j] * b[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    t[8] = (uint32_t)c;  // T < 2^255 before the round: t[8] was 0
    uint32_t m = t[0] * F::inv();
    c = ((uint64_t)m * F::p(0) + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      c += (uint64_t)m * F::p(j) + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    t[7] = (uint32_t)(c + t[8]);  // < 2^32: T < 2^255 after the round
  }
  fp_reduce_once<F>(r, t, 0);
}

// N independent products in lockstep: r[k] = a[k] * b[k] * 2^-256 mod p for
// k < N.  Each product runs fp_mul's CIOS rounds on the same words, so each
// r[k] equals fp_mul(a[k], b[k]) limb for limb; only the order in which the N
// products' instructions are issued differs.  A round runs over the word j
// of a with the product k innermost, so neighbouring multiply-adds belong to
// different products and none waits on its neighbour's carry.  All of a and
// b is read before r is written, so r may alias any of them.
template <class F, int N>
ZK_HD void fp_mul_n(uint32_t r[][8], const uint32_t a[][8], const uint32_t b[][8]) {
  uint32_t t[N][9];
  uint64_t c[N];
#pragma unroll
  for (int k = 0; k < N; k++)
#pragma unroll
    for (int j = 0; j < 9; j++) t[k][j] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
#pragma unroll
    for (int k = 0; k < N; k++) c[k] = 0;
#pragma unroll
    for (int j = 0; j < 8; j++)
#pragma unroll
      for (int k = 0; k < N; k++) {
        c[k] += (uint64_t)a[k][j] * b[k][i] + t[k][j];
        t[k][j] = (uint32_t)c[k];
        c[k] >>= 32;
      }
    uint32_t m[N];
#pragma unroll
    for (int k = 0; k < N; k++) {
      t[k][8] = (uint32_t)c[k];
      m[k] = t[k][0] * F::inv();
      c[k] = ((uint64_t)m[k] * F::p(0) + t[k][0]) >> 32;
    }
#pragma unroll
    for (int j = 1; j < 8; j++)
#pragma unroll
      for (int k = 0; k < N; k++) {
        c[k] += (uint64_t)m[k] * F::p(j) + t[k][j];
        t[k][j - 1] = (uint32_t)c[k];
        c[k] >>= 32;
      }
#pragma unroll
    for (int k = 0; k < N; k++) t[k][7] = (uint32_t)(c[k] + t[k][8]);
  }
#pragma unroll
  for (int k = 0; k < N; k++) fp_reduce_once<F>(r[k], t[k], 0);
}

// N independent Montgomery squarings in lockstep: r[k] = a[k]^2 * 2^-256 mod
// p.  The square is formed whole first, 36 word products instead of 64 (the
// 28 products a_i a_j with i < j, doubled by a shift, plus the 8 a_i^2), into
// 16 words; then 8 rounds of word-by-word reduction (T += m p 2^(32 i), m =
// T_i (-p^-1) mod 2^32) clear the low half, 64 more products.  T < p^2 +
// 2^256 p < 2^511 throughout, and the high half ends below 2p: one
// conditional subtraction leaves the canonical a^2 R^-1, which is fp_mul(a,
// a) limb for limb.  Loops as in fp_mul_n, the product k innermost; r may
// alias a.
template <class F, int N>
ZK_HD void fp_sqr_n(uint32_t r[][8], const uint32_t a[][8]) {
  uint32_t t[N][16];
  uint64_t c[N];
#pragma unroll
  for (int k = 0; k < N; k++)
#pragma unroll
    for (int j = 0; j < 16; j++) t[k][j] = 0;
#pragma unroll
  for (int i = 0; i < 7; i++) {  // row i: a_i a_j for j > i into words i + j
#pragma unroll
    for (int k = 0; k < N; k++) c[k] = 0;
#pragma unroll
    for (int j = i + 1; j < 8; j++)
#pragma unroll
      for (int k = 0; k < N; k++) {
        c[k] += (uint64_t)a[k][i] * a[k][j] + t[k][i + j];
        t[k][i + j] = (uint32_t)c[k];
        c[k] >>= 32;
      }
#pragma unroll
    for (int k = 0; k < N; k++) t[k][i + 8] = (uint32_t)c[k];  // not yet written
  }
#pragma unroll
  for (int k = 0; k < N; k++) {  // double: the cross terms are below 2^507
#pragma unroll
    for (int j = 15; j > 0; j--) t[k][j] = (t[k][j] << 1) | (t[k][j - 1] >> 31);
    t[k][0] <<= 1;
    c[k] = 0;
  }
#pragma unroll
  for (int i = 0; i < 8; i++)  // the diagonal a_i^2 into words 2i, 2i + 1
#pragma unroll
    for (int k = 0; k < N; k++) {
      const uint64_t d = (uint64_t)a[k][i] * a[k][i];
      c[k] += (uint64_t)t[k][2 * i] + (uint32_t)d;
      t[k][2 * i] = (uint32_t)c[k];
      c[k] >>= 32;
      c[k] += (uint64_t)t[k][2 * i + 1] + (d >> 32);
      t[k][2 * i + 1] = (uint32_t)c[k];
      c[k] >>= 32;
    }
  uint32_t hi[N];  // the carry into word i + 8 left by round i - 1
#pragma unroll
  for (int k = 0; k < N; k++) hi[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint32_t m[N];
#pragma unroll
    for (int k = 0; k < N; k++) {
      m[k] = t[k][i] * F::inv();
      c[k] = ((uint64_t)m[k] * F::p(0) + t[k][i]) >> 32;
    }
#pragma unroll
    for (int j = 1; j < 8; j++)
#pragma unroll
      for (int k = 0; k < N; k++) {
        c[k] += (uint64_t)m[k] * F::p(j) + t[k][i + j];
        t[k][i + j] = (uint32_t)c[k];
        c[k] >>= 32;
      }
#pragma unroll
    for (int k = 0; k < N; k++) {
      c[k] += (uint64_t)t[k][i + 8] + hi[k];
      t[k][i + 8] = (uint32_t)c[k];
      hi[k] = (uint32_t)(c[k] >> 32);
    }
  }
#pragma unroll
  for (int k = 0; k < N; k++) fp_reduce_once<F>(r[k], t[k] + 8, 0);  // hi[k] is 0: T < 2^511
}

// N independent products issued in lockstep groups of at most G: G = N is
// one group, G = 1 is fp_mul after fp_mul.  A narrower group holds fewer
// products' words in registers at once.
template <class F, int N, int G>
ZK_HD void fp_mul_groups(uint32_t r[][8], const uint32_t a[][8], const uint32_t b[][8]) {
  constexpr int H = G < N ? G : N;
  fp_mul_n<F, H>(r, a, b);
  if constexpr (N > H) fp_mul_groups<F, N - H, G>(r + H, a + H, b + H);
}

template <class F, int N, int G>
ZK_HD void fp_sqr_groups(uint32_t r[][8], const uint32_t a[][8]) {
  constexpr int H = G < N ? G : N;
  fp_sqr_n<F, H>(r, a);
  if constexpr (N > H) fp_sqr_groups<F, N - H, G>(r + H, a + H);
}

ZK_HD void fp_copy(uint32_t r[8], const uint32_t a[8]) {
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = a[j];
}

// r = 9a = 8a + a by three doublings and an addition: the product by b3 = 3b
// = 9 of the curve formulas without a Montgomery product.  Every step is a
// canonical fp_add, so r equals a * (9R) * R^-1 limb for limb.  r may alias a.
template <class F>
ZK_HD void fp_mul9(uint32_t r[8], const uint32_t a[8]) {
  uint32_t t[8];
  fp_add<F>(t, a, a);
  fp_add<F>(t, t, t);
  fp_add<F>(t, t, t);
  fp_add<F>(r, t, a);
}

// ---------------------------------------------------------------- G1 over Fq
// Projective (X : Y : Z); the identity is (0 : 1 : 0).  Complete formulas of
// Renes-Costello-Batina (eprint 2015/1060) for a = 0, b3 = 9: no branches for
// the identity or for doubling, as in msm/msm.py::_madd / _padd.  The two
// products by b3 of each formula are fp_mul9, so a mixed addition costs 11
// Montgomery products and a projective one 12.

struct G1Proj {
  uint32_t x[8], y[8], z[8];
};

ZK_HD void g1_set_identity(G1Proj &p) {
#pragma unroll
  for (int j = 0; j < 8; j++) {
    p.x[j] = 0;
    p.y[j] = Fq::one(j);
    p.z[j] = 0;
  }
}

// RCB Alg. 8: projective + affine (x2, y2).  `out` may alias `p`.
ZK_HD void g1_madd(G1Proj &out, const G1Proj &p, const uint32_t x2[8],
                   const uint32_t y2[8]) {
  uint32_t t0[8], t1[8], t2[8], t3[8], t4[8], X3[8], Y3[8], Z3[8];
  fp_mul<Fq>(t0, p.x, x2);
  fp_mul<Fq>(t1, p.y, y2);
  fp_add<Fq>(t3, x2, y2);
  fp_add<Fq>(t4, p.x, p.y);
  fp_mul<Fq>(t3, t3, t4);
  fp_add<Fq>(t4, t0, t1);
  fp_sub<Fq>(t3, t3, t4);
  fp_mul<Fq>(t4, y2, p.z);
  fp_add<Fq>(t4, t4, p.y);
  fp_mul<Fq>(Y3, x2, p.z);
  fp_add<Fq>(Y3, Y3, p.x);
  fp_add<Fq>(X3, t0, t0);
  fp_add<Fq>(t0, X3, t0);
  fp_mul9<Fq>(t2, p.z);
  fp_add<Fq>(Z3, t1, t2);
  fp_sub<Fq>(t1, t1, t2);
  fp_mul9<Fq>(Y3, Y3);
  fp_mul<Fq>(X3, t4, Y3);
  fp_mul<Fq>(t2, t3, t1);
  fp_sub<Fq>(X3, t2, X3);
  fp_mul<Fq>(Y3, Y3, t0);
  fp_mul<Fq>(t1, t1, Z3);
  fp_add<Fq>(Y3, t1, Y3);
  fp_mul<Fq>(t0, t0, t3);
  fp_mul<Fq>(Z3, Z3, t4);
  fp_add<Fq>(Z3, Z3, t0);
  fp_copy(out.x, X3);
  fp_copy(out.y, Y3);
  fp_copy(out.z, Z3);
}

// RCB Alg. 7: projective + projective.  `out` may alias either input.
ZK_HD void g1_padd(G1Proj &out, const G1Proj &p, const G1Proj &q) {
  uint32_t t0[8], t1[8], t2[8], t3[8], t4[8], X3[8], Y3[8], Z3[8];
  fp_mul<Fq>(t0, p.x, q.x);
  fp_mul<Fq>(t1, p.y, q.y);
  fp_mul<Fq>(t2, p.z, q.z);
  fp_add<Fq>(t3, p.x, p.y);
  fp_add<Fq>(t4, q.x, q.y);
  fp_mul<Fq>(t3, t3, t4);
  fp_add<Fq>(t4, t0, t1);
  fp_sub<Fq>(t3, t3, t4);
  fp_add<Fq>(t4, p.y, p.z);
  fp_add<Fq>(X3, q.y, q.z);
  fp_mul<Fq>(t4, t4, X3);
  fp_add<Fq>(X3, t1, t2);
  fp_sub<Fq>(t4, t4, X3);
  fp_add<Fq>(X3, p.x, p.z);
  fp_add<Fq>(Y3, q.x, q.z);
  fp_mul<Fq>(X3, X3, Y3);
  fp_add<Fq>(Y3, t0, t2);
  fp_sub<Fq>(Y3, X3, Y3);
  fp_add<Fq>(X3, t0, t0);
  fp_add<Fq>(t0, X3, t0);
  fp_mul9<Fq>(t2, t2);
  fp_add<Fq>(Z3, t1, t2);
  fp_sub<Fq>(t1, t1, t2);
  fp_mul9<Fq>(Y3, Y3);
  fp_mul<Fq>(X3, t4, Y3);
  fp_mul<Fq>(t2, t3, t1);
  fp_sub<Fq>(X3, t2, X3);
  fp_mul<Fq>(Y3, Y3, t0);
  fp_mul<Fq>(t1, t1, Z3);
  fp_add<Fq>(Y3, t1, Y3);
  fp_mul<Fq>(t0, t0, t3);
  fp_mul<Fq>(Z3, Z3, t4);
  fp_add<Fq>(Z3, Z3, t0);
  fp_copy(out.x, X3);
  fp_copy(out.y, Y3);
  fp_copy(out.z, Z3);
}

// ------------------------------------------- G1 with products in lockstep
// The same RCB formulas with each stage's mutually independent products
// issued together through fp_mul_groups (groups of at most G; G = 1 issues
// them one by one).  Every addition, subtraction and fp_mul9 is g1_padd's /
// g1_madd's on the same values, and each product returns the canonical
// a*b*R^-1 whatever the schedule, so the outputs equal theirs limb for limb.

// The second stage that Alg. 7 and Alg. 8 share, from the first stage's
// values t0 = 3 X1 X2, t1 = Y1 Y2 - b3 Z1 Z2, t3, t4, Y3 = b3 (...), Z3 =
// Y1 Y2 + b3 Z1 Z2: six independent products, then X3 = t3 t1 - t4 Y3,
// Y3 = t1 Z3 + Y3 t0, Z3 = Z3 t4 + t0 t3.
template <int G>
ZK_HD void g1_rcb_tail_ls(G1Proj &out, const uint32_t t0[8], const uint32_t t1[8],
                          const uint32_t t3[8], const uint32_t t4[8], const uint32_t Y3[8],
                          const uint32_t Z3[8]) {
  uint32_t a[6][8], b[6][8], r[6][8];
  fp_copy(a[0], t4); fp_copy(b[0], Y3);
  fp_copy(a[1], t3); fp_copy(b[1], t1);
  fp_copy(a[2], Y3); fp_copy(b[2], t0);
  fp_copy(a[3], t1); fp_copy(b[3], Z3);
  fp_copy(a[4], t0); fp_copy(b[4], t3);
  fp_copy(a[5], Z3); fp_copy(b[5], t4);
  fp_mul_groups<Fq, 6, G>(r, a, b);
  fp_sub<Fq>(out.x, r[1], r[0]);
  fp_add<Fq>(out.y, r[3], r[2]);
  fp_add<Fq>(out.z, r[5], r[4]);
}

// RCB Alg. 7 with P = Q: out = 2p, equal to g1_padd(out, p, p) limb for
// limb.  First stage: the six Montgomery squarings X^2, Y^2, Z^2, (X+Y)^2,
// (Y+Z)^2, (X+Z)^2; then the shared tail.  `out` may alias `p`.
template <int G>
ZK_HD void g1_dbl_ls(G1Proj &out, const G1Proj &p) {
  uint32_t s[6][8], q[6][8];
  fp_copy(s[0], p.x);
  fp_copy(s[1], p.y);
  fp_copy(s[2], p.z);
  fp_add<Fq>(s[3], p.x, p.y);
  fp_add<Fq>(s[4], p.y, p.z);
  fp_add<Fq>(s[5], p.x, p.z);
  fp_sqr_groups<Fq, 6, G>(q, s);
  uint32_t t0[8], t1[8], t2[8], t3[8], t4[8], u[8], Y3[8], Z3[8];
  fp_add<Fq>(u, q[0], q[1]);
  fp_sub<Fq>(t3, q[3], u);  // 2XY
  fp_add<Fq>(u, q[1], q[2]);
  fp_sub<Fq>(t4, q[4], u);  // 2YZ
  fp_add<Fq>(u, q[0], q[2]);
  fp_sub<Fq>(Y3, q[5], u);  // 2XZ
  fp_add<Fq>(u, q[0], q[0]);
  fp_add<Fq>(t0, u, q[0]);
  fp_mul9<Fq>(t2, q[2]);
  fp_add<Fq>(Z3, q[1], t2);
  fp_sub<Fq>(t1, q[1], t2);
  fp_mul9<Fq>(Y3, Y3);
  g1_rcb_tail_ls<G>(out, t0, t1, t3, t4, Y3, Z3);
}

// RCB Alg. 8 (projective + affine (x2, y2)), equal to g1_madd limb for limb:
// the five first-stage products X1 x2, Y1 y2, (x2+y2)(X1+Y1), y2 Z1, x2 Z1,
// then the shared tail.  `out` may alias `p`.
template <int G>
ZK_HD void g1_madd_ls(G1Proj &out, const G1Proj &p, const uint32_t x2[8], const uint32_t y2[8]) {
  uint32_t a[5][8], b[5][8], q[5][8];
  fp_copy(a[0], p.x); fp_copy(b[0], x2);
  fp_copy(a[1], p.y); fp_copy(b[1], y2);
  fp_add<Fq>(a[2], x2, y2); fp_add<Fq>(b[2], p.x, p.y);
  fp_copy(a[3], y2); fp_copy(b[3], p.z);
  fp_copy(a[4], x2); fp_copy(b[4], p.z);
  fp_mul_groups<Fq, 5, G>(q, a, b);
  uint32_t t0[8], t1[8], t2[8], t3[8], t4[8], u[8], Y3[8], Z3[8];
  fp_add<Fq>(u, q[0], q[1]);
  fp_sub<Fq>(t3, q[2], u);
  fp_add<Fq>(t4, q[3], p.y);
  fp_add<Fq>(Y3, q[4], p.x);
  fp_add<Fq>(u, q[0], q[0]);
  fp_add<Fq>(t0, u, q[0]);
  fp_mul9<Fq>(t2, p.z);
  fp_add<Fq>(Z3, q[1], t2);
  fp_sub<Fq>(t1, q[1], t2);
  fp_mul9<Fq>(Y3, Y3);
  g1_rcb_tail_ls<G>(out, t0, t1, t3, t4, Y3, Z3);
}
