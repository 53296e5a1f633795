// BN254 Fr / Fq Montgomery arithmetic and G1 complete additions over 8 x 32-bit
// little-endian limbs, as __host__ __device__ code.
//
// Replaces ff/pallas_rows.py::RowCtx (mul / add / sub / neg): the in-kernel
// field library of every TPU kernel.  There it is a delayed-carry CIOS over
// 16 x 16-bit limbs, because the TPU's vector unit has no 32x32->64-bit
// product; here it is the textbook CIOS over 32-bit limbs with 64-bit
// products.  Both compute a*b*R^-1 mod p with R = 2^256 and return canonical
// values (< p), so results agree bit for bit with the JAX package.
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

// Modulus traits: p, -p^-1 mod 2^32, and 3*b = 9 in Montgomery form.
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
  ZK_HD static uint32_t b3(int i) {  // 9 * R mod q
    const uint32_t B[8] = {0x410d7ff7u, 0xf60647ceu, 0xd31bd011u, 0x2f3d6f4du,
                           0x3940c6d1u, 0x2943337eu, 0xa7e39857u, 0x1d9598e8u};
    return B[i];
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

// CIOS Montgomery multiplication: r = a * b * 2^-256 mod p.  r may alias a/b.
template <class F>
ZK_HD void fp_mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t t[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c += (uint64_t)a[j] * b[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[8] = (uint32_t)c;
    t[9] = (uint32_t)(c >> 32);
    uint32_t m = t[0] * F::inv();
    c = ((uint64_t)m * F::p(0) + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      c += (uint64_t)m * F::p(j) + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (uint32_t)c;
    t[8] = t[9] + (uint32_t)(c >> 32);
  }
  fp_reduce_once<F>(r, t, t[8]);
}

ZK_HD void fp_copy(uint32_t r[8], const uint32_t a[8]) {
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = a[j];
}

// ---------------------------------------------------------------- G1 over Fq
// Projective (X : Y : Z); the identity is (0 : 1 : 0).  Complete formulas of
// Renes-Costello-Batina (eprint 2015/1060) for a = 0, b3 = 9: no branches for
// the identity or for doubling, as in msm/msm.py::_madd / _padd.

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
  uint32_t b3[8], t0[8], t1[8], t2[8], t3[8], t4[8], X3[8], Y3[8], Z3[8];
#pragma unroll
  for (int j = 0; j < 8; j++) b3[j] = Fq::b3(j);
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
  fp_mul<Fq>(t2, b3, p.z);
  fp_add<Fq>(Z3, t1, t2);
  fp_sub<Fq>(t1, t1, t2);
  fp_mul<Fq>(Y3, b3, Y3);
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
  uint32_t b3[8], t0[8], t1[8], t2[8], t3[8], t4[8], X3[8], Y3[8], Z3[8];
#pragma unroll
  for (int j = 0; j < 8; j++) b3[j] = Fq::b3(j);
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
  fp_mul<Fq>(t2, b3, t2);
  fp_add<Fq>(Z3, t1, t2);
  fp_sub<Fq>(t1, t1, t2);
  fp_mul<Fq>(Y3, b3, Y3);
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
