// BN254 Fq2 and G2 arithmetic over field.cuh's Fq Montgomery products, as
// __host__ __device__ code: the variable-base Pippenger over G2
// (msm_g2.cuh, msm_g2.cu) adds with these functions, and g++ compiles them
// for the CPU test suite (tests/test_torch_msm_g2.py).
//
// Fq2 = Fq[u] / (u^2 + 1): an element is (c0, c1), c0 + c1 u, each half 8 x
// 32-bit limbs in Montgomery form and canonical (< q), as field.cuh keeps Fq.
//
// G2 is the sextic twist y^2 = x^3 + b' over Fq2, b' = 3 / (9 + u), whose
// points the Groth16 key's b_g2_query holds.  Points are projective
// (X : Y : Z), x = X / Z, y = Y / Z, the identity (0 : 1 : 0), added by the
// complete formulas of Renes-Costello-Batina (eprint 2015/1060, Alg. 7, 8
// and 9 for a = 0), as field.cuh's G1: no branch on the identity, on P = Q
// or on P = -Q, so the threads of a warp never diverge on the data, and the
// kernels' order of additions fixes their projective limbs, which the plain
// torch version (msm/msm_g2.py) repeats.  Jacobian formulas take fewer
// products (a mixed addition 7 + 4 squarings against RCB's 13) but branch
// on those cases; the G2 MSM of a reveal is some 10^5 additions, well under
// a millisecond of the card's products either way, so uniform control flow
// and one formula per case won.  Unlike G1's b3 = 9, G2's b3 = 3b' =
// 9 / (9 + u) is a full Fq2 constant, so its products are Fq2 products:
// a mixed addition costs 13 Fq2 products (39 Montgomery products), a
// projective one 14 (42), a doubling 7 and 2 squarings (25).
#pragma once

#include "field.cuh"

// An Fq2 product is one called function on the card, not inlined.  Inlined,
// the formulas' some 40 Montgomery products a point addition, each an
// unrolled CIOS product, took ptxas about six minutes for msm_g2.cu (about
// one minute for any other source of the library), and the kernels ran at
// 255 registers with 40-108 bytes of spills a thread.  Called, msm_g2.cu
// builds in 13 s, the kernels use 168-214 registers and spill nothing, and
// they run faster (H100, a reveal's 4096 points: accumulate 0.61 ms against
// 0.92, reduce 0.78 against 1.23).
#ifdef __CUDACC__
#define ZK_HD_CALL static __host__ __device__ __noinline__
#else
#define ZK_HD_CALL inline
#endif

struct Fq2 {
  uint32_t c0[8], c1[8];
};

ZK_HD void fq2_add(Fq2 &r, const Fq2 &a, const Fq2 &b) {
  fp_add<Fq>(r.c0, a.c0, b.c0);
  fp_add<Fq>(r.c1, a.c1, b.c1);
}

ZK_HD void fq2_sub(Fq2 &r, const Fq2 &a, const Fq2 &b) {
  fp_sub<Fq>(r.c0, a.c0, b.c0);
  fp_sub<Fq>(r.c1, a.c1, b.c1);
}

// Karatsuba: v0 = a0 b0, v1 = a1 b1, v2 = (a0 + a1)(b0 + b1); a b = (v0 - v1)
// + (v2 - v0 - v1) u.  Three Montgomery products.  r may alias a or b.
ZK_HD_CALL void fq2_mul(Fq2 &r, const Fq2 &a, const Fq2 &b) {
  uint32_t v0[8], v1[8], s[8], t[8];
  fp_mul<Fq>(v0, a.c0, b.c0);
  fp_mul<Fq>(v1, a.c1, b.c1);
  fp_add<Fq>(s, a.c0, a.c1);
  fp_add<Fq>(t, b.c0, b.c1);
  fp_mul<Fq>(s, s, t);
  fp_sub<Fq>(r.c0, v0, v1);
  fp_add<Fq>(t, v0, v1);
  fp_sub<Fq>(r.c1, s, t);
}

// a^2 = (a0 + a1)(a0 - a1) + 2 a0 a1 u.  Two Montgomery products.  r may
// alias a.
ZK_HD void fq2_sqr(Fq2 &r, const Fq2 &a) {
  uint32_t s[8], d[8], m[8];
  fp_add<Fq>(s, a.c0, a.c1);
  fp_sub<Fq>(d, a.c0, a.c1);
  fp_mul<Fq>(m, a.c0, a.c1);
  fp_mul<Fq>(r.c0, s, d);
  fp_add<Fq>(r.c1, m, m);
}

// r = b3 a, b3 = 3b' = 9 / (9 + u) in Montgomery form.  r may alias a.
ZK_HD void fq2_mul_b3(Fq2 &r, const Fq2 &a) {
  const Fq2 b3 = {{0xb62e0d6au, 0x3baa927cu, 0xd1b664fdu, 0xd71e7c52u, 0xd95d4664u,
                   0x03873e63u, 0x082ab8f4u, 0x0e75b5b1u},
                  {0x7596fe35u, 0xaab7c666u, 0xbb6a27bau, 0x31d21a78u, 0x680401ffu,
                   0x85dd7297u, 0xdf39a7e9u, 0x03c52d6au}};
  fq2_mul(r, a, b3);
}

struct G2Proj {
  Fq2 x, y, z;
};

ZK_HD void g2_set_identity(G2Proj &p) {
#pragma unroll
  for (int j = 0; j < 8; j++) {
    p.x.c0[j] = p.x.c1[j] = p.y.c1[j] = p.z.c0[j] = p.z.c1[j] = 0;
    p.y.c0[j] = Fq::one(j);
  }
}

// RCB Alg. 8: projective + affine (x2, y2), the affine point not the
// identity; g1_madd's steps over Fq2.  `out` may alias `p`.
ZK_HD void g2_madd(G2Proj &out, const G2Proj &p, const Fq2 &x2, const Fq2 &y2) {
  Fq2 t0, t1, t2, t3, t4, X3, Y3, Z3;
  fq2_mul(t0, p.x, x2);
  fq2_mul(t1, p.y, y2);
  fq2_add(t3, x2, y2);
  fq2_add(t4, p.x, p.y);
  fq2_mul(t3, t3, t4);
  fq2_add(t4, t0, t1);
  fq2_sub(t3, t3, t4);
  fq2_mul(t4, y2, p.z);
  fq2_add(t4, t4, p.y);
  fq2_mul(Y3, x2, p.z);
  fq2_add(Y3, Y3, p.x);
  fq2_add(X3, t0, t0);
  fq2_add(t0, X3, t0);
  fq2_mul_b3(t2, p.z);
  fq2_add(Z3, t1, t2);
  fq2_sub(t1, t1, t2);
  fq2_mul_b3(Y3, Y3);
  fq2_mul(X3, t4, Y3);
  fq2_mul(t2, t3, t1);
  fq2_sub(X3, t2, X3);
  fq2_mul(Y3, Y3, t0);
  fq2_mul(t1, t1, Z3);
  fq2_add(Y3, t1, Y3);
  fq2_mul(t0, t0, t3);
  fq2_mul(Z3, Z3, t4);
  fq2_add(Z3, Z3, t0);
  out.x = X3;
  out.y = Y3;
  out.z = Z3;
}

// RCB Alg. 7: projective + projective; g1_padd's steps over Fq2.  `out` may
// alias either input.
ZK_HD void g2_padd(G2Proj &out, const G2Proj &p, const G2Proj &q) {
  Fq2 t0, t1, t2, t3, t4, X3, Y3, Z3;
  fq2_mul(t0, p.x, q.x);
  fq2_mul(t1, p.y, q.y);
  fq2_mul(t2, p.z, q.z);
  fq2_add(t3, p.x, p.y);
  fq2_add(t4, q.x, q.y);
  fq2_mul(t3, t3, t4);
  fq2_add(t4, t0, t1);
  fq2_sub(t3, t3, t4);
  fq2_add(t4, p.y, p.z);
  fq2_add(X3, q.y, q.z);
  fq2_mul(t4, t4, X3);
  fq2_add(X3, t1, t2);
  fq2_sub(t4, t4, X3);
  fq2_add(X3, p.x, p.z);
  fq2_add(Y3, q.x, q.z);
  fq2_mul(X3, X3, Y3);
  fq2_add(Y3, t0, t2);
  fq2_sub(Y3, X3, Y3);
  fq2_add(X3, t0, t0);
  fq2_add(t0, X3, t0);
  fq2_mul_b3(t2, t2);
  fq2_add(Z3, t1, t2);
  fq2_sub(t1, t1, t2);
  fq2_mul_b3(Y3, Y3);
  fq2_mul(X3, t4, Y3);
  fq2_mul(t2, t3, t1);
  fq2_sub(X3, t2, X3);
  fq2_mul(Y3, Y3, t0);
  fq2_mul(t1, t1, Z3);
  fq2_add(Y3, t1, Y3);
  fq2_mul(t0, t0, t3);
  fq2_mul(Z3, Z3, t4);
  fq2_add(Z3, Z3, t0);
  out.x = X3;
  out.y = Y3;
  out.z = Z3;
}

// RCB Alg. 9: out = 2p.  X3 = 2XY (Y^2 - 3 b3 Z^2), Y3 = (Y^2 - 3 b3 Z^2)
// (Y^2 + b3 Z^2) + 8 b3 Y^2 Z^2, Z3 = 8 Y^3 Z.  `out` may alias `p`.
ZK_HD void g2_dbl(G2Proj &out, const G2Proj &p) {
  Fq2 t0, t1, t2, X3, Y3, Z3;
  fq2_sqr(t0, p.y);
  fq2_add(Z3, t0, t0);
  fq2_add(Z3, Z3, Z3);
  fq2_add(Z3, Z3, Z3);
  fq2_mul(t1, p.y, p.z);
  fq2_sqr(t2, p.z);
  fq2_mul_b3(t2, t2);
  fq2_mul(X3, t2, Z3);
  fq2_add(Y3, t0, t2);
  fq2_mul(Z3, t1, Z3);
  fq2_add(t1, t2, t2);
  fq2_add(t2, t1, t2);
  fq2_sub(t0, t0, t2);
  fq2_mul(Y3, t0, Y3);
  fq2_add(Y3, X3, Y3);
  fq2_mul(t1, p.x, p.y);
  fq2_mul(X3, t0, t1);
  fq2_add(X3, X3, X3);
  out.x = X3;
  out.y = Y3;
  out.z = Z3;
}
