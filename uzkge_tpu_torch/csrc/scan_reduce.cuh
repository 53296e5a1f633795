// Per-lane arithmetic of the chain MSM's scan reductions over BN254 G1 (the
// rounds of msm/fixed_base.py::reduce_leaves), as __host__ __device__ code on
// top of fixed_base.cuh.
//
// A lane sums S points (S a power of two) by two interleaved running sums,
// the TPU kernels' IL = 2: points s = 0, 2, 4, ... into sum 0 and s = 1, 3,
// 5, ... into sum 1, each starting from the identity; then sum 0 + sum 1.  For
// S = 1 there is one sum.  That order makes the outputs equal the TPU kernel
// bodies' limb for limb.  The kernels of scan_reduce.cu run one lane per
// thread through these functions; g++ compiles the same functions for the CPU
// test suite (tests/test_torch_field.py).  Elements are 8 x 32-bit
// little-endian limbs in Fq Montgomery form.
#pragma once

#include "fixed_base.cuh"

// Leaf k of one MSM's digit row `drow` (W * n digits, leaf k = w * n + i)
// added to `acc`: digit d picks row (2w + |d| - 1) * n + i of the doubling
// chain (ax, ay), whose row r * n + i is 2^r * P_i, with y negated for d < 0,
// by RCB Alg. 8.  A leaf with d = 0 is the identity and leaves `acc` as it is
// (the TPU kernel adds row 0 of its block there and keeps the old sum: the
// same value).
ZK_HD void scan_leaf_add(G1Proj &acc, const uint32_t *ax, const uint32_t *ay,
                         const int32_t *drow, long long k, long long n) {
  const int d = drow[k];
  if (d == 0) return;
  const long long row = (2 * (k / n) + (d < 0 ? -d : d) - 1) * n + k % n;
  uint32_t x[8], y[8];
  ld_fp(x, ax + row * 8);
  ld_fp(y, ay + row * 8);
  if (d < 0) fp_neg<Fq>(y, y);
  g1_madd(acc, acc, x, y);
}

// scan_leaf_reduce, lane t = p * J + j of P MSMs over K leaves each (J = K /
// S): the sum of leaves j * S .. j * S + S - 1 of MSM p into element t of
// (ox, oy, oz).
ZK_HD void scan_leaf_lane(const uint32_t *ax, const uint32_t *ay, const int32_t *digits,
                          uint32_t *ox, uint32_t *oy, uint32_t *oz, long long t, long long K,
                          long long n, int S) {
  const long long J = K / S;
  const int32_t *drow = digits + (t / J) * K;
  const long long k0 = (t % J) * S;
  G1Proj a0, a1;
  g1_set_identity(a0);
  g1_set_identity(a1);
  for (int s = 0; s < S; s += 2) {
    scan_leaf_add(a0, ax, ay, drow, k0 + s, n);
    if (S > 1) scan_leaf_add(a1, ax, ay, drow, k0 + s + 1, n);
  }
  if (S > 1) g1_padd(a0, a0, a1);
  st_fp(ox + t * 8, a0.x);
  st_fp(oy + t * 8, a0.y);
  st_fp(oz + t * 8, a0.z);
}

// Projective point e of (X, Y, Z) added to `acc` by RCB Alg. 7.
ZK_HD void scan_proj_add(G1Proj &acc, const uint32_t *X, const uint32_t *Y, const uint32_t *Z,
                         long long e) {
  G1Proj q;
  ld_fp(q.x, X + e * 8);
  ld_fp(q.y, Y + e * 8);
  ld_fp(q.z, Z + e * 8);
  g1_padd(acc, acc, q);
}

// scan_proj_reduce, lane t: the sum of the S consecutive projective points
// t * S .. t * S + S - 1 of (X, Y, Z) into element t of (oX, oY, oZ).
ZK_HD void scan_proj_lane(const uint32_t *X, const uint32_t *Y, const uint32_t *Z, uint32_t *oX,
                          uint32_t *oY, uint32_t *oZ, long long t, int S) {
  const long long e0 = t * S;
  G1Proj a0, a1;
  g1_set_identity(a0);
  g1_set_identity(a1);
  for (int s = 0; s < S; s += 2) {
    scan_proj_add(a0, X, Y, Z, e0 + s);
    if (S > 1) scan_proj_add(a1, X, Y, Z, e0 + s + 1);
  }
  if (S > 1) g1_padd(a0, a0, a1);
  st_fp(oX + t * 8, a0.x);
  st_fp(oY + t * 8, a0.y);
  st_fp(oZ + t * 8, a0.z);
}
