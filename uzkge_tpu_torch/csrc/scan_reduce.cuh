// Per-lane arithmetic of the chain MSM's leaf round over BN254 G1 (the first
// round of msm/fixed_base.py::reduce_leaves), as __host__ __device__ code on
// top of fixed_base.cuh.  (Its projective rounds are fb_fold_tile, of
// fixed_base_query.cuh.)
//
// A lane sums S leaves (S a power of two) by two interleaved running sums,
// the TPU kernel's IL = 2: leaves s = 0, 2, 4, ... into sum 0 and s = 1, 3,
// 5, ... into sum 1, each starting from the identity; then sum 0 + sum 1.  For
// S = 1 there is one sum.  That order makes the outputs equal the TPU kernel
// body's limb for limb.  scan_leaf_reduce_kernel runs one lane per thread
// through scan_leaf_lane; g++ compiles the same function for the CPU test
// suite (tests/test_torch_field.py, tests/test_torch_chain_msm.py).  Elements
// are 8 x 32-bit little-endian limbs in Fq Montgomery form.
#pragma once

#include "fixed_base.cuh"

// The lowest set bit of a nonzero mask.
ZK_HD int scan_low_bit(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __ffs(m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

// The doubling-chain row of leaf k = w * n + i (n = 2^lg_n) with digit d != 0:
// row (2w + |d| - 1) * n + i of (ax, ay), whose row r * n + i is 2^r * P_i
// (below 2K, so within 32 bits for K < 2^31).
ZK_HD uint32_t scan_leaf_row(int k, int d, int lg_n) {
  const uint32_t w = (uint32_t)k >> lg_n, i = (uint32_t)k & ((1u << lg_n) - 1);
  return ((2 * w + (uint32_t)(d < 0 ? -d : d) - 1) << lg_n) | i;
}

// scan_leaf_reduce, lane t = p * J + j of P MSMs over K leaves each (J = K /
// S, S <= 32; n = 2^lg_n divides K): the sum of leaves j * S .. j * S + S - 1
// of MSM p into element t of (ox, oy, oz).  Leaf s with digit d adds the
// chain row of scan_leaf_row, y negated for d < 0, into sum s % 2 by RCB
// Alg. 8.  A leaf with d = 0 is the identity and leaves its sum as it is
// (the TPU kernel adds row 0 of its block there and keeps the old sum: the
// same value), so the lane walks only its nonzero leaves, lowest first, by a
// mask of its S digits, and picks the sum by the leaf's parity (selects, not
// a branch: a warp's lanes are at different leaves).
ZK_HD void scan_leaf_lane(const uint32_t *ax, const uint32_t *ay, const int32_t *digits,
                          uint32_t *ox, uint32_t *oy, uint32_t *oz, int t, int K, int lg_n,
                          int S) {
  const int J = K / S, k0 = (t % J) * S;
  const int32_t *drow = digits + (size_t)(t / J) * K + k0;
  uint32_t mask = 0;
  for (int s = 0; s < S; s++) mask |= (uint32_t)(drow[s] != 0) << s;
  G1Proj a0, a1;
  g1_set_identity(a0);
  g1_set_identity(a1);
  for (; mask; mask &= mask - 1) {
    const int s = scan_low_bit(mask), d = drow[s];
    const size_t row = scan_leaf_row(k0 + s, d, lg_n);
    uint32_t x[8], y[8];
    ld_fp(x, ax + row * 8);
    ld_fp(y, ay + row * 8);
    if (d < 0) fp_neg<Fq>(y, y);
    const bool odd = s & 1;
    G1Proj acc;
    for (int j = 0; j < 8; j++) {
      acc.x[j] = odd ? a1.x[j] : a0.x[j];
      acc.y[j] = odd ? a1.y[j] : a0.y[j];
      acc.z[j] = odd ? a1.z[j] : a0.z[j];
    }
    g1_madd(acc, acc, x, y);
    for (int j = 0; j < 8; j++) {
      a0.x[j] = odd ? a0.x[j] : acc.x[j];
      a0.y[j] = odd ? a0.y[j] : acc.y[j];
      a0.z[j] = odd ? a0.z[j] : acc.z[j];
      a1.x[j] = odd ? acc.x[j] : a1.x[j];
      a1.y[j] = odd ? acc.y[j] : a1.y[j];
      a1.z[j] = odd ? acc.z[j] : a1.z[j];
    }
  }
  if (S > 1) g1_padd(a0, a0, a1);
  st_fp(ox + (size_t)t * 8, a0.x);
  st_fp(oy + (size_t)t * 8, a0.y);
  st_fp(oz + (size_t)t * 8, a0.z);
}
