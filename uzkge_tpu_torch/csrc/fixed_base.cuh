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

// a^(q-2) mod q, Fermat's inverse (0 for a = 0), by left-to-right square and
// multiply over the 254-bit exponent: 253 squarings and one multiply per set
// bit below the top one.
ZK_HD void fq_inv_fermat(uint32_t r[8], const uint32_t a[8]) {
  uint32_t acc[8];
  fp_copy(acc, a);  // the exponent's top bit, 253
  for (int bit = 252; bit >= 0; bit--) {
    fp_mul<Fq>(acc, acc, acc);
    const uint32_t limb = Fq::p(bit >> 5) - (bit < 32 ? 2u : 0u);  // q - 2: q's low limb is odd, > 2
    if ((limb >> (bit & 31)) & 1u) fp_mul<Fq>(acc, acc, a);
  }
  fp_copy(r, acc);
}

// fb_bases, one base point: T = (x : y : 1); for each window w < W, emit T as
// row w (rows `rs` elements apart) of (ox, oy, oz), then double T c times, so
// that row w holds 2^(c*w) * P projectively.  The doubling is the complete
// projective addition T + T (RCB Alg. 7), as in the TPU's _bases_kernel.
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
      for (int s = 0; s < c; s++) g1_padd(T, T, T);
  }
}

// fb_mult_chunk, one (window, point) lane: T enters as m * B; emit T as row j
// (rows `rs` elements apart) of (ox, oy, oz), then T += B by the complete
// mixed addition (RCB Alg. 8), for j < CH; the advanced T = (m + CH) * B goes
// to (fx, fy, fz).
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
    g1_madd(T, T, Bx, By);
  }
  st_fp(fx, T.x);
  st_fp(fy, T.y);
  st_fp(fz, T.z);
}

// fq_batch_inv, forward sweep of the strided group {t, t + M, t + 2M, ...} of
// the N elements of `a`: running prefix products into `pref`, the group's
// product into prod[t].
ZK_HD void fq_inv_prefix_group(const uint32_t *a, uint32_t *pref, uint32_t *prod, long long t,
                               long long M, long long N) {
  uint32_t acc[8], v[8];
  ld_fp(acc, a + t * 8);
  st_fp(pref + t * 8, acc);
  for (long long i = t + M; i < N; i += M) {
    ld_fp(v, a + i * 8);
    fp_mul<Fq>(acc, acc, v);
    st_fp(pref + i * 8, acc);
  }
  st_fp(prod + t * 8, acc);
}

// fq_batch_inv, backward sweep of the same group, given pinv[t] = the inverse
// of its product: from the last member i down, out[i] = pinv * pref[i - M]
// and pinv *= a[i]; finally out[t] = pinv.  Two multiplies per member.  `out`
// may be `pref` itself: pref[i] is last read one step before out[i] is written.
ZK_HD void fq_inv_back_group(const uint32_t *a, const uint32_t *pref, const uint32_t *pinv,
                             uint32_t *out, long long t, long long M, long long N) {
  uint32_t inv[8], p[8], v[8];
  ld_fp(inv, pinv + t * 8);
  for (long long i = t + ((N - 1 - t) / M) * M; i > t; i -= M) {
    ld_fp(p, pref + (i - M) * 8);
    ld_fp(v, a + i * 8);
    fp_mul<Fq>(p, inv, p);
    fp_mul<Fq>(inv, inv, v);
    st_fp(out + i * 8, p);
  }
  st_fp(out + t * 8, inv);
}
