// Per-thread and per-block arithmetic of the variable-base Pippenger over
// BN254 G2 (csrc/msm_g2.cu), as __host__ __device__ code on top of msm.cuh
// and g2.cuh, for one MSM (P = 1): 32 windows of 256 buckets.
//
// The shape is the G1 Pippenger's accumulate (msm.cuh, "The accumulate"):
// msm.cuh's own counting sort lists each window's points by digit, a thread
// sums a piece of at most L points of one bucket by mixed additions
// (g2_madd), and a bucket's pieces meet in a binary tree, one launch a
// level.  Then g2_window_sum takes each window's sum_b b * B_b in one block.
//
// G2 points in device memory lie in two planes: an array of N projective
// points is 2 * N * 24 words, the c0 halves of point i's X, Y, Z (24 words,
// G1Proj's layout) at i * 24 and their c1 halves at N * 24 + i * 24.  So
// msm_acc_sort, which stores G1's identity (0 : 1 : 0) into each empty
// bucket of its `buckets`, stores the c0 plane of G2's identity when handed
// the G2 buckets' first plane; the c1 plane starts zeroed (msm/msm_g2.py).
// The affine bases are (n, 4, 8): x.c0, x.c1, y.c0, y.c1.
//
// A block is `blk` as in msm.cuh: blk.each(f) calls f(t, r) for its threads
// t, r being thread t's G2Proj, and blk.sync() is the barrier.
#pragma once

#include "g2.cuh"
#include "msm.cuh"

// Point i of a planar array whose c1 plane starts `plane` words after its c0
// plane; `at` is the c0 plane's point i.
ZK_HD void g2_ld(G2Proj &q, const uint32_t *at, size_t plane) {
  ld_fp(q.x.c0, at);
  ld_fp(q.y.c0, at + 8);
  ld_fp(q.z.c0, at + 16);
  ld_fp(q.x.c1, at + plane);
  ld_fp(q.y.c1, at + plane + 8);
  ld_fp(q.z.c1, at + plane + 16);
}

ZK_HD void g2_st(uint32_t *at, size_t plane, const G2Proj &q) {
  st_fp(at, q.x.c0);
  st_fp(at + 8, q.y.c0);
  st_fp(at + 16, q.z.c0);
  st_fp(at + plane, q.x.c1);
  st_fp(at + plane + 8, q.y.c1);
  st_fp(at + plane + 16, q.z.c1);
}

// Affine base i of the (n, 4, 8) bases.
ZK_HD void g2_ld_affine(Fq2 &x, Fq2 &y, const uint32_t *bases, int i) {
  const uint32_t *b = bases + (size_t)i * 32;
  ld_fp(x.c0, b);
  ld_fp(x.c1, b + 8);
  ld_fp(y.c0, b + 16);
  ld_fp(y.c1, b + 24);
}

// Where piece j of bucket b of window w (offset tables m) is kept: piece 0
// in the bucket's slot of the 32 * 256 buckets, piece j >= 1 among the
// window's XS extra points (32 * XS of them).
ZK_HD uint32_t *g2_piece_at(uint32_t *buckets, uint32_t *extra, const int32_t *m, int w, int b,
                            int j, int XS, size_t &plane) {
  if (j == 0) {
    plane = (size_t)MSM_WINDOWS * MSM_BUCKETS * MSM_PT;
    return buckets + ((size_t)w * MSM_BUCKETS + b) * MSM_PT;
  }
  plane = (size_t)MSM_WINDOWS * XS * MSM_PT;
  return extra + ((size_t)w * XS + m[2 * ACC_META + b] + j - 1) * MSM_PT;
}

// Piece s of window w (m: its offset tables from msm_acc_sort; pst: a copy
// of its piece offsets, m + ACC_META): its points summed from the first, (x,
// y, 1), by g2_madd, as msm_acc_piece does over G1.
ZK_HD void g2_acc_piece(const uint32_t *bases, const int32_t *idx, const int32_t *m,
                        const int32_t *pst, uint32_t *buckets, uint32_t *extra, int w, int s,
                        int n, int XS) {
  if (s >= pst[MSM_BUCKETS]) return;
  const int b = acc_piece_bucket(pst, s), q = pst[b + 1] - pst[b], j = s - pst[b];
  const int c = m[b + 1] - m[b];
  const int lo = m[b] + (int)((long long)c * j / q), hi = m[b] + (int)((long long)c * (j + 1) / q);
  const int32_t *list = idx + (size_t)w * n;
  G2Proj acc;
  g2_ld_affine(acc.x, acc.y, bases, list[lo]);
#pragma unroll
  for (int k = 0; k < 8; k++) {
    acc.z.c0[k] = Fq::one(k);
    acc.z.c1[k] = 0;
  }
  for (int e = lo + 1; e < hi; e++) {
    Fq2 x, y;
    g2_ld_affine(x, y, bases, list[e]);
    g2_madd(acc, acc, x, y);
  }
  size_t plane;
  uint32_t *at = g2_piece_at(buckets, extra, m, w, b, j, XS, plane);
  g2_st(at, plane, acc);
}

// The merge level at stride h for piece s of window w: a piece j with j % 2h
// == 0 adds piece j + h, if below its bucket's q, into its own.
ZK_HD void g2_acc_merge(const int32_t *m, const int32_t *pst, uint32_t *buckets, uint32_t *extra,
                        int w, int s, int h, int XS) {
  if (s >= pst[MSM_BUCKETS]) return;
  const int b = acc_piece_bucket(pst, s), q = pst[b + 1] - pst[b], j = s - pst[b];
  if (j % (2 * h) != 0 || j + h >= q) return;
  size_t pa, pb;
  uint32_t *at = g2_piece_at(buckets, extra, m, w, b, j, XS, pa);
  const uint32_t *from = g2_piece_at(buckets, extra, m, w, b, j + h, XS, pb);
  G2Proj r, v;
  g2_ld(r, at, pa);
  g2_ld(v, from, pb);
  g2_padd(r, r, v);
  g2_st(at, pa, r);
}

constexpr int G2_REDUCE_THREADS = MSM_BUCKETS;  // 8 bits x 32 threads

// A halving tree over the threads t = stride * g, g < 2 top: at h = top, top
// / 2, ..., 1, thread g < h adds thread g + h's point (through `slot`, a
// point a thread), leaving the sum in thread 0 of each 2 top * stride.
template <class Block>
ZK_HD void g2_tree(Block &blk, G2Proj *slot, int stride, int top) {
  for (int h = top; h >= 1; h /= 2) {
    blk.each([&](int t, G2Proj &r) {
      const int g = t / stride % (2 * top);
      if (t % stride == 0 && g >= h && g < 2 * h) slot[t] = r;
    });
    blk.sync();
    blk.each([&](int t, G2Proj &r) {
      if (t % stride == 0 && t / stride % (2 * top) < h) g2_padd(r, r, slot[t + h * stride]);
    });
    blk.sync();
  }
}

// Window w's sum_b b * B_b = sum_k 2^k C_k, C_k the sum of the buckets whose
// index has bit k set (bucket 0 is never read), into point w of `out` (32
// points).  Thread t = 32 k + j sums members j, j + 32, j + 64, j + 96 of bit
// k's 128 buckets; a halving tree over j leaves C_k in thread 32 k, which
// doubles it k times; a halving tree over k adds the eight.  11 additions
// and 7 doublings deep.  `slot`: a point a thread (shared memory on the
// card), through which the trees hand a thread's sum to the thread that adds
// it.
template <class Block>
ZK_HD void g2_window_sum(Block &blk, const uint32_t *buckets, G2Proj *slot,
                         uint32_t *__restrict__ out, int w) {
  const size_t plane = (size_t)MSM_WINDOWS * MSM_BUCKETS * MSM_PT;
  blk.each([&](int t, G2Proj &r) {
    const int k = t / 32, j = t % 32;
    for (int c = j; c < MSM_BUCKETS / 2; c += 32) {
      const int i = ((c >> k) << (k + 1)) | (1 << k) | (c & ((1 << k) - 1));
      const uint32_t *at = buckets + ((size_t)w * MSM_BUCKETS + i) * MSM_PT;
      if (c == j) {
        g2_ld(r, at, plane);
      } else {
        G2Proj q;
        g2_ld(q, at, plane);
        g2_padd(r, r, q);
      }
    }
  });
  g2_tree(blk, slot, 1, 16);  // over j: C_k in thread 32 k
  blk.each([&](int t, G2Proj &r) {
    if (t % 32 == 0)
      for (int d = 0; d < t / 32; d++) g2_dbl(r, r);
  });
  g2_tree(blk, slot, 32, 4);  // over k
  blk.each([&](int t, G2Proj &r) {
    if (t == 0) g2_st(out + (size_t)w * MSM_PT, (size_t)MSM_WINDOWS * MSM_PT, r);
  });
}
