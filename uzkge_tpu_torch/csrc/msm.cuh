// Per-block and per-thread arithmetic of the variable-base Pippenger over
// BN254 G1 (csrc/msm.cu), as __host__ __device__ code on top of
// fixed_base.cuh: msm_bucket_reduce's blocks first, then the accumulate's
// sort, pieces and merge (below, "The accumulate").
//
// The reduce's input is the accumulate's (P, K, 32, 256) projective buckets,
// 24 words each (X, Y, Z, 8 limbs apiece, Fq Montgomery).  For window (p, w)
// the output is sum_b b * F_b, F_b = sum_k B[p, k, w, b] (bucket 0 has weight
// 0 and is never read).  The work of a window is split over T blocks of 256
// threads, T = msm_reduce_slices(K): block g takes the NB = 256 / T buckets
// g*NB .. g*NB + NB - 1, and thread s*NB + i of it folds chunks s, s + T,
// s + 2T, ... of bucket g*NB + i (one slice of K), so that about as many
// threads fold at every batch P (the prover keeps P*K at 512 or 640).  A
// halving tree in shared memory adds the T slices (msm_block_tree).  The
// weighted sum is taken bit by bit: sum_b b * F_b = sum_k 2^k C_k with C_k =
// the sum of the F_b whose bucket index b has bit k set.  The block forms its
// share of each C_k (for the low m = log2(NB) bits a sum over NB / 2 of its
// buckets, for the high bits, which are g's, the sum of all of them), 32
// threads to a bit and then a tree, and writes those partial sums out; the
// window's last block to finish adds the T shares of each C_k and weighs the
// eight sums by a tree of doublings, 10 additions deep (msm_window_sum).
//
// A block is `blk`: blk.B threads, blk.each(f) calls f(t, r) for its threads
// t, r being thread t's point, and blk.sync() is the barrier between them.
// On the card each thread runs these functions with each() calling f for
// itself alone; the CPU suite (tests/test_torch_msm_header.py) runs them
// once per block with each() looping over t and a no-op sync().
#pragma once

#include "fixed_base.cuh"

constexpr int MSM_WINDOWS = 32;
constexpr int MSM_BUCKETS = 256;  // buckets a window, and threads a block
constexpr int MSM_BITS = 8;       // bits of a bucket index
constexpr int MSM_PT = 24;        // words of a projective point
constexpr int MSM_SLICE = 64;     // chunks a thread folds, where the slices allow
constexpr int MSM_MAX_SLICES = 8;
constexpr int MSM_PARTS = MSM_BITS + 1;  // partial sums a block writes: C_k shares, then all

// Slices of each bucket's K chunks: the least power of two T with ceil(K / T)
// <= MSM_SLICE, at most MSM_MAX_SLICES and at most K.
ZK_HD int msm_reduce_slices(int K) {
  int T = 1;
  while (T < MSM_MAX_SLICES && 2 * T <= K && (K + T - 1) / T > MSM_SLICE) T *= 2;
  return T;
}

ZK_HD int msm_log2(int v) {
  int m = 0;
  while ((1 << m) < v) m++;
  return m;
}

ZK_HD void msm_ld(G1Proj &q, const uint32_t *p) {
  ld_fp(q.x, p);
  ld_fp(q.y, p + 8);
  ld_fp(q.z, p + 16);
}

ZK_HD void msm_st(uint32_t *p, const G1Proj &q) {
  st_fp(p, q.x);
  st_fp(p + 8, q.y);
  st_fp(p + 16, q.z);
}

// A point another block of this launch wrote: read through L2, past this
// SM's L1, which is not coherent with the other SMs'.
ZK_HD void msm_ld_l2(G1Proj &q, const uint32_t *p) {
#ifdef __CUDA_ARCH__
  const uint4 *s = reinterpret_cast<const uint4 *>(p);
  uint4 v[6];
#pragma unroll
  for (int i = 0; i < 6; i++) v[i] = __ldcg(s + i);
  const uint32_t *w = reinterpret_cast<const uint32_t *>(v);
#pragma unroll
  for (int j = 0; j < 8; j++) {
    q.x[j] = w[j];
    q.y[j] = w[8 + j];
    q.z[j] = w[16 + j];
  }
#else
  msm_ld(q, p);
#endif
}

// r += q: RCB Alg. 7 (g1_padd; its products in lockstep pairs need 178
// registers here against 116, one block a SM instead of two, and were no
// faster).
ZK_HD void msm_add(G1Proj &r, const G1Proj &q) { g1_padd(r, r, q); }

// Sums each thread's point r over the threads t, t + stride, t + 2 stride,
// ... (blk.B / stride of them, a power of two) into thread t < stride:
// halving rounds in which the upper half of the live threads stores its
// points into `s` (blk.B / 2 points) and the lower half adds them.
template <class Block>
ZK_HD void msm_block_tree(Block &blk, uint32_t *s, int stride) {
  for (int h = blk.B / 2; h >= stride; h /= 2) {
    blk.each([&](int t, G1Proj &r) {
      if (t >= h && t < 2 * h) msm_st(s + (t - h) * MSM_PT, r);
    });
    blk.sync();
    blk.each([&](int t, G1Proj &r) {
      if (t < h) {
        G1Proj q;
        msm_ld(q, s + t * MSM_PT);
        msm_add(r, q);
      }
    });
    blk.sync();
  }
}

// Block g of window pw = p * 32 + w (T blocks a window): folds its NB = 256 /
// T buckets over the K chunks (sF: their NB sums; sT: blk.B / 2 points of
// tree scratch), then writes its partial sums to slots (pw * T + g) *
// MSM_PARTS + k of `part`: for k < m = log2(NB) the sum of its buckets with
// bit k set; if T > 1, in slot MSM_BITS, the sum of all of them.
template <class Block>
ZK_HD void msm_reduce_group(Block &blk, const uint32_t *__restrict__ buckets, uint32_t *sF,
                            uint32_t *sT, uint32_t *__restrict__ part, int pw, int g, int T,
                            int K) {
  const int NB = MSM_BUCKETS / T, m = msm_log2(NB);
  const int p = pw / MSM_WINDOWS, w = pw % MSM_WINDOWS;
  blk.each([&](int t, G1Proj &r) {  // thread s * NB + i: slice s of bucket g * NB + i
    const int s = t / NB, b = g * NB + t % NB;
    g1_set_identity(r);
    if (b == 0 || s >= K) return;
    const uint32_t *at = buckets + (((size_t)p * K * MSM_WINDOWS + w) * MSM_BUCKETS + b) * MSM_PT;
    const size_t step = (size_t)MSM_WINDOWS * MSM_BUCKETS * MSM_PT;  // one chunk on
    msm_ld(r, at + s * step);
    for (int k = s + T; k < K; k += T) {
      G1Proj q;
      msm_ld(q, at + k * step);
      msm_add(r, q);
    }
  });
  msm_block_tree(blk, sT, NB);
  blk.each([&](int t, G1Proj &r) {
    if (t < NB) msm_st(sF + t * MSM_PT, r);
  });
  blk.sync();
  // thread j * 8 + k, j < 32: members j, j + 32, ... of bit k's subset
  blk.each([&](int t, G1Proj &r) {
    const int k = t % MSM_BITS, j = t / MSM_BITS;
    const int count = k < m ? NB / 2 : (k == m && T > 1 ? NB : 0);
    g1_set_identity(r);
    for (int c = j; c < count; c += blk.B / MSM_BITS) {
      // k < m: the c-th index below NB with bit k set; else every index
      const int i = k < m ? ((c >> k) << (k + 1)) | (1 << k) | (c & ((1 << k) - 1)) : c;
      G1Proj q;
      msm_ld(q, sF + i * MSM_PT);
      if (c == j) r = q;
      else msm_add(r, q);
    }
  });
  msm_block_tree(blk, sT, MSM_BITS);
  blk.each([&](int t, G1Proj &r) {
    if (t < m || (t == m && T > 1))
      msm_st(part + (((size_t)pw * T + g) * MSM_PARTS + (t < m ? t : MSM_BITS)) * MSM_PT, r);
  });
}

// Window pw's sum, once all T of its blocks have written their partial sums
// (sT: 8 points of scratch): thread k < 8 adds the T shares of C_k (a high
// bit k >= m is bit k - m of the group g, whose share is then its sum of
// all), then rounds s = 1, 2, 4 set C_t += 2^s C_{t+s} for t a multiple of
// 2s (s doublings), leaving sum_k 2^k C_k in thread 0, which writes it to
// element pw of `out`.
template <class Block>
ZK_HD void msm_window_sum(Block &blk, const uint32_t *part, uint32_t *sT,
                          uint32_t *__restrict__ out, int pw, int T) {
  const int m = msm_log2(MSM_BUCKETS / T);
  blk.each([&](int t, G1Proj &r) {
    g1_set_identity(r);
    if (t >= MSM_BITS) return;
    bool first = true;
    for (int g = 0; g < T; g++) {
      if (t >= m && !((g >> (t - m)) & 1)) continue;
      G1Proj q;
      msm_ld_l2(q, part + (((size_t)pw * T + g) * MSM_PARTS + (t < m ? t : MSM_BITS)) * MSM_PT);
      if (first) r = q;
      else msm_add(r, q);
      first = false;
    }
  });
  for (int s = 1; s < MSM_BITS; s *= 2) {
    blk.each([&](int t, G1Proj &r) {
      if (t < MSM_BITS && t % (2 * s) == s) {
        for (int d = 0; d < s; d++) g1_dbl_ls<2>(r, r);
        msm_st(sT + t * MSM_PT, r);
      }
    });
    blk.sync();
    blk.each([&](int t, G1Proj &r) {
      if (t < MSM_BITS && t % (2 * s) == 0) {
        G1Proj q;
        msm_ld(q, sT + (t + s) * MSM_PT);
        msm_add(r, q);
      }
    });
    blk.sync();
  }
  blk.each([&](int t, G1Proj &r) {
    if (t == 0) msm_st(out + (size_t)pw * MSM_PT, r);
  });
}

// ------------------------------------------------------------ The accumulate
//
// msm_bucket_accumulate sums the points of each (p, w, bucket) into buckets
// (P, 1, 32, 256, 3, 8), window pw = p * 32 + w, digit w of scalar (p, i)
// being byte w of its 32-byte standard form.  Three kinds of launch:
//   sort: a block of ACC_SORT_THREADS per window, a stable counting sort of
//     the window's point indices by nonzero digit into idx[pw * n ..]
//     (bucket 1's points first, each bucket's in index order) and the
//     window's three offset tables in meta; the identity into every empty
//     bucket (bucket 0 included);
//   piece: bucket b's c points are cut into q = ceil(c / L) pieces, piece j
//     the entries c*j/q .. c*(j+1)/q - 1 of its list (at most L points); a
//     thread per piece sums them in registers, its first point (x, y, 1)
//     starting the sum and each next one added by g1_madd, and stores the
//     sum: piece 0 into the bucket's own slot of the output, pieces j >= 1
//     among the window's XS = ceil(n / L) extra points;
//   merge, one launch per level of a binary tree (stride h = 1, 2, 4, ...
//     below XS): the thread of piece j with j % 2h == 0 adds piece j + h,
//     if below q, into its own by g1_padd; after the last level piece 0
//     holds the bucket.  A window whose buckets all have at most h pieces
//     leaves the level at once.
// No thread adds more than L points or more than one piece a level,
// whatever the digits: a skewed bucket only takes more levels.
// msm_bucket_accumulate_plain (msm/msm.py) cuts and adds in the same order,
// so the kernels equal it limb for limb.

constexpr int ACC_SORT_WARPS = 32;
constexpr int ACC_SORT_THREADS = ACC_SORT_WARPS * 32;
constexpr int ACC_SORT_SHARED = ACC_SORT_WARPS * MSM_BUCKETS + MSM_BUCKETS;  // ints
// Window pw's offset tables, ACC_META ints each from meta + pw * ACC_META_INTS:
// its sorted list's first entry of bucket b (b <= 256; the last is the
// window's nonzero digits), its first piece of bucket b (the last: its
// pieces), its first extra point of bucket b; then the most pieces a bucket
// of the window has.
constexpr int ACC_META = MSM_BUCKETS + 1;
constexpr int ACC_META_INTS = 3 * ACC_META + 1;

// Digit w of scalar (p, i) of the (P, n) scalars' 32-byte standard forms.
ZK_HD int acc_digit(const uint8_t *std_bytes, int n, int pw, int i) {
  return std_bytes[((size_t)(pw / MSM_WINDOWS) * n + i) * 32 + pw % MSM_WINDOWS];
}

// *c += 1 for a count in shared memory that several threads raise.
ZK_HD void acc_inc(int *c) {
#ifdef __CUDA_ARCH__
  atomicAdd(c, 1);
#else
  (*c)++;
#endif
}

// The sort of window pw (sh: ACC_SORT_SHARED ints of scratch).  Warp v of
// the block (ACC_SORT_WARPS of them) takes the R = ceil(n / 32) consecutive
// points from v * R, 32 at a step: it counts its digits, thread b then works
// out the window's offsets of bucket b and each warp's first entry in it, and
// the warps place their points in step order, lanes in order (on the card a
// lane's rank among the lanes of its step with its digit comes from
// __match_any_sync), so every bucket lists its points by index.
template <class Block>
ZK_HD void msm_acc_sort(Block &blk, const uint8_t *std_bytes, int32_t *idx, int32_t *meta,
                        uint32_t *buckets, int *sh, int pw, int n, int L) {
  int *cnt = sh;                                 // [warp][bucket]: counts, then offsets
  int *tot = sh + ACC_SORT_WARPS * MSM_BUCKETS;  // [bucket]: the window's counts
  const int R = (n + ACC_SORT_WARPS - 1) / ACC_SORT_WARPS, steps = (R + 31) / 32;
  int32_t *m = meta + (size_t)pw * ACC_META_INTS;
  blk.each([&](int t, G1Proj &) {
    for (int k = t; k < ACC_SORT_WARPS * MSM_BUCKETS; k += blk.B) cnt[k] = 0;
  });
  blk.sync();
  blk.each([&](int t, G1Proj &) {
    const int v = t / 32;
    for (int o = t % 32; o < R && v * R + o < n; o += 32) {
      const int d = acc_digit(std_bytes, n, pw, v * R + o);
      if (d) acc_inc(cnt + v * MSM_BUCKETS + d);
    }
  });
  blk.sync();
  blk.each([&](int t, G1Proj &) {
    if (t >= MSM_BUCKETS) return;
    int c = 0;
    for (int v = 0; v < ACC_SORT_WARPS; v++) c += cnt[v * MSM_BUCKETS + t];
    tot[t] = c;
  });
  blk.sync();
  blk.each([&](int t, G1Proj &) {
    if (t > MSM_BUCKETS) return;
    int first = 0, piece = 0, extra = 0, most = 0;
    for (int e = 0; e < t; e++) {
      const int q = (tot[e] + L - 1) / L;
      first += tot[e];
      piece += q;
      extra += q > 0 ? q - 1 : 0;
      most = q > most ? q : most;
    }
    m[t] = first;
    m[ACC_META + t] = piece;
    m[2 * ACC_META + t] = extra;
    if (t == MSM_BUCKETS) {
      m[3 * ACC_META] = most;
      return;
    }
    if (tot[t] == 0) {
      G1Proj o;
      g1_set_identity(o);
      msm_st(buckets + ((size_t)pw * MSM_BUCKETS + t) * MSM_PT, o);
    }
    for (int v = 0; v < ACC_SORT_WARPS; v++) {
      const int c = cnt[v * MSM_BUCKETS + t];
      cnt[v * MSM_BUCKETS + t] = first;
      first += c;
    }
  });
  blk.sync();
  int32_t *list = idx + (size_t)pw * n;
  for (int s = 0; s < steps; s++)
    blk.each([&](int t, G1Proj &) {
      const int v = t / 32, l = t % 32, o = s * 32 + l;
      const int d = o < R && v * R + o < n ? acc_digit(std_bytes, n, pw, v * R + o) : 0;
      int *off = cnt + v * MSM_BUCKETS + d;
#ifdef __CUDA_ARCH__
      const unsigned peers = __match_any_sync(0xffffffffu, d);
      const int rank = __popc(peers & ((1u << l) - 1));
      if (d) list[*off + rank] = v * R + o;
      __syncwarp();
      if (d && rank == 0) *off += __popc(peers);
      __syncwarp();
#else
      if (d) list[(*off)++] = v * R + o;
#endif
    });
}

// The bucket of piece s of a window whose piece offsets are pst (0 <= s <
// pst[MSM_BUCKETS]): the b with pst[b] <= s < pst[b + 1].
ZK_HD int acc_piece_bucket(const int32_t *pst, int s) {
  int lo = 0, hi = MSM_BUCKETS - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (pst[mid] <= s) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Where piece j of bucket b of window pw (offset tables m) is kept: piece 0
// in the bucket's slot of the output, piece j >= 1 among the window's XS
// extra points.
ZK_HD uint32_t *acc_piece_at(uint32_t *buckets, uint32_t *extra, const int32_t *m, int pw, int b,
                             int j, int XS) {
  return j == 0 ? buckets + ((size_t)pw * MSM_BUCKETS + b) * MSM_PT
                : extra + ((size_t)pw * XS + m[2 * ACC_META + b] + j - 1) * MSM_PT;
}

// Piece s of window pw (m: its offset tables; pst: a copy of its piece
// offsets, m + ACC_META): the sum of the piece's points, stored where
// acc_piece_at keeps it.
ZK_HD void msm_acc_piece(const uint32_t *bx, const uint32_t *by, const int32_t *idx,
                         const int32_t *m, const int32_t *pst, uint32_t *buckets,
                         uint32_t *extra, int pw, int s, int n, int XS) {
  if (s >= pst[MSM_BUCKETS]) return;
  const int b = acc_piece_bucket(pst, s), q = pst[b + 1] - pst[b], j = s - pst[b];
  const int c = m[b + 1] - m[b];
  const int lo = m[b] + (int)((long long)c * j / q), hi = m[b] + (int)((long long)c * (j + 1) / q);
  const int32_t *list = idx + (size_t)pw * n;
  G1Proj acc;
  int i = list[lo];
  ld_fp(acc.x, bx + (size_t)i * 8);
  ld_fp(acc.y, by + (size_t)i * 8);
  for (int k = 0; k < 8; k++) acc.z[k] = Fq::one(k);
  for (int e = lo + 1; e < hi; e++) {
    i = list[e];
    uint32_t x[8], y[8];
    ld_fp(x, bx + (size_t)i * 8);
    ld_fp(y, by + (size_t)i * 8);
    g1_madd(acc, acc, x, y);
  }
  msm_st(acc_piece_at(buckets, extra, m, pw, b, j, XS), acc);
}

// The merge level at stride h for piece s of window pw (m, pst as for
// msm_acc_piece): a piece j with j % 2h == 0 adds piece j + h, if below its
// bucket's q, into its own.
ZK_HD void msm_acc_merge(const int32_t *m, const int32_t *pst, uint32_t *buckets, uint32_t *extra,
                         int pw, int s, int h, int XS) {
  if (s >= pst[MSM_BUCKETS]) return;
  const int b = acc_piece_bucket(pst, s), q = pst[b + 1] - pst[b], j = s - pst[b];
  if (j % (2 * h) != 0 || j + h >= q) return;
  uint32_t *at = acc_piece_at(buckets, extra, m, pw, b, j, XS);
  G1Proj r, v;
  msm_ld(r, at);
  msm_ld(v, acc_piece_at(buckets, extra, m, pw, b, j + h, XS));
  msm_add(r, v);
  msm_st(at, r);
}
