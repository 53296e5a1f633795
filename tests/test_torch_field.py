"""The torch port's field arithmetic against the JAX package's MontCtx.

Two layers are held against the reference here, exactly (field arithmetic
has no rounding):
  * uzkge_tpu_torch/ff/field.py, the torch-op field (the plain version that
    the CPU runs), against uzkge_tpu/ff/jax_field.py::fr_ctx / fq_ctx;
  * uzkge_tpu_torch/csrc/field.cuh, csrc/fixed_base.cuh,
    csrc/fixed_base_query.cuh and csrc/scan_reduce.cuh, the kernels' own
    arithmetic, compiled with g++ into a small ctypes harness, against fq_ctx
    / fr_ctx, the host curve arithmetic of uzkge_tpu/curve/bn254.py, the
    fixed-base group chains and batch inversion of the JAX package
    (msm/fixed_base.py's padd_g / madd_g, ff/vfield.py's batch_inv, the host
    Fq inverse of ff/field.py for the safegcd root inversion), the JAX
    query kernels' bodies (the select, the pair den / combine with their
    flags, the projective fold's whole tail), and the chain MSM's scan steps
    (_leaf_step, _proj_step, _tree_combine) in the scan kernels' order.
Inputs come from numpy with a fixed seed plus the edge values 0, 1, p-1 and
values near 2^254.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from uzkge_tpu.constants.bn254 import Q_MOD, R_MOD
from uzkge_tpu.curve.bn254 import G1_GEN, g1_add, g1_mul, g1_neg
from uzkge_tpu.ff.jax_field import fq_ctx, fr_ctx
from uzkge_tpu_torch.ff import field as tf

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "uzkge_tpu_torch", "csrc")
CASES = [("fr", R_MOD, fr_ctx, tf.fr), ("fq", Q_MOD, fq_ctx, tf.fq)]


def _values(p: int, count: int, seed: int):
    """Seeded 256-bit draws reduced mod p, plus edge values."""
    rs = np.random.default_rng(seed)
    words = rs.integers(0, 1 << 32, size=(count, 8), dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % p for row in words]
    edge = [0, 1, p - 1, p - 2, (1 << 254) % p, ((1 << 254) - 1) % p, (1 << 253) + 7]
    return vals + edge


def _jax_limbs(ctx, vals):
    return ctx.to_mont_limbs(vals)


@pytest.mark.parametrize("name,p,jctx,tctx", CASES, ids=[c[0] for c in CASES])
def test_field_ops_match_jax(name, p, jctx, tctx):
    a = _values(p, 120, 1)
    b = list(reversed(_values(p, 120, 2)))
    ja, jb = _jax_limbs(jctx, a), _jax_limbs(jctx, b)
    ta, tb = tf.from_jax_limbs(ja, "cpu"), tf.from_jax_limbs(jb, "cpu")
    assert (tf.to_jax_limbs(ta) == ja).all()
    for op in ("add", "sub", "mul"):
        want = np.asarray(getattr(jctx, op)(ja, jb))
        got = tf.to_jax_limbs(getattr(tctx, op)(ta, tb))
        assert (got == want).all(), op
    assert (tf.to_jax_limbs(tctx.neg(ta)) == np.asarray(jctx.neg(ja))).all()
    assert (tf.to_jax_limbs(tctx.from_mont(ta)) == np.asarray(jctx.from_mont(ja))).all()
    assert (tf.to_jax_limbs(tctx.to_mont(ta)) == np.asarray(jctx.to_mont(ja))).all()
    assert tctx.from_mont_limbs(ta) == a
    assert tctx.from_mont_limbs(tctx.mul(ta, tb)) == [x * y % p for x, y in zip(a, b)]
    nz = [v for v in a if v][:6]
    tnz = tctx.to_mont_limbs(nz, "cpu")
    assert tctx.from_mont_limbs(tctx.inv(tnz)) == [pow(v, p - 2, p) for v in nz]
    assert (tf.to_jax_limbs(tctx.batch_inv(tnz)) ==
            np.asarray(jctx.batch_inv(_jax_limbs(jctx, nz)))).all()
    assert tctx.from_mont_limbs(tctx.pow_const(tnz, 5)) == [pow(v, 5, p) for v in nz]


@pytest.mark.parametrize("name,p,jctx,tctx", CASES, ids=[c[0] for c in CASES])
def test_field_codecs_match_jax(name, p, jctx, tctx):
    vals = _values(p, 40, 3)
    jl = _jax_limbs(jctx, vals)
    tl = tctx.to_mont_limbs(vals, "cpu")
    assert (tf.to_jax_limbs(tl) == jl).all()
    assert tctx.to_mont_limbs(vals[0], "cpu").shape == (8,)
    assert tctx.from_mont_limbs(tl[0]) == vals[0]
    blob = jctx.from_mont_bytes(jl)
    assert tctx.from_mont_bytes(tl) == blob
    back = tctx.to_mont_limbs_from_bytes(blob, "cpu")
    assert (tf.to_jax_limbs(back) == np.asarray(jctx.to_mont_limbs_from_bytes(blob))).all()


# ------------------------------------------------ the kernels' own arithmetic

_HARNESS = r"""
#include "fixed_base_query.cuh"
#include "scan_reduce.cuh"
// fb_fold_tile's block on the host: its threads run in turn, so that a
// round's pairs all read (into r) before any is stored; no barrier needed
struct SerialBlock {
  int B;
  G1Proj *r;
  template <class F> void each(F f) { for (int t = 0; t < B; t++) f(t, r[t]); }
  void sync() {}
};
// the lockstep forms, groups of N values at a time (n a multiple of N)
template <class F, int N> void mul_ls(uint32_t *r, const uint32_t *a, const uint32_t *b, int n) {
  for (int i = 0; i < n; i += N) {
    uint32_t x[N][8], y[N][8], z[N][8];
    for (int k = 0; k < N; k++) for (int j = 0; j < 8; j++) {
      x[k][j] = a[8 * (i + k) + j]; y[k][j] = b ? b[8 * (i + k) + j] : 0; }
    if (b) fp_mul_n<F, N>(z, x, y); else fp_sqr_n<F, N>(z, x);
    for (int k = 0; k < N; k++) for (int j = 0; j < 8; j++) r[8 * (i + k) + j] = z[k][j];
  } }
template <class F> void mul_ls_f(uint32_t *r, const uint32_t *a, const uint32_t *b, int n, int N) {
  switch (N) {
    case 1: mul_ls<F, 1>(r, a, b, n); break; case 2: mul_ls<F, 2>(r, a, b, n); break;
    case 3: mul_ls<F, 3>(r, a, b, n); break; case 4: mul_ls<F, 4>(r, a, b, n); break;
    case 5: mul_ls<F, 5>(r, a, b, n); break; case 6: mul_ls<F, 6>(r, a, b, n); break; } }
static void get_p(G1Proj &a, const uint32_t *p) {
  for (int j = 0; j < 8; j++) { a.x[j] = p[j]; a.y[j] = p[8+j]; a.z[j] = p[16+j]; } }
static void put_p(uint32_t *r, const G1Proj &o) {
  for (int j = 0; j < 8; j++) { r[j] = o.x[j]; r[8+j] = o.y[j]; r[16+j] = o.z[j]; } }
template <int G> void dbl_ls(uint32_t *r, const uint32_t *p, int n) {
  for (int i = 0; i < n; i++) {
    G1Proj a; get_p(a, p + 24 * i); g1_dbl_ls<G>(a, a); put_p(r + 24 * i, a); } }
template <int G> void madd_ls(uint32_t *r, const uint32_t *p, const uint32_t *q, int n) {
  for (int i = 0; i < n; i++) {
    G1Proj a; get_p(a, p + 24 * i); g1_madd_ls<G>(a, a, q + 16 * i, q + 16 * i + 8);
    put_p(r + 24 * i, a); } }
extern "C" {
#define BIN(name, F, fn) \
  void name(uint32_t *r, const uint32_t *a, const uint32_t *b, int n) { \
    for (int i = 0; i < n; i++) fn<F>(r + 8 * i, a + 8 * i, b + 8 * i); }
BIN(fr_mul_n, Fr, fp_mul) BIN(fr_add_n, Fr, fp_add) BIN(fr_sub_n, Fr, fp_sub)
BIN(fq_mul_n, Fq, fp_mul) BIN(fq_add_n, Fq, fp_add) BIN(fq_sub_n, Fq, fp_sub)
void fq_neg_n(uint32_t *r, const uint32_t *a, int n) {
  for (int i = 0; i < n; i++) fp_neg<Fq>(r + 8 * i, a + 8 * i); }
void fq_mul9_n(uint32_t *r, const uint32_t *a, int n) {
  for (int i = 0; i < n; i++) fp_mul9<Fq>(r + 8 * i, a + 8 * i); }
void g1_madd_n(uint32_t *r, const uint32_t *p, const uint32_t *q, int n) {
  for (int i = 0; i < n; i++) {
    G1Proj a, o;
    for (int j = 0; j < 8; j++) { a.x[j] = p[24*i+j]; a.y[j] = p[24*i+8+j]; a.z[j] = p[24*i+16+j]; }
    g1_madd(o, a, q + 16 * i, q + 16 * i + 8);
    for (int j = 0; j < 8; j++) { r[24*i+j] = o.x[j]; r[24*i+8+j] = o.y[j]; r[24*i+16+j] = o.z[j]; }
  } }
void g1_padd_n(uint32_t *r, const uint32_t *p, const uint32_t *q, int n) {
  for (int i = 0; i < n; i++) {
    G1Proj a, b, o;
    for (int j = 0; j < 8; j++) { a.x[j] = p[24*i+j]; a.y[j] = p[24*i+8+j]; a.z[j] = p[24*i+16+j];
                                  b.x[j] = q[24*i+j]; b.y[j] = q[24*i+8+j]; b.z[j] = q[24*i+16+j]; }
    g1_padd(o, a, b);
    for (int j = 0; j < 8; j++) { r[24*i+j] = o.x[j]; r[24*i+8+j] = o.y[j]; r[24*i+16+j] = o.z[j]; }
  } }
// b = NULL: squares a
void fr_mul_ls(uint32_t *r, const uint32_t *a, const uint32_t *b, int n, int N) {
  mul_ls_f<Fr>(r, a, b, n, N); }
void fq_mul_ls(uint32_t *r, const uint32_t *a, const uint32_t *b, int n, int N) {
  mul_ls_f<Fq>(r, a, b, n, N); }
void g1_dbl_ls_n(uint32_t *r, const uint32_t *p, int n, int G) {
  switch (G) {
    case 1: dbl_ls<1>(r, p, n); break; case 2: dbl_ls<2>(r, p, n); break;
    case 3: dbl_ls<3>(r, p, n); break; case 4: dbl_ls<4>(r, p, n); break;
    case 5: dbl_ls<5>(r, p, n); break; case 6: dbl_ls<6>(r, p, n); break; } }
void g1_madd_ls_n(uint32_t *r, const uint32_t *p, const uint32_t *q, int n, int G) {
  switch (G) {
    case 1: madd_ls<1>(r, p, q, n); break; case 2: madd_ls<2>(r, p, q, n); break;
    case 3: madd_ls<3>(r, p, q, n); break; case 4: madd_ls<4>(r, p, q, n); break;
    case 5: madd_ls<5>(r, p, q, n); break; case 6: madd_ls<6>(r, p, q, n); break; } }
void g1_identity(uint32_t *r) {
  G1Proj o; g1_set_identity(o);
  for (int j = 0; j < 8; j++) { r[j] = o.x[j]; r[8+j] = o.y[j]; r[16+j] = o.z[j]; }
}
void fb_bases_n(const uint32_t *x, const uint32_t *y, uint32_t *ox, uint32_t *oy, uint32_t *oz,
                int n, int W, int c) {
  for (int i = 0; i < n; i++)
    fb_bases_lane(x + 8 * i, y + 8 * i, ox + 8 * i, oy + 8 * i, oz + 8 * i, W, c, (size_t)n); }
void fb_mult_chunk_n(const uint32_t *tx, const uint32_t *ty, const uint32_t *tz,
                     const uint32_t *bx, const uint32_t *by, uint32_t *ox, uint32_t *oy,
                     uint32_t *oz, uint32_t *fx, uint32_t *fy, uint32_t *fz, int K, int CH) {
  for (int k = 0; k < K; k++) {
    const int o = 8 * k;
    fb_mult_chunk_lane(tx + o, ty + o, tz + o, bx + o, by + o, ox + o, oy + o, oz + o, fx + o,
                       fy + o, fz + o, CH, (size_t)K);
  } }
void fq_inv_down_n(const uint32_t *a, uint32_t *pref, uint32_t *prod, long long M, long long N) {
  for (long long t = 0; t < M; t++) fq_inv_down_lane(a, pref, prod, t, M, N); }
void fq_inv_root_n(const uint32_t *a, uint32_t *pref, uint32_t *out, long long M, long long N) {
  for (long long t = 0; t < M; t++) fq_inv_root_lane(a, pref, out, t, M, N); }
void fq_inv_up_n(const uint32_t *a, const uint32_t *pref, const uint32_t *pinv, uint32_t *out,
                 long long M, long long N) {
  for (long long t = 0; t < M; t++) fq_inv_up_lane(a, pref, pinv, out, t, M, N); }
void fq_inv_mont_n(uint32_t *r, const uint32_t *a, int n) {
  for (int i = 0; i < n; i++) fq_inv_mont(r + 8 * i, a + 8 * i); }
void fb_select_n(const uint32_t *table, const int32_t *digits, uint32_t *x, uint32_t *y,
                 int32_t *inf, long long P, long long K, int D) {
  for (long long t = 0; t < P * K; t++) fb_select_lane(table, digits, x, y, inf, t, K, D); }
void fb_pair_den_n(const uint32_t *x, const int32_t *inf, uint32_t *den, int32_t *flags,
                   long long P, long long H) {
  for (long long t = 0; t < P * H; t++) fb_pair_den_lane(x, inf, den, flags, t, H); }
void fb_pair_combine_n(const uint32_t *x, const uint32_t *y, const uint32_t *dinv,
                       const int32_t *flags, uint32_t *xo, uint32_t *yo, int32_t *info,
                       long long P, long long H) {
  for (long long t = 0; t < P * H; t++) fb_pair_combine_lane(x, y, dinv, flags, xo, yo, info, t, H); }
// one fb_fold launch of blocks of B threads through fb_fold_tile, the
// kernel's own loop, blocks one after another
void fb_fold_n(const uint32_t *X, const uint32_t *Y, const uint32_t *Z, uint32_t *oX, uint32_t *oY,
               uint32_t *oZ, long long tiles, int T, int B) {
  G1Proj *r = new G1Proj[B];
  uint32_t *s = new uint32_t[T / 2 * 24];
  SerialBlock blk{B, r};
  for (long long b = 0; b < tiles; b++)
    fb_fold_tile(blk, X, Y, Z, s, s + T / 2 * 8, s + T / 2 * 16, oX, oY, oZ, b, T);
  delete[] r;
  delete[] s;
}
void scan_leaf_n(const uint32_t *ax, const uint32_t *ay, const int32_t *digits, uint32_t *ox,
                 uint32_t *oy, uint32_t *oz, long long P, long long K, long long n, int S) {
  int lg_n = 0;
  while ((1LL << lg_n) < n) lg_n++;
  for (long long t = 0; t < P * (K / S); t++)
    scan_leaf_lane(ax, ay, digits, ox, oy, oz, (int)t, (int)K, lg_n, S); }
// one scan_proj_reduce launch: a block of min(S / 2, 32) threads per output
// through fb_fold_tile, as scan_proj_reduce_kernel runs it, blocks in turn
void scan_proj_n(const uint32_t *X, const uint32_t *Y, const uint32_t *Z, uint32_t *oX, uint32_t *oY,
                 uint32_t *oZ, long long lanes, int S) {
  const int B = S / 2 < 32 ? S / 2 : 32;
  G1Proj *r = new G1Proj[B];
  uint32_t *s = new uint32_t[S / 2 * 24];
  SerialBlock blk{B, r};
  for (long long t = 0; t < lanes; t++)
    fb_fold_tile(blk, X, Y, Z, s, s + S / 2 * 8, s + S / 2 * 16, oX, oY, oZ, t, S);
  delete[] r;
  delete[] s;
}
}
"""


@pytest.fixture(scope="module")
def header_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ on this machine")
    d = tmp_path_factory.mktemp("fieldh")
    src = d / "harness.cpp"
    src.write_text(_HARNESS)
    so = d / "harness.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", CSRC,
                    "-o", str(so), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for fn in ("fr_mul_n", "fr_add_n", "fr_sub_n", "fq_mul_n", "fq_add_n", "fq_sub_n",
               "g1_madd_n", "g1_padd_n"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    for fn in ("fq_neg_n", "fq_mul9_n", "fq_inv_mont_n"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    for fn in ("fr_mul_ls", "fq_mul_ls", "g1_madd_ls_n"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    lib.g1_dbl_ls_n.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
    lib.g1_identity.argtypes = [ctypes.c_void_p]
    lib.fb_bases_n.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    lib.fb_mult_chunk_n.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 2
    lib.fq_inv_down_n.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
    lib.fq_inv_root_n.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
    lib.fq_inv_up_n.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
    ll = ctypes.c_longlong
    lib.fb_select_n.argtypes = [ctypes.c_void_p] * 5 + [ll, ll, ctypes.c_int]
    lib.fb_pair_den_n.argtypes = [ctypes.c_void_p] * 4 + [ll, ll]
    lib.fb_pair_combine_n.argtypes = [ctypes.c_void_p] * 7 + [ll, ll]
    lib.fb_fold_n.argtypes = [ctypes.c_void_p] * 6 + [ll, ctypes.c_int, ctypes.c_int]
    lib.scan_leaf_n.argtypes = [ctypes.c_void_p] * 6 + [ll, ll, ll, ctypes.c_int]
    lib.scan_proj_n.argtypes = [ctypes.c_void_p] * 6 + [ll, ctypes.c_int]
    return lib


def _u32(jl):
    """(N, 16) JAX limbs -> contiguous (N, 8) uint32 buffer of 32-bit limbs."""
    return np.ascontiguousarray(tf.from_jax_limbs(jl, "cpu").numpy().view(np.uint32))


def _call(fn, width, *bufs):
    n = bufs[0].shape[0]
    out = np.zeros((n, width), np.uint32)
    fn(out.ctypes.data, *[b.ctypes.data for b in bufs], n)
    return out


@pytest.mark.parametrize("name,p,jctx,tctx", CASES, ids=[c[0] for c in CASES])
def test_field_header_matches_jax(header_lib, name, p, jctx, tctx):
    a = _values(p, 100, 4)
    b = list(reversed(_values(p, 100, 5)))
    ja, jb = _jax_limbs(jctx, a), _jax_limbs(jctx, b)
    ua, ub = _u32(ja), _u32(jb)
    for op in ("mul", "add", "sub"):
        got = _call(getattr(header_lib, f"{name}_{op}_n"), 8, ua, ub)
        want = tf.from_jax_limbs(np.asarray(getattr(jctx, op)(ja, jb)), "cpu").numpy().view(np.uint32)
        assert (got == want).all(), op
    if name == "fq":
        got = np.zeros_like(ua)
        header_lib.fq_neg_n(got.ctypes.data, ua.ctypes.data, len(a))
        want = tf.from_jax_limbs(np.asarray(jctx.neg(ja)), "cpu").numpy().view(np.uint32)
        assert (got == want).all()
        header_lib.fq_mul9_n(got.ctypes.data, ua.ctypes.data, len(a))  # the curves' b3 = 9
        nine = _jax_limbs(jctx, [9] * len(a))
        want = tf.from_jax_limbs(np.asarray(jctx.mul(ja, nine)), "cpu").numpy().view(np.uint32)
        assert (got == want).all()


def _proj_rows(points, zs):
    """Affine host points (None = identity) -> (N, 24) uint32 projective rows
    in Fq Montgomery form, scaled by the given nonzero z's."""
    rows = []
    for pt, z in zip(points, zs):
        X, Y, Z = (0, 1, 0) if pt is None else (pt[0] * z % Q_MOD, pt[1] * z % Q_MOD, z)
        rows.append(tf.fq.to_mont_limbs([X, Y, Z], "cpu").numpy().view(np.uint32).reshape(24))
    return np.stack(rows)


def _affine(rows):
    out = []
    for r in rows:
        X, Y, Z = tf.fq.from_mont_limbs(torch.from_numpy(r.view(np.int32).reshape(3, 8)))
        if Z == 0:
            out.append(None)
        else:
            zi = pow(Z, Q_MOD - 2, Q_MOD)
            out.append((X * zi % Q_MOD, Y * zi % Q_MOD))
    return out


def test_curve_header_matches_host_bn254(header_lib):
    """RCB mixed (Alg. 8) and projective (Alg. 7) additions of the header
    against curve/bn254.py, including identity, doubling and P + (-P)."""
    rs = np.random.default_rng(6)
    ks = [int(k) for k in rs.integers(1, 1 << 62, size=12)]
    pts = [g1_mul(G1_GEN, k) for k in ks]
    lhs = pts[:6] + [None, pts[0], pts[1], None]
    rhs = pts[6:] + [pts[2], pts[0], g1_neg(pts[1]), pts[3]]
    zs = [int(z) % Q_MOD or 1 for z in rs.integers(2, 1 << 62, size=len(lhs))]
    want = [g1_add(x, y) for x, y in zip(lhs, rhs)]

    P = _proj_rows(lhs, zs)
    aff = np.stack([tf.fq.to_mont_limbs([q[0], q[1]], "cpu").numpy().view(np.uint32).reshape(16)
                    for q in rhs])
    got = _call(header_lib.g1_madd_n, 24, P, aff)
    assert _affine(got) == want

    Q = _proj_rows(rhs + [None], zs[::-1] + [1])
    P2 = _proj_rows(lhs + [None], zs + [1])
    got = _call(header_lib.g1_padd_n, 24, P2, Q)
    assert _affine(got) == want + [None]

    ident = np.zeros(24, np.uint32)
    header_lib.g1_identity(ident.ctypes.data)
    assert _affine(ident[None]) == [None]


@pytest.mark.parametrize("N", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("name,p,jctx,tctx", CASES, ids=[c[0] for c in CASES])
def test_lockstep_products_match_fp_mul(header_lib, name, p, jctx, tctx, N):
    """fp_mul_n (N products in lockstep) and fp_sqr_n, compiled by g++,
    against fp_mul limb for limb on 1020 seeded values with 0, 1, p - 1 and
    values near 2^254 among them (their product by fp_mul is held against
    the JAX package above)."""
    a = _values(p, 1013, 40 + N)
    b = list(reversed(_values(p, 1013, 50 + N)))
    assert len(a) % N == 0
    ua, ub = (tctx.to_mont_limbs(v, "cpu").numpy().view(np.uint32).copy() for v in (a, b))
    want = _call(getattr(header_lib, f"{name}_mul_n"), 8, ua, ub)
    lock = getattr(header_lib, f"{name}_mul_ls")
    got = np.zeros_like(ua)
    lock(got.ctypes.data, ua.ctypes.data, ub.ctypes.data, len(a), N)
    assert (got == want).all()
    want = _call(getattr(header_lib, f"{name}_mul_n"), 8, ua, ua)
    lock(got.ctypes.data, ua.ctypes.data, None, len(a), N)
    assert (got == want).all()


def _lockstep_points():
    """Projective rows T (random z's) and affine rows B for the lockstep
    curve tests: random pairs, then T the identity, T = B, T = -B."""
    rs = np.random.default_rng(41)
    pts = [g1_mul(G1_GEN, int(k)) for k in rs.integers(1, 1 << 62, size=15)]
    lhs = pts[:6] + [None, pts[12], pts[13]]
    rhs = pts[6:12] + [pts[14], pts[12], g1_neg(pts[13])]
    zs = [int(z) % Q_MOD or 1 for z in rs.integers(2, 1 << 62, size=len(lhs))]
    aff = np.stack([tf.fq.to_mont_limbs([q[0], q[1]], "cpu").numpy().view(np.uint32).reshape(16)
                    for q in rhs])
    return _proj_rows(lhs, zs), aff, lhs, rhs


@pytest.mark.parametrize("G", [6, 5, 4, 3, 2, 1])
def test_lockstep_double_matches_padd(header_lib, G):
    """g1_dbl_ls (RCB Alg. 7 with P = Q: six squarings, then six products,
    in lockstep groups of at most G), compiled by g++, against g1_padd(T, T,
    T) limb for limb, the identity among the T's; and against the host
    doubling."""
    T, _, lhs, _ = _lockstep_points()
    want = _call(header_lib.g1_padd_n, 24, T, T)
    got = np.zeros_like(T)
    header_lib.g1_dbl_ls_n(got.ctypes.data, T.ctypes.data, len(T), G)
    assert (got == want).all()
    assert _affine(got) == [g1_add(q, q) for q in lhs]


@pytest.mark.parametrize("G", [6, 5, 4, 3, 2, 1])
def test_lockstep_madd_matches_madd(header_lib, G):
    """g1_madd_ls (RCB Alg. 8, products in lockstep groups of at most G),
    compiled by g++, against g1_madd limb for limb: random points, T the
    identity, T = B and T = -B; and against the host addition."""
    T, aff, lhs, rhs = _lockstep_points()
    want = _call(header_lib.g1_madd_n, 24, T, aff)
    got = np.zeros_like(T)
    header_lib.g1_madd_ls_n(got.ctypes.data, T.ctypes.data, aff.ctypes.data, len(T), G)
    assert (got == want).all()
    assert _affine(got) == [g1_add(x, y) for x, y in zip(lhs, rhs)]


def _jax_v(vals):
    """python ints -> the JAX package's (16, N) Fq Montgomery layout."""
    import jax.numpy as jnp

    return jnp.moveaxis(fq_ctx.to_mont_limbs(vals).reshape(len(vals), 16), -1, 0)


def _rows_of_v(v):
    """(16, N) JAX layout -> contiguous (N, 8) uint32 rows of 32-bit limbs."""
    return _u32(np.moveaxis(np.asarray(v), 0, -1))


def test_fixed_base_chains_match_jax(header_lib):
    """fixed_base.cuh's lanes, compiled by g++: the doubling chain of
    fb_bases (W = 3, c = 2) against padd_g(T, T) over the JAX package's
    vfield, and the multiple chain of fb_mult_chunk (CH = 3) against
    madd_g, both on projective coordinates, exactly."""
    from uzkge_tpu.ff.vfield import vfq
    from uzkge_tpu.msm.fixed_base import madd_g, padd_g

    n, W, c, CH = 5, 3, 2, 3
    rs = np.random.default_rng(8)
    pts = [g1_mul(G1_GEN, int(k)) for k in rs.integers(1, 1 << 62, size=2 * n)]
    x, y = _jax_v([p[0] for p in pts[:n]]), _jax_v([p[1] for p in pts[:n]])
    T = (x, y, vfq.one_mont_like(x))
    emitted = []
    for w in range(W):
        emitted.append(T)
        if w + 1 < W:
            for _ in range(c):
                T = padd_g(vfq, T, T)
    ins = [_rows_of_v(x), _rows_of_v(y)]
    outs = [np.zeros((W * n, 8), np.uint32) for _ in range(3)]
    header_lib.fb_bases_n(*(a.ctypes.data for a in ins + outs), n, W, c)
    for j in range(3):
        want = np.concatenate([_rows_of_v(e[j]) for e in emitted])
        assert (outs[j] == want).all(), j

    T = emitted[-1]  # projective, Z != 1
    bx, by = _jax_v([p[0] for p in pts[n:]]), _jax_v([p[1] for p in pts[n:]])
    emitted = []
    for _ in range(CH):
        emitted.append(T)
        T = madd_g(vfq, T, (bx, by))
    ins = [_rows_of_v(v) for v in (*emitted[0], bx, by)]
    outs = [np.zeros((CH * n, 8), np.uint32) for _ in range(3)]
    fin = [np.zeros((n, 8), np.uint32) for _ in range(3)]
    header_lib.fb_mult_chunk_n(*(a.ctypes.data for a in ins + outs + fin), n, CH)
    for j in range(3):
        assert (outs[j] == np.concatenate([_rows_of_v(e[j]) for e in emitted])).all(), j
        assert (fin[j] == _rows_of_v(T[j])).all(), j


def _inv_values():
    """The inversion tests' values: {test: nonzero Fq values}."""
    sweep = [v or 1 for v in _values(Q_MOD, 4500 - 7, 9)]
    sweep[:2] = [Q_MOD - 1, 1]
    root = [v for v in _values(Q_MOD, 1200, 10) if v]
    root += [1, 2, Q_MOD - 1, (1 << 256) % Q_MOD] + [1 << k for k in range(254)]
    return {"sweep": sweep, "root": root}


@pytest.fixture(scope="module")
def vfq_inverses():
    """{test: vfq.batch_inv of its values as (N, 8) uint32 rows}, from one
    batch_inv over all of them (its eager Fermat root takes ~30 s here)."""
    from uzkge_tpu.ff.vfield import vfq

    vals = _inv_values()
    allinv = _rows_of_v(vfq.batch_inv(_jax_v(vals["sweep"] + vals["root"])))
    return {"sweep": allinv[: len(vals["sweep"])], "root": allinv[len(vals["sweep"]) :]}


def test_fq_inv_mont_matches_host_fq(header_lib, vfq_inverses):
    """fq_inv_mont, the safegcd root inversion (Montgomery in and out),
    compiled by g++, against the host Fq inverse of ff/field.py and
    vfq.batch_inv on 1200 seeded values, the edge values, R mod q and every
    power of two below q; 0 maps to 0."""
    from uzkge_tpu.ff.field import Fq

    vals = _inv_values()["root"]
    a = _rows_of_v(_jax_v(vals))
    got = np.zeros_like(a)
    header_lib.fq_inv_mont_n(got.ctypes.data, a.ctypes.data, len(vals))
    assert tf.fq.from_mont_limbs(torch.from_numpy(got.view(np.int32))) == [Fq.inv(v) for v in vals]
    assert (got == vfq_inverses["root"]).all()
    zero = np.zeros((1, 8), np.uint32)
    header_lib.fq_inv_mont_n(got.ctypes.data, zero.ctypes.data, 1)
    assert not got[0].any()


@pytest.mark.parametrize("roots", [None, 2], ids=["root-level-only", "three-levels"])
def test_fq_batch_inv_sweeps_match_jax(header_lib, vfq_inverses, roots):
    """fq_batch_inv's lanes, compiled by g++, driven through the product tree
    of fixed_base.batch_inv_levels as the wrapper drives the kernels (the
    down sweeps, the last level's sweep-invert-sweep lane, the up sweeps in
    place over the prefixes), against vfq.batch_inv, at N = 4500 with p - 1
    and 1: the wrapper's cut (one level of 282 ragged strided groups), and a
    cut at 2 roots (levels of 282, 18 and 2 groups)."""
    from uzkge_tpu_torch.msm.fixed_base import INV_ROOTS, batch_inv_levels

    N = 4500
    a = _rows_of_v(_jax_v(_inv_values()["sweep"]))
    levels = batch_inv_levels(N, roots=roots or INV_ROOTS)
    assert levels == ([(N, 282)] if roots is None else [(N, 282), (282, 18), (18, 2)])
    cur, down = a, []
    for n_l, m_l in levels[:-1]:
        pref, prod = np.zeros((n_l, 8), np.uint32), np.zeros((m_l, 8), np.uint32)
        header_lib.fq_inv_down_n(cur.ctypes.data, pref.ctypes.data, prod.ctypes.data, m_l, n_l)
        down.append((cur, pref))
        cur = prod
    n_l, m_l = levels[-1]
    inv = np.zeros((n_l, 8), np.uint32)
    header_lib.fq_inv_root_n(cur.ctypes.data, inv.ctypes.data, inv.ctypes.data, m_l, n_l)
    for (src, pref), (n_l, m_l) in zip(reversed(down), reversed(levels[:-1])):
        header_lib.fq_inv_up_n(src.ctypes.data, pref.ctypes.data, inv.ctypes.data,
                               pref.ctypes.data, m_l, n_l)
        inv = pref
    assert (inv == vfq_inverses["sweep"]).all()


# ------------------------------------------- the query kernels' arithmetic


def _q_vals(rs, shape):
    """Seeded canonical Fq values as a (..., 8) uint32 buffer."""
    n = int(np.prod(shape))
    vals = [v % Q_MOD for v in _values(Q_MOD, n, int(rs.integers(1 << 30)))[:n]]
    return np.ascontiguousarray(tf.ints_to_limbs(vals).view(np.uint32).reshape(shape + (8,)))


def _jv(a):
    """(..., 8) uint32 buffer -> the JAX package's (16, ...) layout (jnp)."""
    import jax.numpy as jnp

    return jnp.asarray(np.moveaxis(tf.to_jax_limbs(torch.from_numpy(a.view(np.int32))), -1, 0))


def _from_jv(v):
    return _u32(np.moveaxis(np.asarray(v), 0, -1))


def _p(a):
    return a.ctypes.data


def test_query_select_header_matches_jax(header_lib):
    """fb_select_lane against _select_kernel's body (one block), P = 2, K = 16,
    D = 4: digits over [-D, D], one out of range."""
    from uzkge_tpu.msm.fixed_base import _select_kernel

    P, K, D = 2, 16, 4
    rs = np.random.default_rng(31)
    table = _q_vals(rs, (K, D, 2)).reshape(K, D, 16)
    digits = np.ascontiguousarray(rs.integers(-D, D + 1, size=(P, K)).astype(np.int32))
    digits[0, :2] = [0, -D - 1]
    vertical = table.view(np.uint16).reshape(K, D, 32).transpose(1, 2, 0)
    jx, jy = np.zeros((16, P, K), np.uint32), np.zeros((16, P, K), np.uint32)
    jinf = np.zeros((P, K), np.uint32)
    _select_kernel(P, D, vertical, digits, jx, jy, jinf)
    x, y = np.zeros((P, K, 8), np.uint32), np.zeros((P, K, 8), np.uint32)
    inf = np.zeros((P, K), np.int32)
    header_lib.fb_select_n(_p(table), _p(digits), _p(x), _p(y), _p(inf), P, K, D)
    assert (x == _from_jv(jx)).all() and (y == _from_jv(jy)).all() and (inf == jinf).all()


def test_query_pair_header_matches_jax(header_lib):
    """fb_pair_den_lane and fb_pair_combine_lane against the bodies of
    _pair_den_small_kernel and _pair_combine_small_kernel at P = 2, H = 8,
    with every flag planted: both sides the identity, one side, x1 == x2
    (degenerate: the identity out), x1 == x2 beside an identity (passed
    through); dinv from vfq.batch_inv."""
    from uzkge_tpu.ff.vfield import vfq
    from uzkge_tpu.msm.fixed_base import _pair_combine_small_kernel, _pair_den_small_kernel

    P, H = 2, 8
    rs = np.random.default_rng(32)
    x, y = _q_vals(rs, (P, 2 * H)), _q_vals(rs, (P, 2 * H))
    inf = np.zeros((P, 2 * H), np.int32)
    inf[0, [0, H, 1, 2 + H]] = 1  # pair 0: both; 1: first; 2: second
    x[1, 3 + H] = x[1, 3]  # pair 3 of MSM 1: degenerate
    x[1, 4 + H] = x[1, 4]
    inf[1, 4 + H] = 1  # pair 4: equal x beside an identity
    jden, jflags = np.zeros((16, P, H), np.uint32), np.zeros((P, H), np.uint32)
    _pair_den_small_kernel(H, _jv(x), inf.astype(np.uint32), jden, jflags)
    den, flags = np.zeros((P, H, 8), np.uint32), np.zeros((P, H), np.int32)
    header_lib.fb_pair_den_n(_p(x), _p(inf), _p(den), _p(flags), P, H)
    assert (den == _from_jv(jden)).all() and (flags == jflags).all()
    assert flags[0, :3].tolist() == [3, 1, 2] and flags[1, 3:5].tolist() == [4, 2]

    dinv = _from_jv(vfq.batch_inv(_jv(den).reshape(16, P * H)).reshape(16, P, H))
    jxo, jyo = np.zeros((16, P, H), np.uint32), np.zeros((16, P, H), np.uint32)
    jinf = np.zeros((P, H), np.uint32)
    _pair_combine_small_kernel(H, _jv(x), _jv(y), _jv(dinv), jflags, jxo, jyo, jinf)
    xo, yo = np.zeros((P, H, 8), np.uint32), np.zeros((P, H, 8), np.uint32)
    info = np.zeros((P, H), np.int32)
    header_lib.fb_pair_combine_n(_p(x), _p(y), _p(dinv), _p(flags), _p(xo), _p(yo), _p(info),
                                 P, H)
    assert (xo == _from_jv(jxo)).all() and (yo == _from_jv(jyo)).all() and (info == jinf).all()
    assert info[0, :3].tolist() == [1, 0, 0] and info[1, 3:5].tolist() == [1, 0]
    assert (xo[0, 1] == x[0, 1 + H]).all() and (yo[0, 2] == y[0, 2]).all()  # pass-through


def _jax_fold_tail(X, Y, Z):
    """The JAX query's projective tail over (P, Kc, 8) buffers: the
    _fold8_kernel body while 8 divides Kc, then the remainder's halving by
    padd_g in afield (lazy [0, 2p) values)."""
    from uzkge_tpu.ff.afield import afq_c
    from uzkge_tpu.msm.fixed_base import _fold8_kernel, padd_g

    P, Kc = X.shape[:2]
    pts = [_jv(t) for t in (X, Y, Z)]  # (16, P, Kc)
    while Kc % 8 == 0:
        lay = [t.reshape(16, P, Kc // 8, 8).transpose(0, 3, 1, 2) for t in pts]
        out = [np.zeros((16, P, Kc // 8), np.uint32) for _ in range(3)]
        _fold8_kernel(*lay, *out)
        pts, Kc = out, Kc // 8
    while Kc > 1:
        h = Kc // 2
        pts = padd_g(afq_c, tuple(t[..., :h] for t in pts), tuple(t[..., h:] for t in pts))
        Kc = h
    return [t[..., 0] for t in pts]


@pytest.mark.parametrize("Kc", [1024, 128, 4, 2])
def test_query_fold_header_matches_jax(header_lib, Kc):
    """fb_fold's block loop (fb_fold_tile), compiled by g++ and run with its
    threads in turn, blocks of 32 threads (several rounds of pairs per step
    in a tile of 512), over the launches of fixed_base.fold_tiles (Kc = 1024:
    tiles of 512, then 2; 128 = 8^2 * 2, and the remainders 4 and 2: one
    launch),
    against the JAX query's tail (the _fold8_kernel body, then padd_g over
    the remainder) at P = 2, identities planted, compared mod p."""
    from uzkge_tpu_torch.msm.fixed_base import fold_tiles

    P = 2
    rs = np.random.default_rng(33 + Kc)
    X, Y, Z = (_q_vals(rs, (P, Kc)) for _ in range(3))
    ident = rs.random((P, Kc)) < 0.3
    X[ident], Z[ident] = 0, 0
    Y[ident] = _u32(fq_ctx.to_mont_limbs([1]))[0]
    want = _jax_fold_tail(X, Y, Z)
    tiles = fold_tiles(Kc)
    assert tiles == {1024: [512, 2], 128: [128], 4: [4], 2: [2]}[Kc]
    for T in tiles:
        out = [np.zeros((P, X.shape[1] // T, 8), np.uint32) for _ in range(3)]
        header_lib.fb_fold_n(_p(X), _p(Y), _p(Z), *(_p(o) for o in out), P * X.shape[1] // T, T,
                             32)
        X, Y, Z = out
    for o, wv in zip((X, Y, Z), want):
        got = tf.limbs_to_ints(o.reshape(P, 8).view(np.int32))
        ref = tf.limbs_to_ints(_from_jv(wv).view(np.int32))
        assert [v % Q_MOD for v in got] == [v % Q_MOD for v in ref] and max(got) < Q_MOD


# ------------------------------------------- the chain MSM's scan arithmetic


def _il2_scan(step, S, like):
    """The scan kernels' order over vfq: two running sums from the identity,
    step s into sum s % 2, then _tree_combine."""
    from uzkge_tpu.ff.vfield import vfq
    from uzkge_tpu.msm.fixed_base import _identity, _tree_combine

    accs = [_identity(vfq, like) for _ in range(2)]
    for s in range(S):
        accs[s % 2] = step(vfq, accs[s % 2], s)
    return _tree_combine(vfq, accs)


def test_scan_lanes_match_jax(header_lib):
    """scan_reduce.cuh's leaf lane, compiled by g++, against the JAX package's
    _leaf_step over vfq in the scan kernel's order (P = 2, n = 4, W = 4, S =
    8, a lane of zero digits), limb for limb; the projective round
    (fb_fold_tile, as scan_proj_reduce_kernel runs it) over S = 4 and 16
    consecutive points against _proj_step's running sums as affine points
    (the tree adds in another order), identities among the points."""
    from uzkge_tpu.msm.fixed_base import _leaf_step, _proj_step

    P, n, W, S = 2, 4, 4, 8
    K = W * n
    lanes = P * K // S
    rs = np.random.default_rng(34)
    ax, ay = _q_vals(rs, (2 * K,)), _q_vals(rs, (2 * K,))
    digits = np.ascontiguousarray(rs.integers(-2, 3, size=(P, K)).astype(np.int32))
    digits[1, :S] = 0
    out = [np.zeros((lanes, 8), np.uint32) for _ in range(3)]
    header_lib.scan_leaf_n(_p(ax), _p(ay), _p(digits), *(_p(o) for o in out), P, K, n, S)
    k = np.arange(K)
    rows = (2 * (k // n) + np.maximum(np.abs(digits) - 1, 0)) * n + k % n  # (P, K)
    def lay(a):  # [s, p*J + j] = leaf j*S + s of MSM p
        return np.ascontiguousarray(np.swapaxes(a.reshape((lanes, S) + a.shape[2:]), 0, 1))

    gx, gy, d = lay(ax[rows]), lay(ay[rows]), lay(digits)
    want = _il2_scan(lambda f, acc, s: _leaf_step(f, acc, _jv(gx[s]), _jv(gy[s]), d[s]), S,
                     _jv(gx[0]))
    for o, wv in zip(out, want):
        assert (o == _from_jv(wv)).all()
    assert _from_jv(want[2])[lanes // 2].tolist() == [0] * 8  # the zero-digit lane

    for S, lanes in ((4, 6), (16, 3)):
        ks = rs.integers(1, 1 << 62, size=lanes * S)
        pts = [None if rs.random() < 0.2 else g1_mul(G1_GEN, int(k)) for k in ks]
        rows = _proj_rows(pts, [int(z) for z in rs.integers(1, 1 << 62, size=lanes * S)])
        X, Y, Z = (np.ascontiguousarray(rows[:, 8 * i:8 * i + 8]) for i in range(3))
        out = [np.zeros((lanes, 8), np.uint32) for _ in range(3)]
        header_lib.scan_proj_n(_p(X), _p(Y), _p(Z), *(_p(o) for o in out), lanes, S)
        cols = [t.reshape(lanes, S, 8) for t in (X, Y, Z)]
        want = _il2_scan(lambda f, acc, s: _proj_step(f, acc, *(_jv(c[:, s]) for c in cols)), S,
                         _jv(cols[0][:, 0]))
        got = _affine(np.concatenate(out, axis=1))
        assert got == _affine(np.concatenate([_from_jv(w) for w in want], axis=1)), f"S = {S}"
        assert got == [_host_sum(pts[t * S:(t + 1) * S]) for t in range(lanes)]


def _host_sum(pts):
    acc = None
    for p in pts:
        acc = g1_add(acc, p)
    return acc
