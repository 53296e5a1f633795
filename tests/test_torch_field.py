"""The torch port's field arithmetic against the JAX package's MontCtx.

Two layers are held against the reference here, exactly (field arithmetic
has no rounding):
  * uzkge_tpu_torch/ff/field.py, the torch-op field (the plain version that
    the CPU runs), against uzkge_tpu/ff/jax_field.py::fr_ctx / fq_ctx;
  * uzkge_tpu_torch/csrc/field.cuh, the kernels' own arithmetic, compiled
    with g++ into a small ctypes harness, against fq_ctx / fr_ctx and the
    host curve arithmetic of uzkge_tpu/curve/bn254.py.
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
    ta, tb = tf.from_jax_limbs(ja), tf.from_jax_limbs(jb)
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
    tnz = tctx.to_mont_limbs(nz)
    assert tctx.from_mont_limbs(tctx.inv(tnz)) == [pow(v, p - 2, p) for v in nz]
    assert (tf.to_jax_limbs(tctx.batch_inv(tnz)) ==
            np.asarray(jctx.batch_inv(_jax_limbs(jctx, nz)))).all()
    assert tctx.from_mont_limbs(tctx.pow_const(tnz, 5)) == [pow(v, 5, p) for v in nz]


@pytest.mark.parametrize("name,p,jctx,tctx", CASES, ids=[c[0] for c in CASES])
def test_field_codecs_match_jax(name, p, jctx, tctx):
    vals = _values(p, 40, 3)
    jl = _jax_limbs(jctx, vals)
    tl = tctx.to_mont_limbs(vals)
    assert (tf.to_jax_limbs(tl) == jl).all()
    assert tctx.to_mont_limbs(vals[0]).shape == (8,)
    assert tctx.from_mont_limbs(tl[0]) == vals[0]
    blob = jctx.from_mont_bytes(jl)
    assert tctx.from_mont_bytes(tl) == blob
    back = tctx.to_mont_limbs_from_bytes(blob)
    assert (tf.to_jax_limbs(back) == np.asarray(jctx.to_mont_limbs_from_bytes(blob))).all()


# ------------------------------------------------ the kernels' own arithmetic

_HARNESS = r"""
#include "field.cuh"
extern "C" {
#define BIN(name, F, fn) \
  void name(uint32_t *r, const uint32_t *a, const uint32_t *b, int n) { \
    for (int i = 0; i < n; i++) fn<F>(r + 8 * i, a + 8 * i, b + 8 * i); }
BIN(fr_mul_n, Fr, fp_mul) BIN(fr_add_n, Fr, fp_add) BIN(fr_sub_n, Fr, fp_sub)
BIN(fq_mul_n, Fq, fp_mul) BIN(fq_add_n, Fq, fp_add) BIN(fq_sub_n, Fq, fp_sub)
void fq_neg_n(uint32_t *r, const uint32_t *a, int n) {
  for (int i = 0; i < n; i++) fp_neg<Fq>(r + 8 * i, a + 8 * i); }
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
void g1_identity(uint32_t *r) {
  G1Proj o; g1_set_identity(o);
  for (int j = 0; j < 8; j++) { r[j] = o.x[j]; r[8+j] = o.y[j]; r[16+j] = o.z[j]; }
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
    lib.fq_neg_n.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    lib.g1_identity.argtypes = [ctypes.c_void_p]
    return lib


def _u32(jl):
    """(N, 16) JAX limbs -> contiguous (N, 8) uint32 buffer of 32-bit limbs."""
    return np.ascontiguousarray(tf.from_jax_limbs(jl).numpy().view(np.uint32))


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
        want = tf.from_jax_limbs(np.asarray(getattr(jctx, op)(ja, jb))).numpy().view(np.uint32)
        assert (got == want).all(), op
    if name == "fq":
        got = np.zeros_like(ua)
        header_lib.fq_neg_n(got.ctypes.data, ua.ctypes.data, len(a))
        want = tf.from_jax_limbs(np.asarray(jctx.neg(ja))).numpy().view(np.uint32)
        assert (got == want).all()


def _proj_rows(points, zs):
    """Affine host points (None = identity) -> (N, 24) uint32 projective rows
    in Fq Montgomery form, scaled by the given nonzero z's."""
    rows = []
    for pt, z in zip(points, zs):
        X, Y, Z = (0, 1, 0) if pt is None else (pt[0] * z % Q_MOD, pt[1] * z % Q_MOD, z)
        rows.append(tf.fq.to_mont_limbs([X, Y, Z]).numpy().view(np.uint32).reshape(24))
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
    aff = np.stack([tf.fq.to_mont_limbs([q[0], q[1]]).numpy().view(np.uint32).reshape(16)
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
