"""The torch port's fixed-base table build against the JAX package's, exactly.

Field arithmetic has no rounding, so every comparison is exact:
  * the whole table, uzkge_tpu_torch/msm/fixed_base.py::FixedBaseTable on the
    CPU (the plain versions) against uzkge_tpu/msm/fixed_base.py::
    FixedBaseTable on the CPU (its plain reference path), byte for byte, at
    (n, c, bits) = (8, 8, 254) (the production window count, W = 32, over
    all eight chunks, on Lagrange bases through KZG.lagrange_fb_table),
    (128, 8, 14) and (32, 4, 30); fixed_base_table_from_jax round-trips them;
  * the two build stages, _build_bases and one _build_chunk;
  * fq_batch_inv against pbatch_inv_fq, and fp_mont_mul against the Pallas
    _mul_kernel body run by the Pallas interpreter;
  * on a card (marker on_cuda), the four kernels against their plain versions,
    and the device Montgomery product (fp_mont_mul, fp_mul_chain) against
    the host's integers.
The JAX tables, whose first build is mostly XLA compile time, are built once
for the module, in threads.  JAX is imported inside the fixtures and tests
that use it, so that the on_cuda tests also run where JAX is absent
(`pytest --noconftest -m on_cuda`).
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from uzkge_tpu_torch import kernels
from uzkge_tpu_torch.constants.bn254 import Q_MOD, R_MOD
from uzkge_tpu_torch.curve.bn254 import G1_GEN, g1_mul
from uzkge_tpu_torch.errors import ParameterError
from uzkge_tpu_torch.ff import field as tf
from uzkge_tpu_torch.ff.cuda_field import (CHAINS, fp_mont_mul, fp_mont_mul_plain, fp_mul_chain,
                                          fp_mul_chain_plain)
from uzkge_tpu_torch.msm import fixed_base as fb
from uzkge_tpu_torch.pcs.kzg import KZG, _fb_window

from .test_pallas_kernels import interpret_pallas  # noqa: F401

torch.set_num_threads(1)

CASES = [(8, 8, 254), (128, 8, 14), (32, 4, 30)]
TAU = 987654321987654321


def _points(n: int, seed: int):
    rs = np.random.default_rng(seed)
    return [g1_mul(G1_GEN, int(k)) for k in rs.integers(1, 1 << 62, size=n)]


def _lagrange_kzg():
    """A CPU KZG whose 8 Lagrange bases are the (8, 8, 254) case's points."""
    return KZG.setup_insecure(9, tau=TAU, domain_n=8, device="cpu")


def _case_points(n: int):
    return _lagrange_kzg()._lagrange_points if n == 8 else _points(n, n)


@pytest.fixture(scope="module")
def jax_tables():
    """{(n, c, bits): (points, the JAX package's FixedBaseTable)}."""
    from uzkge_tpu.msm.fixed_base import FixedBaseTable as JaxTable

    def build(case):
        pts = _case_points(case[0])
        tbl = JaxTable(pts, c=case[1], bits=case[2])
        np.asarray(tbl.table)  # wait for the device arrays
        return case, (pts, tbl)

    with ThreadPoolExecutor(len(CASES)) as ex:
        return dict(ex.map(build, CASES))


def _vertical(tbl):
    """The (D, 32, K) layout of the JAX package's TPU path, from its CPU
    table: t[d - 1, :, k] = row k*D + (d - 1)."""
    class Vertical:
        D = tbl.D
        table = np.asarray(tbl.table).reshape(-1, tbl.D, 32).transpose(1, 2, 0)
    return Vertical


@pytest.mark.parametrize("n,c,bits", CASES, ids=[f"n{n}-c{c}-bits{b}" for n, c, b in CASES])
def test_table_matches_jax(jax_tables, n, c, bits):
    pts, jt = jax_tables[(n, c, bits)]
    if n == 8:  # through the public entry point, with _fb_window's c = 8
        kzg = _lagrange_kzg()
        tt = kzg.lagrange_fb_table()
        assert kzg.lagrange_fb_table() is tt and (tt.c, tt.bits) == (c, bits)
    else:
        tt = fb.FixedBaseTable(pts, c=c, bits=bits, device="cpu")
    K, D = tt.W * n, 1 << (c - 1)
    assert (tt.W, tt.D) == (jt.W, jt.D) and tt.table.shape == (K, D, 16)
    want = np.asarray(jt.table)
    assert want.shape == (K * D, 32)
    assert np.array_equal(tt.table.numpy().view(np.uint16).reshape(K * D, 32), want)
    assert torch.equal(fb.fixed_base_table_from_jax(jt, "cpu"), tt.table)
    assert torch.equal(fb.fixed_base_table_from_jax(_vertical(jt), "cpu"), tt.table)


def test_fb_window_matches_jax_tpu_rule(monkeypatch):
    from uzkge_tpu.ff import pallas_field
    from uzkge_tpu.pcs.kzg import _fb_window as jax_fb_window

    monkeypatch.setattr(pallas_field, "use_pallas", lambda: True)
    for n in (8, 4096, 16384, 32768, 1 << 20):
        assert _fb_window(n) == jax_fb_window(n), n
    assert _fb_window(16384) == 8


def test_table_rejects_what_jax_rejects():
    pts = _points(4, 1)
    with pytest.raises(ParameterError):
        fb.FixedBaseTable(pts, c=3, device="cpu")  # 16 % c != 0
    with pytest.raises(ParameterError):
        fb.FixedBaseTable(pts, c=8, bits=15, device="cpu")  # bits % c > c - 2
    with pytest.raises(ParameterError):
        fb.FixedBaseTable(pts[:3], c=8, bits=14, device="cpu")  # W*n = 6
    with pytest.raises(ParameterError):
        fb.FixedBaseTable(pts[:2] + [None, pts[3]], c=4, bits=30, device="cpu")


def test_stages_match_jax(jax_tables):
    """_build_bases and the first _build_chunk at (32, 4, 30): W = 8, CH = 8,
    affine bases, the emitted affine rows and the advanced projective state."""
    import jax
    import jax.numpy as jnp
    from uzkge_tpu.ff.jax_field import fq_ctx
    from uzkge_tpu.msm.fixed_base import _build_bases, _build_chunk, _mont_one_col

    n, c, bits = 32, 4, 30
    pts, jt = jax_tables[(n, c, bits)]
    W, D = jt.W, jt.D
    K, CH = W * n, min(16, D)

    def v(vals):  # the JAX package's (16, n) layout
        return jnp.moveaxis(fq_ctx.to_mont_limbs(vals).reshape(len(vals), 16), -1, 0)

    def t(vals):
        return tf.fq.to_mont_limbs(vals, "cpu").reshape(len(vals), 8)

    def same(torch_rows, jax_v):
        return np.array_equal(tf.to_jax_limbs(torch_rows), np.moveaxis(np.asarray(jax_v), 0, -1))

    xs, ys = [p[0] for p in pts], [p[1] for p in pts]
    jbx, jby = jax.jit(functools.partial(_build_bases, W=W, c=c))(v(xs), v(ys))
    bx, by = fb.build_bases(t(xs), t(ys), W, c)
    assert same(bx, jbx) and same(by, jby)

    one = jnp.broadcast_to(_mont_one_col(), jbx.shape)
    JX, JY, JZ, packed = jax.jit(functools.partial(_build_chunk, CH=CH))(jbx, jby, one, jbx, jby)
    rows = torch.empty((K, CH, 16), dtype=torch.int32)
    TX, TY, TZ = fb.build_chunk((bx, by, tf.fq.const(1, "cpu").expand(K, 8).contiguous()),
                                bx, by, CH, rows)
    assert same(TX, JX) and same(TY, JY) and same(TZ, JZ)
    got = rows.transpose(0, 1).reshape(CH * K, 16).numpy().view(np.uint16)  # d-major
    assert np.array_equal(got, np.asarray(packed))


@pytest.mark.parametrize("N", [1, 7, 1024, 4096])
def test_fq_batch_inv_matches_jax(N):
    import jax.numpy as jnp
    from uzkge_tpu.ff.jax_field import fq_ctx
    from uzkge_tpu.msm.fixed_base import pbatch_inv_fq

    words = np.random.default_rng(N).integers(0, 1 << 32, size=(N, 8), dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(r)) % (Q_MOD - 1) + 1 for r in words]
    vals[: min(N, 2)] = [Q_MOD - 1, 1][: min(N, 2)]  # p - 1 and 1
    jl = fq_ctx.to_mont_limbs(vals).reshape(N, 16)
    want = np.moveaxis(np.asarray(pbatch_inv_fq(jnp.moveaxis(jl, -1, 0))), 0, -1)
    got = fb.fq_batch_inv(tf.from_jax_limbs(jl, "cpu"))
    assert np.array_equal(tf.to_jax_limbs(got), want)
    assert tf.fq.from_mont_limbs(got) == [pow(x, Q_MOD - 2, Q_MOD) for x in vals]


def test_batch_inv_levels():
    """The wrapper's cut: one launch (the last level alone) up to N =
    INV_GROUP * INV_ROOTS = 2^21, three for the table build's 2^23."""
    assert (fb.INV_GROUP, fb.INV_ROOTS) == (16, 2**17)
    assert fb.batch_inv_levels(1) == [(1, 1)] and fb.batch_inv_levels(4097) == [(4097, 257)]
    assert fb.batch_inv_levels(2**21) == [(2**21, 2**17)]
    assert fb.batch_inv_levels(2**21 + 1) == [(2**21 + 1, 2**17 + 1), (2**17 + 1, 8193)]
    assert fb.batch_inv_levels(8 * 2**20) == [(8 * 2**20, 2**19), (2**19, 2**15)]
    assert fb.batch_inv_levels(70001, roots=256) == [(70001, 4376), (4376, 274), (274, 18)]


def test_fp_mont_mul_matches_pallas_mul_kernel(interpret_pallas):  # noqa: F811
    from uzkge_tpu.ff.jax_field import fq_ctx, fr_ctx
    from uzkge_tpu.ff.pallas_field import pmul_fq, pmul_fr
    from uzkge_tpu.ff.vfield import h_from_v, v_from_h

    rs = np.random.default_rng(17)
    for pmul, jctx, tctx, p in ((pmul_fr, fr_ctx, tf.fr, R_MOD), (pmul_fq, fq_ctx, tf.fq, Q_MOD)):
        words = rs.integers(0, 1 << 32, size=(2, 60, 8), dtype=np.uint64)
        a, b = ([sum(int(w) << (32 * i) for i, w in enumerate(r)) % p for r in ws] for ws in words)
        a += [0, 1, p - 1, p - 2, p - 1]
        b += [p - 1, 0, p - 1, 1, 1 << 200]
        ja, jb = jctx.to_mont_limbs(a), jctx.to_mont_limbs(b)
        want = np.asarray(h_from_v(pmul(v_from_h(ja), v_from_h(jb))))
        got = fp_mont_mul(tctx, tf.from_jax_limbs(ja, "cpu"), tf.from_jax_limbs(jb, "cpu"))
        assert np.array_equal(tf.to_jax_limbs(got), want)
        assert tctx.from_mont_limbs(got) == [x * y % p for x, y in zip(a, b)]


def test_fixed_base_kernels_check_arguments():
    x = torch.zeros(8, 8, dtype=torch.int32)
    with pytest.raises(TypeError):
        fb.fb_bases(x.to(torch.int64), x, 4, 2)
    with pytest.raises(ValueError):
        fb.fb_bases(x, x[:4], 4, 2)
    with pytest.raises(ValueError):
        fb.fb_bases(x, x.to("meta"), 4, 2)  # two devices
    with pytest.raises(ValueError):
        fb.fb_bases(x.to("meta"), x.to("meta"), 4, 2)  # neither CPU nor card
    with pytest.raises(ValueError):
        fb.fb_bases(x, x, 0, 2)
    with pytest.raises(ValueError):
        fb.fb_mult_chunk(x, x, x, x, x[:, :4].contiguous(), 2)
    with pytest.raises(ValueError):
        fb.fb_mult_chunk(x, x, x, x, x, 0)
    with pytest.raises(ValueError):
        fb.fq_batch_inv(x[:0])
    with pytest.raises(ValueError):
        fb.fq_batch_inv(x.t())  # not contiguous
    with pytest.raises(ValueError):
        fp_mont_mul(object(), x, x)
    with pytest.raises(ValueError):
        fp_mont_mul(tf.fq, x, x[:4])
    with pytest.raises(ValueError):
        fp_mont_mul(tf.fq, x[:, :4].contiguous(), x[:, :4].contiguous())


# ------------------------------------------------------------------ the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.on_cuda
def test_fixed_base_kernels_match_plain(cuda_device):
    """Each of the four kernels against its plain version on the card, at
    n = 64, c = 4, bits = 30 (W = 8, K = 512, CH = 8), then the whole table
    against the one the plain versions build on the CPU."""
    n, c, bits = 64, 4, 30
    W, CH = 8, 8
    K = W * n
    pts = _points(n, 5)
    x = tf.fq.to_mont_limbs([p[0] for p in pts], cuda_device).reshape(n, 8)
    y = tf.fq.to_mont_limbs([p[1] for p in pts], cuda_device).reshape(n, 8)
    before = dict(kernels.LAUNCHES)

    BX, BY, BZ = fb.fb_bases(x, y, W, c)
    for got, want in zip((BX, BY, BZ), fb.fb_bases_plain(x, y, W, c)):
        assert torch.equal(got, want)
    zinv = fb.fq_batch_inv(BZ)
    assert torch.equal(zinv, fb.fq_batch_inv_plain(BZ))
    bx = fp_mont_mul(tf.fq, BX, zinv)
    assert torch.equal(bx, fp_mont_mul_plain(tf.fq, BX, zinv))
    by = fp_mont_mul(tf.fq, BY, zinv)
    one = tf.fq.const(1, cuda_device).expand(K, 8).contiguous()
    got = fb.fb_mult_chunk(bx, by, one, bx, by, CH)
    for g, w in zip(got, fb.fb_mult_chunk_plain(bx, by, one, bx, by, CH)):
        assert torch.equal(g, w)
    EZ = got[2].view(CH * K, 8)
    assert torch.equal(fb.fq_batch_inv(EZ), fb.fq_batch_inv_plain(EZ))
    big = EZ.repeat(9, 1)  # N = 36864
    assert torch.equal(fb.fq_batch_inv(big), fb.fq_batch_inv_plain(big))
    fr_a = tf.fr.to_mont_limbs(list(range(1, 4097)), cuda_device)
    fr_b = tf.fr.to_mont_limbs([R_MOD - k for k in range(1, 4097)], cuda_device)
    assert torch.equal(fp_mont_mul(tf.fr, fr_a, fr_b), fp_mont_mul_plain(tf.fr, fr_a, fr_b))
    torch.cuda.synchronize()
    for name in ("fb_bases", "fb_mult_chunk", "fq_batch_inv", "fp_mont_mul"):
        assert kernels.LAUNCHES[name] > before[name], name

    table = fb.FixedBaseTable(pts, c=c, bits=bits, device=cuda_device).table
    want = fb.FixedBaseTable(pts, c=c, bits=bits, device="cpu").table
    assert torch.equal(table.cpu(), want)


@pytest.mark.on_cuda
@pytest.mark.parametrize("n,W,c", [(100, 256, 1), (16384, 256, 1), (20000, 4, 8), (100, 32, 8)])
def test_fb_bases_matches_plain(cuda_device, n, W, c):
    """fb_bases on the card against its plain version at msm_chain's shape
    (W = 256, c = 1, n = 16384) and at lane counts that leave the last
    block partly empty (n = 100: blocks of 32; n = 20000: blocks of 128),
    on seeded canonical values (the formulas are exact on any field
    elements)."""
    g = torch.Generator(device=cuda_device).manual_seed(n + c)
    x, y = (torch.randint(-(1 << 31), 1 << 31, (n, 8), dtype=torch.int32, device=cuda_device,
                          generator=g) for _ in range(2))
    x[:, 7] &= 0x0FFFFFFF
    y[:, 7] &= 0x0FFFFFFF
    before = kernels.LAUNCHES["fb_bases"]
    got = fb.fb_bases(x, y, W, c)
    assert kernels.LAUNCHES["fb_bases"] == before + 1
    for g_, w in zip(got, fb.fb_bases_plain(x, y, W, c)):
        assert torch.equal(g_, w)


@pytest.mark.on_cuda
@pytest.mark.parametrize("K,CH", [(1000, 16), (1000, 1), (4096, 3)])
def test_fb_mult_chunk_matches_plain(cuda_device, K, CH):
    """fb_mult_chunk on the card against its plain version at lane counts
    that are (4096) and are not (1000) a multiple of its block, on seeded
    canonical values with T = B, T = -B and T the identity planted."""
    g = torch.Generator(device=cuda_device).manual_seed(K + CH)
    tx, ty, tz, bx, by = (torch.randint(-(1 << 31), 1 << 31, (K, 8), dtype=torch.int32,
                                        device=cuda_device, generator=g) for _ in range(5))
    for t in (tx, ty, tz, bx, by):
        t[:, 7] &= 0x0FFFFFFF
    one = tf.fq.const(1, cuda_device)
    tx[0], ty[0], tz[0] = bx[0], by[0], one  # T = B
    tx[1], ty[1], tz[1] = bx[1], tf.fq.neg(by[1]), one  # T = -B
    tx[2], ty[2], tz[2] = 0, one, 0  # the identity
    before = kernels.LAUNCHES["fb_mult_chunk"]
    got = fb.fb_mult_chunk(tx, ty, tz, bx, by, CH)
    assert kernels.LAUNCHES["fb_mult_chunk"] == before + 1
    for g_, w in zip(got, fb.fb_mult_chunk_plain(tx, ty, tz, bx, by, CH)):
        assert torch.equal(g_, w)


@pytest.mark.on_cuda
@pytest.mark.parametrize("N", [1, 2, 4095, 4096, 4097, 2**21, 8 * 2**20])
def test_fq_batch_inv_matches_plain(cuda_device, N):
    """fq_batch_inv on the card against its plain version at N up to the
    table build's 8,388,608 (one CUDA launch up to 2^21, three above), on
    seeded canonical values with p - 1 and 1 among them."""
    g = torch.Generator(device=cuda_device).manual_seed(N)
    a = torch.randint(-(1 << 31), 1 << 31, (N, 8), dtype=torch.int32, device=cuda_device,
                      generator=g)
    a[:, 7] &= 0x0FFFFFFF  # below 2^252 < q, and nonzero with overwhelming probability
    a[: min(N, 2)] = tf.fq.to_mont_limbs([Q_MOD - 1, 1][: min(N, 2)], cuda_device)
    assert torch.equal(fb.fq_batch_inv(a), fb.fq_batch_inv_plain(a))


@pytest.mark.on_cuda
@pytest.mark.parametrize("name", ["fr", "fq"])
def test_device_product_matches_host(cuda_device, name):
    """field.cuh's device product, through fp_mont_mul, against Python's
    integers: a * b mod p at 0, 1, p - 1, R mod p, 2^254 mod p and seeded
    values, every pair of them; fp_mul_chain (the rate kernel) against its
    plain version, and against a * b^iters mod p."""
    ctx, p = (tf.fr, R_MOD) if name == "fr" else (tf.fq, Q_MOD)
    rs = np.random.default_rng(17)
    vals = [0, 1, p - 1, (1 << 256) % p, (1 << 254) % p, p - 2]
    vals += [int.from_bytes(rs.bytes(32), "little") % p for _ in range(58)]
    a = [u for u in vals for _ in vals]
    b = [v for _ in vals for v in vals]
    got = fp_mont_mul(ctx, ctx.to_mont_limbs(a, cuda_device), ctx.to_mont_limbs(b, cuda_device))
    assert ctx.from_mont_limbs(got.cpu()) == [u * v % p for u, v in zip(a, b)]
    n, iters = 256, 5
    starts = [int.from_bytes(rs.bytes(32), "little") % p for _ in range(CHAINS * n)]
    ca = ctx.to_mont_limbs(starts, cuda_device).reshape(CHAINS, n, 8)
    cb = ctx.to_mont_limbs(vals[:4] * (n // 4), cuda_device).reshape(n, 8)
    before = kernels.LAUNCHES["fp_mul_chain"]
    out = fp_mul_chain(ctx, ca, cb, iters)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fp_mul_chain"] == before + 1
    assert torch.equal(out, fp_mul_chain_plain(ctx, ca, cb, iters))
    bs = vals[:4] * (n // 4)
    want = [s * pow(bs[i % n], iters, p) % p for i, s in enumerate(starts)]
    assert ctx.from_mont_limbs(out.cpu().reshape(-1, 8)) == want
