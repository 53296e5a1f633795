"""The torch port's chain MSM against the JAX package's, exactly.

Field arithmetic has no rounding, so every comparison is exact (tolerance 0):
  * scan_leaf_reduce_plain and scan_proj_reduce_plain against the real JAX
    kernel bodies _scan_leaf_kernel and _scan_proj_kernel
    (uzkge_tpu/msm/fixed_base.py), at S = 8, through the eager grid
    interpreter of tests/test_torch_fixed_base_query.py, with the bodies'
    `pl.ds` reads taken as slices and their fori_loop run eagerly (an XLA
    compile of the unrolled body takes many minutes); the leaf round's
    inputs are gathered out of a chain by the JAX package's msm_chain
    indexing; the leaf's outputs are compared limb for limb mod p, the
    projective round's as affine points (it adds by fb_fold's tree, the TPU
    kernel by two running sums: the same sums, other projective limbs);
  * reduce_leaves against the JAX package's _reduce_leaves, as affine
    points, at P = 2 (an all-zero row, zero digits) over two projective
    rounds;
  * the leaf round's width (pick_s) against _pick_S;
  * msm_chain on the CPU against uzkge_tpu.msm.fixed_base.msm_chain and the
    host Pippenger at n = 32, P = 1 and 3, with an all-zero row and entries
    p - 1, as affine points;
  * the wrappers' argument checks, and on a card (marker on_cuda) both
    kernels against their plain versions and msm_chain against the CPU's.
Inputs come from numpy with fixed seeds.  JAX is imported inside the tests
that use it, so that the on_cuda test also runs where JAX is absent.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from uzkge_tpu_torch import kernels
from uzkge_tpu_torch.constants.bn254 import Q_MOD, R_MOD
from uzkge_tpu_torch.curve.bn254 import G1_GEN, g1_mul
from uzkge_tpu_torch.ff import field as tf
from uzkge_tpu_torch.msm import fixed_base as fb
from uzkge_tpu_torch.msm.msm import host_msm

from .test_torch_fixed_base_query import _fq_vals, _mini_pallas_call, _mod_p, _port, _rows

torch.set_num_threads(1)

N_PTS = 32


class _Ref:
    """A kernel input block read as a Pallas ref: `pl.ds(start, size)` reads
    the slice [start, start + size)."""

    def __init__(self, a):
        self.a = a

    def __getitem__(self, idx):
        from jax._src.state.indexing import Slice

        idx = idx if isinstance(idx, tuple) else (idx,)
        return self.a[tuple(slice(i.start, i.start + i.size) if isinstance(i, Slice) else i
                            for i in idx)]


@pytest.fixture
def scan_pallas(monkeypatch):
    """uzkge_tpu.msm.fixed_base's pallas_call through the interpreter, input
    refs as _Ref, jax.lax.fori_loop as a Python loop."""
    import jax
    from uzkge_tpu.msm import fixed_base as jfb

    def call(kernel, out_shape, in_specs=None, **kw):
        nin = len(in_specs)

        def body(*refs):
            kernel(*(_Ref(r) for r in refs[:nin]), *refs[nin:])

        return _mini_pallas_call(body, out_shape, in_specs=in_specs, **kw)

    def fori_loop(lo, hi, body, init):
        for t in range(lo, hi):
            init = body(t, init)
        return init

    monkeypatch.setattr(jfb, "pallas_call", call)
    monkeypatch.setattr(jax.lax, "fori_loop", fori_loop)
    return jfb


def _jax_rows(t):
    """port (N, 8) -> the JAX package's (16, N) layout (jnp)."""
    import jax.numpy as jnp

    return jnp.asarray(np.moveaxis(tf.to_jax_limbs(t), -1, 0))


# --------------------------------------------------------------- msm_chain


def _case():
    """N_PTS points and four scalar rows: all zero; p - 1 at every other
    point, seeded values between; two seeded rows with a p - 1 and a 1."""
    rs = np.random.default_rng(77)
    pts = [g1_mul(G1_GEN, int(k)) for k in rs.integers(1, 1 << 62, size=N_PTS)]
    rows = [[0] * N_PTS]
    rows.append([R_MOD - 1 if i % 2 else int.from_bytes(rs.bytes(32), "little") % R_MOD
                 for i in range(N_PTS)])
    for _ in range(2):
        row = [int.from_bytes(rs.bytes(32), "little") % R_MOD for _ in range(N_PTS)]
        row[3], row[5] = R_MOD - 1, 1
        rows.append(row)
    return pts, rows


@pytest.fixture(scope="module")
def jax_chain():
    """The JAX package's msm_chain over _case()'s four rows, as host affine
    points, started in a thread (its first call is mostly XLA compile time)
    while the kernel-body tests run."""

    def run():
        import jax.numpy as jnp
        from uzkge_tpu.ff.jax_field import L, fq_ctx, fr_ctx
        from uzkge_tpu.msm.fixed_base import _extract_host, msm_chain

        pts, rows = _case()
        n = len(pts)
        xv = jnp.moveaxis(fq_ctx.to_mont_limbs([p[0] for p in pts]).reshape(n, L), -1, 0)
        yv = jnp.moveaxis(fq_ctx.to_mont_limbs([p[1] for p in pts]).reshape(n, L), -1, 0)
        sc = fr_ctx.to_mont_limbs([s for row in rows for s in row]).reshape(len(rows), n, L)
        X, Y, Z = msm_chain(xv, yv, sc)
        return _extract_host(X, Y, Z, len(rows))

    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(run)


# ---------------------------------------------------------- kernel bodies


_LEAF_CASE = {}


def _leaf_case(jfb):
    """P = 2 MSMs, n = 4, W = 8 (K = 32 leaves each, S = 8, J = 4): a chain of
    seeded canonical values and digits in [-2, 2] with lanes planted: (0, 0)
    starts 2, -2, 1, -1; (0, 2) has no zero digit; (1, 1) is all zero (its
    sum is the identity); (1, 3) has one nonzero digit, at an odd leaf.
    Returns the inputs and _scan_leaf_kernel's outputs on msm_chain's gather
    of them (uzkge_tpu/msm/fixed_base.py, msm_chain), worked out once per
    module (the interpreted body takes seconds)."""
    import jax.numpy as jnp

    if _LEAF_CASE:
        return _LEAF_CASE["case"]

    P, n, W, S = 2, 4, 8, 8
    K, J = W * n, W * n // S
    rs = np.random.default_rng(5)
    ax, ay = (_rows(_fq_vals(rs, 2 * K), (2 * K,)) for _ in range(2))
    digits = rs.integers(-2, 3, size=(P, K)).astype(np.int32)
    digits[1, S : 2 * S] = 0
    digits[0, :4] = [2, -2, 1, -1]
    digits[0, 2 * S : 3 * S] = rs.choice([-2, -1, 1, 2], size=S)
    digits[1, 3 * S : 4 * S] = [0, 0, 0, 0, 0, -2, 0, 0]

    d_t = jnp.asarray(digits)
    base_idx = (2 * jnp.arange(W, dtype=jnp.int32)[:, None] * n
                + jnp.arange(n, dtype=jnp.int32)[None, :]).reshape(1, W * n)
    idx = base_idx + jnp.maximum(jnp.abs(d_t) - 1, 0) * n
    d_lay = jnp.moveaxis(jfb._to_scan_layout(d_t, S), 1, 0).reshape(S, P * J)
    idx_lay = jnp.moveaxis(jfb._to_scan_layout(idx, S), 1, 0).reshape(S, P * J)
    gx = _jax_rows(ax)[:, idx_lay.reshape(-1)].reshape(16, S, P * J)
    gy = _jax_rows(ay)[:, idx_lay.reshape(-1)].reshape(16, S, P * J)
    want = jfb._scan_reduce_tpu(jfb._scan_leaf_kernel, S, (gx, gy), d=d_lay)
    assert fb.chain_rows(torch.from_numpy(digits), n).tolist() == np.asarray(idx).tolist()
    _LEAF_CASE["case"] = (ax, ay, digits, n, S), [_mod_p(_port(w)) for w in want]
    return _LEAF_CASE["case"]


def test_scan_leaf_matches_jax_kernel_body(scan_pallas, jax_chain):
    """scan_leaf_reduce_plain against _scan_leaf_kernel on _leaf_case()'s
    planted lanes, limb for limb mod p."""
    (ax, ay, digits, n, S), want = _leaf_case(scan_pallas)
    P, K = digits.shape
    J = K // S
    got = fb.scan_leaf_reduce(ax, ay, torch.from_numpy(digits), n, S)
    for g, w in zip(got, want):
        assert g.shape == (P * J, 8) and _mod_p(g) == w
    X, Y, Z = (_mod_p(t) for t in got)
    assert (X[J + 1], Y[J + 1], Z[J + 1]) == (0, tf.fq.R % Q_MOD, 0)  # the identity


_LEAF_HARNESS = r"""
#include "scan_reduce.cuh"
extern "C" void scan_leaf_n(const uint32_t *ax, const uint32_t *ay, const int32_t *digits,
                            uint32_t *ox, uint32_t *oy, uint32_t *oz, int lanes, int K, int lg_n,
                            int S) {
  for (int t = 0; t < lanes; t++) scan_leaf_lane(ax, ay, digits, ox, oy, oz, t, K, lg_n, S); }
"""


def test_scan_leaf_lane_matches_jax_kernel_body(scan_pallas, tmp_path):
    """scan_reduce.cuh's leaf lane (the kernel's walk over nonzero leaves),
    compiled by g++, against _scan_leaf_kernel on _leaf_case()'s planted
    lanes, limb for limb."""
    import ctypes
    import shutil
    import subprocess

    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ on this machine")
    (src, so) = (tmp_path / "leaf.cpp", tmp_path / "leaf.so")
    src.write_text(_LEAF_HARNESS)
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", kernels.CSRC, "-o",
                    str(so), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.scan_leaf_n.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
    (ax, ay, digits, n, S), want = _leaf_case(scan_pallas)
    P, K = digits.shape
    lanes = P * K // S
    digits = np.ascontiguousarray(digits)
    out = [torch.zeros((lanes, 8), dtype=torch.int32) for _ in range(3)]
    lib.scan_leaf_n(ax.data_ptr(), ay.data_ptr(), digits.ctypes.data,
                    *(o.data_ptr() for o in out), lanes, K, n.bit_length() - 1, S)
    for o, w in zip(out, want):
        assert _mod_p(o) == w


def _curve_proj(rs, count: int, ident_share: float):
    """`count` projective points (X, Y, Z) (count, 8) each, Fq Montgomery:
    seeded multiples of G scaled by a seeded z, a share of them the identity
    (0 : z : 0)."""
    ks = rs.integers(1, 1 << 62, size=count)
    zs = rs.integers(1, 1 << 62, size=count)
    ident = rs.random(count) < ident_share
    vals = []
    for k, z, o in zip(ks, zs, ident):
        z = int(z)
        if o:
            vals += [0, z, 0]
        else:
            x, y = g1_mul(G1_GEN, int(k))
            vals += [x * z % Q_MOD, y * z % Q_MOD, z]
    t = tf.fq.to_mont_limbs(vals, "cpu").reshape(count, 3, 8)
    return tuple(t[:, i].contiguous() for i in range(3))


def test_scan_proj_matches_jax_kernel_body(scan_pallas):
    """scan_proj_reduce_plain against _scan_proj_kernel on _reduce_leaves'
    layout of P = 2 MSMs of 16 projective points each, S = 8, identities
    among the points (lane 0 all of them), as affine points: the TPU kernel
    adds by two running sums, the port by fb_fold's tree."""
    import jax.numpy as jnp

    jfb = scan_pallas
    P, per, S = 2, 16, 8
    rs = np.random.default_rng(6)
    X, Y, Z = _curve_proj(rs, P * per, 0.25)
    one = tf.fq.const(1, "cpu")
    X[:S], Y[:S], Z[:S] = 0, one, 0  # lane 0: all identities

    def lay(t):  # _reduce_leaves' scan layout of one round
        v = _jax_rows(t).reshape(16, P, per)
        return jnp.moveaxis(jfb._to_scan_layout(v, S), 2, 1).reshape(16, S, P * per // S)

    want = jfb._scan_reduce_tpu(jfb._scan_proj_kernel, S, (lay(X), lay(Y), lay(Z)))
    got = fb.scan_proj_reduce(X, Y, Z, S)
    assert all(g.shape == (P * per // S, 8) for g in got)
    pts = fb._extract_host(*got)
    assert pts == fb._extract_host(*(_port(w) for w in want))
    assert pts[0] is None and None not in pts[1:]


def test_reduce_leaves_matches_jax():
    """reduce_leaves (the leaf round, then scan_proj_reduce over fold_tiles:
    tiles of 512, then 2) against the JAX package's _reduce_leaves (the leaf
    round, then running-sum rounds of S = 32, 32) on the CPU at P = 2, K =
    32,768 leaves over a chain of 64 curve points repeated, digits seeded
    with a quarter zero, MSM 1 all zero but for one run of leaves: affine
    points equal."""
    import jax.numpy as jnp
    from uzkge_tpu.ff.vfield import vfq_c
    from uzkge_tpu.msm import fixed_base as jfb

    P, n, W = 2, 256, 128
    K = W * n
    S = fb.pick_s(K)
    J = K // S
    assert fb.fold_tiles(J) == [512, 2]
    rs = np.random.default_rng(9)
    pts = [g1_mul(G1_GEN, int(k)) for k in rs.integers(1, 1 << 62, size=64)]
    chain = [pts[i % 64] for i in range(2 * K)]
    ax, ay = (tf.fq.to_mont_limbs([p[j] for p in chain], "cpu") for j in (0, 1))
    digits = rs.integers(-2, 3, size=(P, K)).astype(np.int32)
    digits[1] = 0
    digits[1, 100:140] = rs.choice([-2, -1, 1, 2], size=40)
    got = fb._extract_host(*fb.reduce_leaves(ax, ay, torch.from_numpy(digits), n))

    idx = fb.chain_rows(torch.from_numpy(digits), n).numpy()
    d_lay = jnp.moveaxis(jfb._to_scan_layout(jnp.asarray(digits), S), 1, 0).reshape(S, P * J)
    idx_lay = np.moveaxis(np.asarray(jfb._to_scan_layout(jnp.asarray(idx), S)), 1, 0)
    gx, gy = (_jax_rows(t)[:, idx_lay.reshape(-1)].reshape(16, S, P * J) for t in (ax, ay))
    # the compact field form, as the JAX package's msm_chain passes it: the
    # rounds' scan bodies compile in seconds, not a minute
    X, Y, Z = jfb._reduce_leaves(gx, gy, d_lay, S, P, J, f=vfq_c)
    want = fb._extract_host(*(_port(t) for t in (X, Y, Z)))
    assert got == want and None not in want


def test_round_widths_match_jax():
    from uzkge_tpu.msm.fixed_base import _pick_S

    for per in (1, 2, 3, 8, 96, 4096, 65536, 2 ** 21, 2 ** 22 * 3):
        assert fb.pick_s(per) == _pick_S(per)
    widths, per = [], 128 * 16384  # the leaves of one MSM at n = 16384
    while per > 1:
        widths.append(fb.pick_s(per))
        per //= widths[-1]
    assert widths == [32, 32, 32, 32, 2]


# --------------------------------------------------------------- msm_chain


@pytest.mark.parametrize("rows_at", [slice(0, 3), slice(3, 4)], ids=["P3", "P1"])
def test_msm_chain_matches_jax_and_host(jax_chain, rows_at):
    """msm_chain (the plain versions) at n = 32 on P = 3 rows (all zero, p - 1
    at every other point, seeded) and on P = 1, against the JAX package's
    msm_chain and the host Pippenger, as affine points."""
    pts, rows = _case()
    rows = rows[rows_at]
    x, y = (tf.fq.to_mont_limbs([p[j] for p in pts], "cpu") for j in (0, 1))
    sc = tf.fr.to_mont_limbs([s for row in rows for s in row], "cpu").reshape(len(rows), N_PTS, 8)
    X, Y, Z = fb.msm_chain(x, y, sc)
    assert X.shape == Y.shape == Z.shape == (len(rows), 8)
    got = fb._extract_host(X, Y, Z)
    want = [host_msm(pts, row) for row in rows]
    assert got == want == jax_chain.result()[rows_at]
    assert (want[0] is None) == (rows_at.start == 0)


# ------------------------------------------------------------ arguments


def test_chain_kernels_check_arguments():
    ax = torch.zeros(64, 8, dtype=torch.int32)
    d = torch.zeros(2, 32, dtype=torch.int32)
    with pytest.raises(ValueError):
        fb.scan_leaf_reduce(ax, ax, d[0], 4, 8)  # digits not (P, K)
    with pytest.raises(ValueError):
        fb.scan_leaf_reduce(ax[:32].contiguous(), ax, d, 4, 8)  # chain not (2K, 8)
    with pytest.raises(ValueError):
        fb.scan_leaf_reduce(ax, ax, d, 5, 8)  # n does not divide K
    with pytest.raises(ValueError):
        fb.scan_leaf_reduce(ax, ax, d, 4, 6)  # S not a power of two
    with pytest.raises(ValueError):
        fb.scan_leaf_reduce(ax, ax, d, 4, 64)  # S > K
    with pytest.raises(TypeError):
        fb.scan_leaf_reduce(ax, ax, d.to(torch.int64), 4, 8)
    with pytest.raises(ValueError):
        fb.scan_proj_reduce(ax, ax, ax[:32].contiguous(), 8)
    with pytest.raises(ValueError):
        fb.scan_proj_reduce(ax, ax, ax, 3)
    with pytest.raises(ValueError):
        fb.scan_proj_reduce(ax.t(), ax.t(), ax.t(), 2)  # not (N, 8)
    with pytest.raises(ValueError):
        fb.scan_proj_reduce(ax.to("meta"), ax.to("meta"), ax.to("meta"), 2)  # neither CPU nor card
    x = torch.zeros(6, 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        fb.msm_chain(x, x, torch.zeros(1, 6, 8, dtype=torch.int32))  # n not a power of two
    with pytest.raises(ValueError):
        fb.msm_chain(x[:4], x[:4], torch.zeros(1, 6, 8, dtype=torch.int32))


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.on_cuda
@pytest.mark.parametrize("P", [3, 1], ids=["P3", "P1"])
def test_chain_kernels_match_plain(cuda_device, P):
    """scan_leaf_reduce (S = 32 and 1) and scan_proj_reduce (S = 8 and 2) on
    the card against their plain versions on the same inputs (P = 3 with an
    all-zero row, and P = 1), then msm_chain at n = 32 against the CPU's."""
    n, W = 16, 128
    K = W * n
    rs = np.random.default_rng(8)
    ax, ay = (_rows(_fq_vals(rs, 2 * K), (2 * K,)).to(cuda_device) for _ in range(2))
    d = torch.from_numpy(rs.integers(-2, 3, size=(P, K)).astype(np.int32)).to(cuda_device)
    if P > 1:
        d[1] = 0
    before = dict(kernels.LAUNCHES)
    for S in (32, 1):
        for g, w in zip(fb.scan_leaf_reduce(ax, ay, d, n, S),
                        fb.scan_leaf_reduce_plain(ax, ay, d, n, S)):
            assert torch.equal(g, w)
    X, Y, Z = (_rows(_fq_vals(rs, 64), (64,)).to(cuda_device) for _ in range(3))
    for S in (8, 2):
        for g, w in zip(fb.scan_proj_reduce(X, Y, Z, S), fb.scan_proj_reduce_plain(X, Y, Z, S)):
            assert torch.equal(g, w)
    torch.cuda.synchronize()
    for name in ("scan_leaf_reduce", "scan_proj_reduce"):
        assert kernels.LAUNCHES[name] > before[name], name

    pts, rows = _case()
    x, y = (tf.fq.to_mont_limbs([p[j] for p in pts], cuda_device) for j in (0, 1))
    rows = rows if P > 1 else rows[-1:]
    sc = tf.fr.to_mont_limbs([s for row in rows for s in row], cuda_device).reshape(-1, N_PTS, 8)
    assert fb._extract_host(*fb.msm_chain(x, y, sc)) == [host_msm(pts, row) for row in rows]
