"""The torch port's fixed-base query against the JAX package's, exactly.

Field arithmetic has no rounding, so every comparison is exact (tolerance 0);
values out of the JAX package's projective fold, which lives in afield's lazy
[0, 2p) domain, are compared mod p:
  * each plain kernel version of uzkge_tpu_torch/msm/fixed_base.py against
    the real JAX kernel bodies of uzkge_tpu/msm/fixed_base.py, run by the
    eager grid interpreter below: fb_select_plain against _select_kernel,
    fb_pair_den_plain / fq_batch_inv / fb_pair_combine_plain against
    _affine_level (H >= 128: _pair_den_kernel and _pair_combine_kernel;
    H < 128: their small variants), fb_fold_plain against _fold8_kernel and
    the XLA remainder, and the whole projective tail (fold_tail) against
    _fold8 levels and the remainder (fq_batch_inv against
    pbatch_inv_fq_fast, through the same interpreter, is
    tests/test_torch_fixed_base_inv.py);
  * the digit recode against recode_digits;
  * FixedBaseTable.msm_mont against the JAX package's CPU FixedBaseTable.
    msm_mont and against the host Pippenger, as affine points, at (n, c,
    bits) = (32, 4, 30) and (8, 8, 254), with all-zero rows, rows of the
    largest scalar, single nonzero entries and P = 1, 3 and 9;
  * the wrappers' argument checks, and on a card (marker on_cuda) the four
    query kernels against their plain versions, the fold at P = 1, 2, 5 and
    8 over a tail of one launch and one of two.
Inputs come from numpy with fixed seeds.  JAX is imported inside the tests
that use it, so that the on_cuda test also runs where JAX is absent
(`pytest --noconftest -m on_cuda`).
"""

import functools
import itertools
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

torch.set_num_threads(1)

TAU = 987654321987654321


def _mini_pallas_call(kernel, out_shape, grid=(), in_specs=None, out_specs=None, record=None,
                      **_):
    """Eager grid interpreter (tests/test_pallas_kernels.py::_mini_pallas_call,
    extended): runs the REAL kernel body once per grid point on its blocks; a
    call without a grid runs once, and a BlockSpec without a block shape
    hands over the whole array.  Input blocks are jnp arrays (the Fermat
    kernel indexes its bit plane with a traced loop index), output blocks
    numpy views that the kernel's writes go through.  `record`, a list,
    collects (kernel name, input blocks of the last grid point, outputs)."""
    import jax.numpy as jnp

    single = not isinstance(out_shape, (tuple, list))
    oshapes = [out_shape] if single else list(out_shape)
    ospecs = [out_specs] if single else list(out_specs)

    def view(spec, a, idx):
        if spec is None or spec.block_shape is None:
            return a
        start = [b * s for b, s in zip(spec.index_map(*idx), spec.block_shape)]
        return a[tuple(slice(st, st + bs) for st, bs in zip(start, spec.block_shape))]

    def call(*args):
        ins = [np.asarray(a) for a in args]
        outs = [np.zeros(s.shape, np.dtype(s.dtype)) for s in oshapes]
        specs = in_specs or [None] * len(ins)
        for idx in itertools.product(*(range(g) for g in (grid or (1,)))):
            refs = [jnp.asarray(view(s, a, idx)) for s, a in zip(specs, ins)]
            kernel(*refs, *(view(s, o, idx) for s, o in zip(ospecs, outs)))
        res = [jnp.asarray(o) for o in outs]
        if record is not None:
            name = getattr(kernel, "func", kernel).__name__
            record.append((name, ins, [np.asarray(o) for o in outs]))
        return res[0] if single else tuple(res)

    return call


@pytest.fixture
def mini_pallas(monkeypatch):
    """uzkge_tpu.msm.fixed_base's pallas_call through the interpreter; yields
    the list of recorded calls."""
    from uzkge_tpu.msm import fixed_base as jfb

    calls = []
    monkeypatch.setattr(jfb, "pallas_call", functools.partial(_mini_pallas_call, record=calls))
    yield calls


# ------------------------------------------------------------- layouts


def _fq_vals(rs, count: int):
    """`count` seeded canonical Fq values."""
    words = rs.integers(0, 1 << 32, size=(count, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(r)) % Q_MOD for r in words]


def _rows(vals, shape):
    """python ints (values as stored) -> port (..., 8) int32 tensor."""
    return torch.from_numpy(tf.ints_to_limbs(vals).reshape(shape + (8,)))


def _jax_v(t):
    """port (P, K, 8) -> the JAX package's (16, P, K) uint32 layout."""
    return np.moveaxis(tf.to_jax_limbs(t), -1, 0)


def _port(v):
    """the JAX package's (16, ...) layout -> port (..., 8) tensor."""
    return tf.from_jax_limbs(np.moveaxis(np.asarray(v), 0, -1), "cpu")


def _mod_p(t):
    return [v % Q_MOD for v in tf.limbs_to_ints(t)]


# --------------------------------------------------------------- select


def test_select_matches_jax_select_kernel():
    """fb_select_plain against _select_kernel at P = 2, K = 256, D = 8 (two
    128-lane blocks), on a seeded table of canonical values and digits
    covering [-D, D] plus two out of range; whole tensors compared (d = 0
    carries row 0 on both)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from uzkge_tpu.msm.fixed_base import _select_kernel

    P, K, D, TK = 2, 256, 8, 128
    rs = np.random.default_rng(21)
    table = _rows(_fq_vals(rs, K * D * 2), (K, D, 2)).reshape(K, D, 16)
    digits = rs.integers(-D, D + 1, size=(P, K)).astype(np.int32)
    digits[0, :3] = [0, D + 1, -D - 3]
    vertical = table.numpy().view(np.uint16).reshape(K, D, 32).transpose(1, 2, 0)
    spec = pl.BlockSpec
    call = _mini_pallas_call(
        functools.partial(_select_kernel, P, D),
        out_shape=(jax.ShapeDtypeStruct((16, P, K), jnp.uint32),) * 2
        + (jax.ShapeDtypeStruct((P, K), jnp.uint32),),
        grid=(K // TK,),
        in_specs=[spec((D, 32, TK), lambda i: (0, 0, i)), spec((P, TK), lambda i: (0, i))],
        out_specs=(spec((16, P, TK), lambda i: (0, 0, i)),) * 2 + (spec((P, TK), lambda i: (0, i)),))
    jx, jy, jinf = call(vertical, digits)
    x, y, inf = fb.fb_select(torch.from_numpy(digits), table)
    assert torch.equal(x, _port(jx)) and torch.equal(y, _port(jy))
    assert np.array_equal(inf.numpy(), np.asarray(jinf))


# --------------------------------------------------------- affine level


def _level_inputs(P: int, Kc: int, seed: int):
    """Affine coordinates (canonical values, not curve points: the level's
    arithmetic does not look) with planted pairs: both identities, one
    identity, x1 == x2 (degenerate), x1 == x2 beside an identity."""
    rs = np.random.default_rng(seed)
    H = Kc // 2
    x = _rows(_fq_vals(rs, P * Kc), (P, Kc))
    y = _rows(_fq_vals(rs, P * Kc), (P, Kc))
    inf = torch.from_numpy((rs.random((P, Kc)) < 0.2).astype(np.int32))
    inf[0, [0, H]] = 1
    inf[0, [1, 1 + H]] = torch.tensor([1, 0], dtype=torch.int32)
    inf[0, [2, 2 + H]] = torch.tensor([0, 1], dtype=torch.int32)
    for j, i2 in ((3, 0), (4, 0), (5, 1)):
        x[P - 1, j + H] = x[P - 1, j]
        inf[P - 1, [j, j + H]] = torch.tensor([0, i2], dtype=torch.int32)
    return x, y, inf


@pytest.mark.parametrize("Kc", [256, 64], ids=["H128", "H32-small"])
def test_affine_level_matches_jax(mini_pallas, Kc):
    """fb_pair_den_plain, fq_batch_inv and fb_pair_combine_plain against one
    _affine_level of the JAX package at P = 2 (den and flags against the den
    kernel's outputs, dinv against the combine kernel's input, the level's
    outputs against the combine kernel's)."""
    from uzkge_tpu.msm.fixed_base import _affine_level

    x, y, inf = _level_inputs(2, Kc, Kc)
    jxo, jyo, jinf = _affine_level(_jax_v(x), _jax_v(y), inf.numpy().astype(np.uint32))
    names = [name for name, _, _ in mini_pallas]
    small = "_small" if Kc // 2 < 128 else ""
    assert names == [f"_pair_den{small}_kernel", f"_pair_combine{small}_kernel"]
    (_, _, (jden, jflags)), (_, cins, _) = mini_pallas

    den, flags = fb.fb_pair_den(x, inf)
    assert torch.equal(den, _port(jden)) and np.array_equal(flags.numpy(), jflags)
    assert set(flags.flatten().tolist()) >= {0, 1, 2, 3, 4}
    dinv = fb.fq_batch_inv(den.view(-1, 8)).view(den.shape)
    assert torch.equal(dinv, _port(cins[2 if small else 4]))  # the combine kernel's dinv
    xo, yo, info = fb.fb_pair_combine(x, y, dinv, flags)
    assert torch.equal(xo, _port(jxo)) and torch.equal(yo, _port(jyo))
    assert np.array_equal(info.numpy(), np.asarray(jinf))
    assert all(torch.equal(a, b) for a, b in zip((xo, yo, info), fb.affine_level(x, y, inf)))


# ----------------------------------------------------------------- fold


def _proj_inputs(P: int, Kc: int, seed: int):
    """Projective coordinates (canonical values) with identities (0, 1, 0)."""
    rs = np.random.default_rng(seed)
    X, Y, Z = (_rows(_fq_vals(rs, P * Kc), (P, Kc)) for _ in range(3))
    ident = torch.from_numpy(rs.random((P, Kc)) < 0.25)[..., None]
    one = tf.fq.const(1, "cpu")
    return (torch.where(ident, 0, X), torch.where(ident, one, Y), torch.where(ident, 0, Z))


def test_fold8_matches_jax(mini_pallas):
    """fb_fold_plain(w = 8) against _fold8 (the _fold8_kernel body) at P = 2,
    Kc = 64, mod p (the JAX fold's values are lazy)."""
    from uzkge_tpu.msm.fixed_base import _fold8

    pts = _proj_inputs(2, 64, 3)
    want = _fold8(*(_jax_v(t) for t in pts))
    assert [n for n, _, _ in mini_pallas] == ["_fold8_kernel"]
    got = fb.fb_fold(*pts, 8)
    for g, w in zip(got, want):
        assert g.shape == (2, 8, 8) and _mod_p(g) == _mod_p(_port(w))


@pytest.mark.parametrize("Kc", [2, 4])
def test_fold_remainder_matches_jax(Kc):
    """fb_fold_plain(w = Kc) against the JAX query's remainder loop, which
    halves the last Kc points of each MSM with padd_g in afield (:1164-1174)."""
    from uzkge_tpu.ff.afield import afq_c
    from uzkge_tpu.msm.fixed_base import padd_g

    pts = _proj_inputs(3, Kc, 40 + Kc)
    X, Y, Z = (_jax_v(t) for t in pts)
    while Kc > 1:
        h = Kc // 2
        X, Y, Z = padd_g(afq_c, (X[:, :, :h], Y[:, :, :h], Z[:, :, :h]),
                         (X[:, :, h:], Y[:, :, h:], Z[:, :, h:]))
        Kc = h
    for g, w in zip(fb.fb_fold(*pts, pts[0].shape[1]), (X, Y, Z)):
        assert _mod_p(g) == _mod_p(_port(w))


@pytest.mark.parametrize("Kc", [2, 4, 16, 128, 1024])
def test_fold_tail_matches_jax(mini_pallas, Kc):
    """fold_tail (fb_fold over fold_tiles(Kc); on the CPU the plain trees)
    and its plain version fold_tail_plain against the JAX query's tail at
    P = 2: _fold8 while 8 divides Kc, then the remainder's padd_g in afield
    (:1164-1174), compared mod p."""
    from uzkge_tpu.ff.afield import afq_c
    from uzkge_tpu.msm.fixed_base import _fold8, padd_g

    pts = _proj_inputs(2, Kc, 50 + Kc)
    X, Y, Z = (_jax_v(t) for t in pts)
    n = Kc
    while n % 8 == 0:
        X, Y, Z = _fold8(X, Y, Z)
        n //= 8
    while n > 1:
        h = n // 2
        X, Y, Z = padd_g(afq_c, (X[:, :, :h], Y[:, :, :h], Z[:, :, :h]),
                         (X[:, :, h:], Y[:, :, h:], Z[:, :, h:]))
        n = h
    assert len(mini_pallas) == {2: 0, 4: 0, 16: 1, 128: 2, 1024: 3}[Kc]
    got = fb.fold_tail(*pts)
    for g, p, w in zip(got, fb.fold_tail_plain(*pts), (X, Y, Z)):
        assert g.shape == (2, 8) and _mod_p(g) == _mod_p(_port(w)[:, 0]) and torch.equal(g, p)


# ---------------------------------------------------------------- recode


@pytest.mark.parametrize("c,bits", [(4, 30), (8, 254), (8, 14), (2, 256)])
def test_recode_matches_jax(c, bits):
    import jax.numpy as jnp
    from uzkge_tpu.ff.jax_field import fr_ctx
    from uzkge_tpu.msm.fixed_base import _scalars_to_digits, recode_digits

    rs = np.random.default_rng(c * 1000 + bits)
    top = min(1 << bits, R_MOD)
    vals = [int(v) % top for v in rs.integers(0, 1 << 62, size=40)]
    vals += [int.from_bytes(rs.bytes(32), "little") % top for _ in range(40)]
    vals += [0, 1, top - 1, top // 2, (top - 1) // 3]
    std = torch.from_numpy(tf.ints_to_limbs(vals))
    want = recode_digits(jnp.moveaxis(jnp.asarray(tf.to_jax_limbs(std)), -1, 0), c, bits)
    got = fb.recode_digits(std, c, bits)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert all(sum(d << (c * k) for k, d in enumerate(row)) == v
               for row, v in zip(got.tolist(), vals))
    mont = tf.fr.to_mont_limbs(vals, "cpu").reshape(5, -1, 8)
    jmont = fr_ctx.to_mont_limbs(vals).reshape(5, -1, 16)
    assert np.array_equal(fb.scalars_to_digits(mont, c, bits).numpy(),
                          np.asarray(_scalars_to_digits(jmont, c, bits)))
    with pytest.raises(Exception):
        fb.recode_digits(std, 8, 15)


# ------------------------------------------------------------ whole MSM


QUERY_CASES = [(32, 4, 30), (8, 8, 254)]


def _case_points(n: int):
    rs = np.random.default_rng(n)
    return [g1_mul(G1_GEN, int(k)) for k in rs.integers(1, 1 << 62, size=n)]


def _scalar_rows(n: int, bits: int, seed: int):
    """Nine rows: all zero, all the largest scalar, one nonzero entry (at the
    first, a middle and the last point), and four seeded rows."""
    rs = np.random.default_rng(seed)
    top = min(1 << bits, R_MOD) - 1
    rows = [[0] * n, [top] * n]
    for i in (0, n // 2, n - 1):
        row = [0] * n
        row[i] = int(rs.integers(1, min(top, 1 << 40)))
        rows.append(row)
    rows += [[int.from_bytes(rs.bytes(32), "little") % (top + 1) for _ in range(n)]
             for _ in range(4)]
    return rows


def _jax_table(tbl):
    """The JAX package's CPU FixedBaseTable over the port's table `tbl`, which
    tests/test_torch_fixed_base.py holds byte for byte against the JAX
    package's own build; its query is the JAX package's code unchanged (its
    build, ~80 s of XLA compiles per table here, is skipped)."""
    import jax
    import jax.numpy as jnp
    from uzkge_tpu.msm.fixed_base import FixedBaseTable as JaxTable

    jt = object.__new__(JaxTable)
    jt.n, jt.c, jt.bits, jt.W, jt.D, jt.points = tbl.n, tbl.c, tbl.bits, tbl.W, tbl.D, tbl.points
    jt.vertical = False
    jt.table = jnp.asarray(tbl.table.numpy().view(np.uint16).reshape(-1, 32))
    jt._msm_jit = jax.jit(jt._msm_impl)
    return jt


@pytest.fixture(scope="module")
def query_cases():
    """{(n, c, bits): (KZG or None, the port's table, rows, the JAX package's
    CPU msm_mont of the nine rows)}.  The n = 8 case is the Lagrange basis of
    a CPU KZG, whose table is built through lagrange_fb_table().  Run in
    threads: the JAX query's first call is mostly XLA compile time."""
    from uzkge_tpu.ff.jax_field import fr_ctx
    from uzkge_tpu_torch.pcs.kzg import KZG

    def run(case):
        n, c, bits = case
        kzg = None
        if n == 8:
            kzg = KZG.setup_insecure(9, tau=TAU, domain_n=8, device="cpu")
            tbl = kzg.lagrange_fb_table()
        else:
            tbl = fb.FixedBaseTable(_case_points(n), c=c, bits=bits, device="cpu")
        assert (tbl.n, tbl.c, tbl.bits) == case
        rows = _scalar_rows(n, bits, n + c)
        sc = fr_ctx.to_mont_limbs([s for row in rows for s in row]).reshape(len(rows), n, 16)
        return case, (kzg, tbl, rows, _jax_table(tbl).msm_mont(sc))

    with ThreadPoolExecutor(len(QUERY_CASES)) as ex:
        return dict(ex.map(run, QUERY_CASES))


@pytest.mark.parametrize("n,c,bits", QUERY_CASES, ids=[f"n{n}-c{c}-bits{b}" for n, c, b in QUERY_CASES])
def test_msm_mont_matches_jax_and_host(query_cases, n, c, bits):
    """msm_mont on P = 9 (the JAX package's result), P = 3 and P = 1 (host
    Pippenger), as affine points; at n = 8 through KZG.commit_evals_batch,
    whose CPU route at n <= 512 is the table."""
    kzg, tbl, rows, want = query_cases[(n, c, bits)]
    assert want == [host_msm(tbl.points, row) for row in rows]
    sc = tf.fr.to_mont_limbs([s for row in rows for s in row], "cpu").reshape(len(rows), n, 8)
    assert tbl.msm_mont(sc) == want
    if kzg is not None:
        assert kzg.uses_fixed_base() and kzg.commit_evals_batch(sc) == want
        assert kzg.commit_evals(sc[3]) == want[3] and kzg._lagrange_vb is None
    assert tbl.msm_mont(sc[2:5].contiguous()) == want[2:5]
    assert tbl.msm_ints(rows[7:]) == want[7:]
    X, Y, Z = tbl.query(sc[:1].contiguous())
    assert X.shape == Y.shape == Z.shape == (1, 8) and fb._extract_host(X, Y, Z) == [None]


# ------------------------------------------------------------ arguments


def test_query_kernels_check_arguments():
    x = torch.zeros(2, 8, 8, dtype=torch.int32)
    inf = torch.zeros(2, 8, dtype=torch.int32)
    table = torch.zeros(8, 4, 16, dtype=torch.int32)
    with pytest.raises(ValueError):
        fb.fb_select(inf[0], table)  # digits not (P, K)
    with pytest.raises(ValueError):
        fb.fb_select(inf[:, :4].contiguous(), table)  # K differs
    with pytest.raises(TypeError):
        fb.fb_select(inf.to(torch.int64), table)
    with pytest.raises(ValueError):
        fb.fb_select(inf.to("meta"), table.to("meta"))  # neither CPU nor card
    with pytest.raises(ValueError):
        fb.fb_pair_den(x[:, :7].contiguous(), inf[:, :7].contiguous())  # odd Kc
    with pytest.raises(ValueError):
        fb.fb_pair_den(x, inf[:, :4].contiguous())
    with pytest.raises(ValueError):
        fb.fb_pair_den(x.transpose(0, 1), inf.t())  # not contiguous
    with pytest.raises(ValueError):
        fb.fb_pair_combine(x, x, x[:, :4].contiguous(), inf[:, :3].contiguous())
    with pytest.raises(ValueError):
        fb.fb_pair_combine(x, x[:1], x[:, :4].contiguous(), inf[:, :4].contiguous())
    with pytest.raises(ValueError):
        fb.fb_fold(x, x, x, 3)
    with pytest.raises(ValueError):
        fb.fb_fold(x, x, x, 16)  # w > Kc
    with pytest.raises(ValueError):
        fb.fb_fold(x, x, x[:, :4].contiguous(), 2)
    big = torch.zeros(1, 2048, 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        fb.fb_fold(big, big, big, 1024)  # w > FOLD_TILE
    with pytest.raises(ValueError):
        fb.fb_fold(big, big, big, 1)
    with pytest.raises(ValueError):
        fb.fold_tail(x[:, :6].contiguous(), x[:, :6].contiguous(), x[:, :6].contiguous())
    with pytest.raises(TypeError):
        fb.fold_tail(x, x, x.to(torch.int64))
    assert fb.fold_tiles(1) == [] and fb.fold_tiles(2**18) == [512, 512]
    assert fb.fold_tiles(65536) == [512, 128] and fb.fold_tiles(2**19) == [512, 512, 2]
    tbl = fb.FixedBaseTable(_case_points(32), c=4, bits=30, device="cpu")
    with pytest.raises(ValueError):
        tbl.query(torch.zeros(1, 16, 8, dtype=torch.int32))  # n differs
    with pytest.raises(ValueError):
        tbl.query(torch.zeros(0, 32, 8, dtype=torch.int32))


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.on_cuda
def test_query_kernels_match_plain(cuda_device):
    """fb_select, fb_pair_den, fb_pair_combine and fb_fold (w = 8, 4, 2) on
    the card against their plain versions on the same inputs, then a whole
    query at n = 32, c = 4 against the CPU's.  The level runs at P = 3, H =
    128 (one combine tile), P = 2, H = 512 (four tiles), and at P = 1 with
    H = 8 and H = 1, below one tile."""
    P, K, D = 3, 512, 8
    rs = np.random.default_rng(9)
    table = _rows(_fq_vals(rs, K * D * 2), (K, D, 2)).reshape(K, D, 16).to(cuda_device)
    digits = torch.from_numpy(rs.integers(-D, D + 1, size=(P, K)).astype(np.int32)).to(cuda_device)
    before = dict(kernels.LAUNCHES)
    for g, w in zip(fb.fb_select(digits, table), fb.fb_select_plain(digits, table)):
        assert torch.equal(g, w)
    for Pl, Kc in ((P, 256), (2, 1024), (1, 16), (1, 2)):
        if Kc >= 12:
            level = _level_inputs(Pl, Kc, 7)
        else:  # too narrow to plant the pairs: random identities
            level = (_rows(_fq_vals(rs, Pl * Kc), (Pl, Kc)), _rows(_fq_vals(rs, Pl * Kc), (Pl, Kc)),
                     torch.from_numpy((rs.random((Pl, Kc)) < 0.3).astype(np.int32)))
        x, y, inf = (t.to(cuda_device) for t in level)
        den, flags = fb.fb_pair_den(x, inf)
        pden, pflags = fb.fb_pair_den_plain(x, inf)
        assert torch.equal(den, pden) and torch.equal(flags, pflags)
        dinv = fb.fq_batch_inv(den.view(-1, 8)).view(den.shape)
        for g, w in zip(fb.fb_pair_combine(x, y, dinv, flags),
                        fb.fb_pair_combine_plain(x, y, dinv, flags)):
            assert torch.equal(g, w), (Pl, Kc)
    for Kc, w in ((64, 8), (4, 4), (2, 2), (512, 512), (256, 128)):
        pts = tuple(t.to(cuda_device) for t in _proj_inputs(P, Kc, Kc))
        for g, p in zip(fb.fb_fold(*pts, w), fb.fb_fold_plain(*pts, w)):
            assert torch.equal(g, p)
    torch.cuda.synchronize()
    for name in ("fb_select", "fb_pair_den", "fb_pair_combine", "fb_fold"):
        assert kernels.LAUNCHES[name] > before[name], name

    pts = _case_points(32)
    rows = _scalar_rows(32, 30, 11)
    got = fb.FixedBaseTable(pts, c=4, bits=30, device=cuda_device).msm_ints(rows)
    assert got == fb.FixedBaseTable(pts, c=4, bits=30, device="cpu").msm_ints(rows)


@pytest.mark.on_cuda
@pytest.mark.parametrize("P", [1, 2, 5, 8])
def test_fold_tail_matches_plain(cuda_device, P):
    """fold_tail on the card against the plain trees on the same inputs, at
    the proof's batches, over Kc = 64 (one launch) and Kc = 1024 (two)."""
    for Kc, launches in ((64, 1), (1024, 2)):
        pts = tuple(t.to(cuda_device) for t in _proj_inputs(P, Kc, P * Kc))
        before = kernels.LAUNCHES["fb_fold"]
        got = fb.fold_tail(*pts)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["fb_fold"] - before == launches
        for g, p in zip(got, fb.fold_tail_plain(*pts)):
            assert torch.equal(g, p)
