"""The torch port's Pippenger MSM against the JAX package's, exactly.

  * uzkge_tpu_torch/msm/msm.py::msm on a (P, n, 8) tensor batch against
    uzkge_tpu/msm/msm.py::msm on the same device-array batch at n = 1024,
    P = 3 (above HOST_MSM_MAX), with zero scalars and repeated bases;
  * the plain accumulate at two piece lengths through the reduce;
  * on a card (marker on_cuda), the two kernels against their plain versions
    at n = 2048, P = 3 and at n = 16384, P = 1 (the accumulate's buckets
    limb for limb).
Results are otherwise compared as affine points.  JAX is imported inside the test that
uses it, so that the on_cuda tests also run where JAX is absent
(`pytest --noconftest -m on_cuda`).
"""

import numpy as np
import pytest
import torch

from uzkge_tpu_torch.constants.bn254 import R_MOD
from uzkge_tpu_torch.curve.bn254 import G1_GEN, g1_mul
from uzkge_tpu_torch import kernels
from uzkge_tpu_torch.ff import field as tf
from uzkge_tpu_torch.msm import msm as tm

torch.set_num_threads(1)


def _inputs(n: int, P: int, seed: int):
    rs = np.random.default_rng(seed)
    ks = [int(k) for k in rs.integers(1, 1 << 62, size=64)]
    base = [g1_mul(G1_GEN, k) for k in ks]
    points = [base[i % 64] for i in range(n)]  # repeated bases
    words = rs.integers(0, 1 << 32, size=(P, n, 8), dtype=np.uint64)
    rows = [[sum(int(w) << (32 * i) for i, w in enumerate(r)) % R_MOD for r in row]
            for row in words]
    rows[0][:7] = [0] * 7  # zero scalars
    rows[0][7] = R_MOD - 1
    if P > 2:
        rows[2] = [0] * n  # an all-zero row: the identity
    return points, rows


def test_msm_matches_jax():
    from uzkge_tpu.ff.jax_field import fr_ctx
    from uzkge_tpu.msm import msm as jm

    n, P = 1024, 3
    assert n > jm.HOST_MSM_MAX
    points, rows = _inputs(n, P, 7)
    jsc = fr_ctx.to_mont_limbs([s for r in rows for s in r]).reshape(P, n, 16)
    want = jm.msm(jm.MSMBases(points), jsc)
    tsc = tf.from_jax_limbs(np.asarray(jsc), "cpu")
    got = tm.msm(tm.MSMBases(points, "cpu"), tsc)
    assert got == want
    assert got[2] is None


def test_msm_entry_points_and_host_path():
    """List inputs, the single-row forms and the host Pippenger below
    HOST_MSM_MAX all agree."""
    points, rows = _inputs(64, 2, 9)
    bases = tm.MSMBases(points, "cpu")
    want = [tm.host_msm(points, r) for r in rows]
    assert tm.msm(bases, rows) == want  # host path: n <= HOST_MSM_MAX
    assert tm.msm(bases, rows[1]) == want[1]
    t = tf.fr.to_mont_limbs(rows[1], "cpu").reshape(64, 8)
    assert tm.msm(bases, t) == want[1]  # a tensor always takes the device path


def test_plain_halves_compose_across_chunkings():
    """Accumulate with one piece length and another (the pieces and merge
    levels differ): the reduction gives the same affine window sums (buckets
    agree up to the projective representative)."""
    points, rows = _inputs(96, 2, 11)
    bases = tm.MSMBases(points, "cpu")
    std = tf.fr.from_mont(torch.stack([tf.fr.to_mont_limbs(r, "cpu") for r in rows]))
    sums = [tm._window_sums_to_points(
        tm.msm_bucket_reduce(tm.msm_bucket_accumulate(bases.x, bases.y, std, K)))
        for K in (2, 5)]
    assert sums[0] == sums[1] == [tm.host_msm(points, r) for r in rows]


def test_msm_kernels_check_arguments():
    x = torch.zeros(8, 8, dtype=torch.int32)
    std = torch.zeros(1, 8, 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        tm.msm_bucket_accumulate(x, x, std, 0)  # L < 1
    with pytest.raises(ValueError):
        tm.msm_bucket_accumulate(x[:4], x, std, 2)
    with pytest.raises(ValueError):
        tm.msm_bucket_accumulate(x, x, torch.zeros(2048, 8, 8, dtype=torch.int32), 2)  # P * 32
    with pytest.raises(TypeError):
        tm.msm_bucket_reduce(torch.zeros(1, 1, 32, 256, 3, 8, dtype=torch.int64))
    # the proof's batches at n = 16384 on an H100's 132 SMs: the pieces of
    # dense digits, P * 32 * 16384 / L, give at least ACC_WARPS warps an SM,
    # and no piece is longer than ACC_PIECE_MAX
    Ls = {P: tm.pick_piece(16384, P, "cpu") for P in (8, 1, 5, 2)}
    assert Ls == {8: 16, 1: 7, 5: 16, 2: 15}
    for P, L in Ls.items():
        assert P * 32 * 16384 // L >= tm.ACC_WARPS * 32 * tm.H100_SMS
        assert L <= tm.ACC_PIECE_MAX
    assert tm.pick_piece(1024, 3, "cpu") == 2  # never below 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")


@pytest.mark.on_cuda
@pytest.mark.parametrize("n,P", [(2048, 3), (16384, 1)], ids=["n2048P3", "n16384P1"])
def test_msm_kernels_match_plain(cuda_device, n, P):
    """Both kernels against the plain versions and the host Pippenger, at
    the L that pick_piece gives (the accumulate's buckets equal limb for
    limb); n = 16384, P = 1 is the proof's r2_commit."""
    points, rows = _inputs(n, P, 13)
    bases = tm.MSMBases(points, cuda_device)
    sc = torch.stack([tf.fr.to_mont_limbs(r, cuda_device) for r in rows]).to(cuda_device)
    std = tf.fr.from_mont(sc)
    L = tm.pick_piece(n, P, cuda_device)
    before = dict(kernels.LAUNCHES)
    kb = tm.msm_bucket_accumulate(bases.x, bases.y, std, L)
    pb = tm.msm_bucket_accumulate_plain(bases.x, bases.y, std, L)
    ks = tm.msm_bucket_reduce(kb)
    torch.cuda.synchronize()
    assert torch.equal(kb, pb)
    assert kernels.LAUNCHES["msm_bucket_accumulate"] == before["msm_bucket_accumulate"] + 1
    assert kernels.LAUNCHES["msm_bucket_reduce"] == before["msm_bucket_reduce"] + 1
    host = [tm.host_msm(points, r) for r in rows]
    assert tm._window_sums_to_points(ks.cpu()) == host
    assert tm._window_sums_to_points(tm.msm_bucket_reduce_plain(kb).cpu()) == host
    assert tm._window_sums_to_points(tm.msm_bucket_reduce_plain(pb).cpu()) == host
