"""The commits' blinding in native code (`native_host.g1_blind`,
csrc/hostmath.c's Jacobian G1 routine) against the Python affine arithmetic
of curve/bn254.py (`g1_add`, `g1_mul`), exactly:
  * single scalar multiples at the scalars that break windowed and Jacobian
    code: 1, 2, 3, r - 1, r - 2, powers of two and one less at window and
    limb edges, scalars at or above 2^253, all-ones digit patterns, and
    scalars at or above r (reduced first);
  * `KZG.apply_blind_factors` on blind lists of length 0 to 5 at zeroing
    degrees 4, 64 and 8192, zero blinds among them, against the loop it
    replaced (two `g1_mul` a nonzero blind);
  * a commitment that is the identity, that cancels the blinds' sum (the
    result is the identity), that equals it (the last addition doubles),
    and terms that meet mid-chain (P + P, P + (-P));
  * linearity over thousands of random scalars: g1_blind(cm, [P], [a]) +
    g1_blind(O, [P], [b]) == g1_blind(cm, [P], [a + b mod r]);
  * threads calling at once get the serial answers.
"""

import random
import sys
import threading

import pytest

from uzkge_tpu_torch import kernels
from uzkge_tpu_torch import native_host as nh
from uzkge_tpu_torch.constants.bn254 import R_MOD
from uzkge_tpu_torch.curve.bn254 import G1_GEN, g1_add, g1_is_on_curve, g1_mul, g1_neg
from uzkge_tpu_torch.pcs.kzg import KZG

P1 = g1_mul(G1_GEN, 0x5EED5EED5EED5EED5EED5EED5EED5EED5EED5EED5EED5EED5EED5EED5EED)


def _ref(cm, points, scalars):
    out = cm
    for p, s in zip(points, scalars):
        out = g1_add(out, g1_mul(p, s))
    return out


_SCALARS = (
    [1, 2, 3, 4, 5, 15, 16, 17, R_MOD - 1, R_MOD - 2, R_MOD - 3, (R_MOD - 1) // 2,
     (R_MOD + 1) // 2]
    + [(1 << k) - d for k in (4, 8, 32, 63, 64, 65, 128, 192, 252, 253) for d in (0, 1)]
    + [1 << 253 | 1, R_MOD - (1 << 200), (1 << 253) + 0xFF]
    + [int("f" * 63, 16), int("0f" * 31, 16), int("11" * 31, 16), int("ff" * 31, 16),
       int("8" + "0" * 62, 16) | 1]
    + [R_MOD, R_MOD + 1, 2 * R_MOD + 5, (1 << 256) - 1, (1 << 255) + 7, 5 * R_MOD - 1]
)


@pytest.mark.parametrize("s", _SCALARS, ids=lambda s: hex(s)[:18])
def test_scalar_multiple_matches_g1_mul(s):
    point = P1 if s & 1 else G1_GEN
    want = g1_mul(point, s)
    assert nh.g1_blind(None, [point], [s]) == want
    if want is not None:
        assert g1_is_on_curve(want)


def _powers(z: int, count: int):
    """A sparse g1_powers list: G_i = (i + 1) * P1 at i < count and at
    z <= i < z + count, None elsewhere (the SRS's gaps look alike)."""
    g = [None] * (z + count)
    for start in (0, z):
        acc = g1_mul(P1, start)
        for i in range(start, start + count):
            acc = g1_add(acc, P1)
            g[i] = acc
    return g


@pytest.mark.parametrize("z", [4, 64, 8192])
@pytest.mark.parametrize("length", range(6))
def test_apply_blind_factors_matches_python(z, length):
    rng = random.Random(z * 10 + length)
    kzg = KZG(_powers(z, 5), [], device="cpu")
    blinds = [rng.randrange(R_MOD) for _ in range(length)]
    if length >= 3:
        blinds[1] = 0  # skipped
    if length >= 5:
        blinds[4] = blinds[0]  # at z = 4, -b0 G_4 + b4 G_4 cancel
        blinds[2] = R_MOD + 7  # above r
    cm = g1_mul(P1, rng.randrange(R_MOD))
    want = cm
    for i, b in enumerate(blinds):
        if b % R_MOD == 0:
            continue
        want = g1_add(want, g1_mul(kzg.g1_powers[i], b))
        want = g1_add(want, g1_mul(kzg.g1_powers[z + i], (-b) % R_MOD))
    before = kernels.CALLS.get("g1_blind", 0)
    assert kzg.apply_blind_factors(cm, blinds, z) == want
    assert kernels.CALLS.get("g1_blind", 0) - before == int(any(b % R_MOD for b in blinds))


def _edge_case(name):
    b = [0x1234567890ABCDEF << 180 | 77, R_MOD - 99]
    pts = [G1_GEN, P1]
    total = _ref(None, pts, b)
    if name == "cm_none":
        return None, pts, b
    if name == "cm_cancels":
        return g1_neg(total), pts, b
    if name == "cm_equals_sum":
        return total, pts, b
    if name == "zero_blinds_mixed":
        return P1, [G1_GEN, P1, G1_GEN], [0, b[0], R_MOD]
    if name == "same_point_twice":  # acc meets P at the first set bit
        return None, [P1, P1], [b[0], b[0]]
    if name == "point_and_negation":  # acc + (-P) = O mid-chain
        return G1_GEN, [P1, g1_neg(P1)], [b[1], b[1]]
    if name == "point_and_double":  # acc = P, then P again, then 2P
        return P1, [P1, P1, g1_add(P1, P1)], [1, 1, 3]
    if name == "all_zero":
        return P1, [P1, G1_GEN], [0, R_MOD]
    if name == "identity_point":
        return P1, [None, G1_GEN], [5, 6]
    raise ValueError(name)


_EDGES = ["cm_none", "cm_cancels", "cm_equals_sum", "zero_blinds_mixed", "same_point_twice",
          "point_and_negation", "point_and_double", "all_zero", "identity_point"]


@pytest.mark.parametrize("name", _EDGES)
def test_edge_cases_match_python(name):
    cm, pts, sc = _edge_case(name)
    want = _ref(cm, pts, sc)
    assert nh.g1_blind(cm, pts, sc) == want
    if name == "cm_cancels":
        assert want is None


def test_linearity_over_random_scalars():
    rng = random.Random(2024)
    points = [G1_GEN, P1, g1_neg(P1), g1_add(P1, G1_GEN)]
    cms = [None, G1_GEN, P1]
    for t in range(3000):
        p, cm = points[t % 4], cms[t % 3]
        a, b = rng.randrange(1 << 256), rng.randrange(1 << 256)
        if t % 97 == 0:
            b = (-a) % R_MOD
        lhs = g1_add(nh.g1_blind(cm, [p], [a]), nh.g1_blind(None, [p], [b]))
        assert lhs == nh.g1_blind(cm, [p], [(a + b) % R_MOD]), (t, a, b)


def test_threads_get_the_serial_answers():
    rng = random.Random(7)
    cases = [(rng.choice([None, P1, G1_GEN]), [P1, G1_GEN, g1_neg(P1)][: 1 + i % 3],
              [rng.randrange(R_MOD) for _ in range(1 + i % 3)]) for i in range(150)]
    want = [nh.g1_blind(*c) for c in cases]
    got = [None, None]

    def work(k):
        got[k] = [nh.g1_blind(*c) for c in cases]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert got[0] == want and got[1] == want
