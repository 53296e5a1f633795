"""Least times of the variable-base Pippenger on one H100
(`msm_bucket_accumulate`, then `msm_bucket_reduce` on its one chunk), from
the work its inputs need, whatever implements it.  Windows of 8 bits: 32
windows of 256 buckets.  Point additions are counted in Montgomery
products: a mixed addition 11, a projective one 12, a doubling 8
(Renes-Costello-Batina algorithms 8, 7 and 9 with b3 = 9, whose products by
b3 are additions).  A G1 coordinate is 32 bytes, a projective bucket 96.
"""

from ..reference.bn254 import R_MOD
from .bounds import LIMB_BYTES, bound_s

WINDOWS, BUCKETS = 32, 256
MADD_PRODUCTS, PADD_PRODUCTS, DBL_PRODUCTS = 11, 12, 8
BUCKET_BYTES = 3 * LIMB_BYTES


def nonzero_digits(scalars) -> int:
    """Nonzero 8-bit digits of the scalars' standard forms (s mod r), 32
    digits a scalar: the points the accumulate has to add into buckets."""
    return sum(32 - (s % R_MOD).to_bytes(32, "little").count(0) for s in scalars)


def accumulate_s(P: int, n: int, nonzero: int, rate: float) -> float:
    """P MSMs of n points: a mixed addition per nonzero digit; the bases and
    the scalars read once, the (P, 32, 256) buckets written once."""
    nbytes = 2 * n * LIMB_BYTES + P * n * LIMB_BYTES + P * WINDOWS * BUCKETS * BUCKET_BYTES
    return bound_s(nbytes, nonzero * MADD_PRODUCTS, rate)


def reduce_s(P: int, K: int, rate: float) -> float:
    """Per (MSM, window): the fold of 256 buckets over K chunks, 16 segments
    of 15 buckets (two additions each) plus 15 segment heads, and the
    combine of 47 additions and 4 doublings (the running-sum weighted sum's
    count, whatever order the kernel adds in); the buckets read once, the
    window sums written once."""
    adds = P * WINDOWS * (BUCKETS * (K - 1) + 16 * 30 + 15 + 47)
    nbytes = P * K * WINDOWS * BUCKETS * BUCKET_BYTES + P * WINDOWS * BUCKET_BYTES
    return bound_s(nbytes, adds * PADD_PRODUCTS + P * WINDOWS * 4 * DBL_PRODUCTS, rate)


def msm_s(P: int, n: int, nonzero: int, rate: float) -> float:
    """One call of the Pippenger: the accumulate and the reduce at K = 1."""
    return accumulate_s(P, n, nonzero, rate) + reduce_s(P, 1, rate)
