"""BabyJubjub (twisted Edwards over BN254 Fr) host-side arithmetic.

Affine points as (x, y) int tuples; identity = (0, 1).  The curve is
a*x^2 + y^2 = 1 + d*x^2*y^2 with a = 1 (see constants/bn254.py, validated
against the reference's preprocessed tables).

Used for: witness generation (remark traces, reference
uzkge/src/shuffle/remark.rs), ElGamal masking, Chaum-Pedersen proofs, keygen.
The batched TPU path for bulk Edwards ops lives in uzkge_tpu.ff.jax_field /
msm kernels.
"""

from ..constants.bn254 import R_MOD, EDWARDS_A, EDWARDS_D, BJJ_GENERATOR, BJJ_ORDER

P = R_MOD
A = EDWARDS_A
D = EDWARDS_D

IDENTITY = (0, 1)
GENERATOR = BJJ_GENERATOR
ORDER = BJJ_ORDER


def add(p1, p2):
    """Complete twisted Edwards addition (works for doubling/identity)."""
    x1, y1 = p1
    x2, y2 = p2
    x1y2 = x1 * y2 % P
    y1x2 = y1 * x2 % P
    y1y2 = y1 * y2 % P
    x1x2 = x1 * x2 % P
    dxy = D * x1x2 % P * y1y2 % P
    x3 = (x1y2 + y1x2) * pow(1 + dxy, P - 2, P) % P
    y3 = (y1y2 - A * x1x2) * pow(1 - dxy, P - 2, P) % P
    return (x3, y3)


def neg(p):
    x, y = p
    return ((-x) % P, y)


def double(p):
    return add(p, p)


def mul(p, k: int):
    k %= ORDER
    acc = IDENTITY
    base = p
    while k:
        if k & 1:
            acc = add(acc, base)
        base = add(base, base)
        k >>= 1
    return acc


def msm(points, scalars):
    acc = IDENTITY
    for p, s in zip(points, scalars):
        acc = add(acc, mul(p, s))
    return acc
