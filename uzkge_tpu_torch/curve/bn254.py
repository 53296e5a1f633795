"""BN254 G1/G2 host-side arithmetic (python ints).

G1: y^2 = x^3 + 3 over Fq, affine (x, y) tuples, identity = None.
G2: over Fq2 (tuples of (c0, c1)), twist curve y^2 = x^3 + 3/(9+u).

This layer is the correctness reference for the TPU MSM kernels and handles
the (tiny) verifier-side group arithmetic.  Reference semantics:
ark-bn254 as used in uzkge/src/poly_commit/kzg_poly_commitment.rs.
"""

from ..constants.bn254 import Q_MOD, G1_GENERATOR, G2_GENERATOR_X, G2_GENERATOR_Y, R_MOD

Q = Q_MOD

# ------------------------------ G1 (affine) --------------------------------

G1_GEN = G1_GENERATOR


def g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % Q == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, Q - 2, Q) % Q
    else:
        lam = (y2 - y1) * pow(x2 - x1, Q - 2, Q) % Q
    x3 = (lam * lam - x1 - x2) % Q
    y3 = (lam * (x1 - x3) - y1) % Q
    return (x3, y3)


def g1_neg(p):
    if p is None:
        return None
    return (p[0], (-p[1]) % Q)


def g1_mul(p, k: int):
    k %= R_MOD
    acc = None
    base = p
    while k:
        if k & 1:
            acc = g1_add(acc, base)
        base = g1_add(base, base)
        k >>= 1
    return acc


# ------------------------------ Fq2 ----------------------------------------


def fq2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def fq2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u), u^2 = -1
    a0b0 = a[0] * b[0] % Q
    a1b1 = a[1] * b[1] % Q
    a0b1 = a[0] * b[1] % Q
    a1b0 = a[1] * b[0] % Q
    return ((a0b0 - a1b1) % Q, (a0b1 + a1b0) % Q)


def fq2_scalar(a, k):
    return (a[0] * k % Q, a[1] * k % Q)


def fq2_inv(a):
    norm = (a[0] * a[0] + a[1] * a[1]) % Q
    ninv = pow(norm, Q - 2, Q)
    return (a[0] * ninv % Q, (-a[1]) % Q * ninv % Q)


FQ2_ZERO = (0, 0)

# ------------------------------ G2 (affine over Fq2) -----------------------

G2_GEN = (G2_GENERATOR_X, G2_GENERATOR_Y)


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if fq2_add(y1, y2) == FQ2_ZERO:
            return None
        lam = fq2_mul(fq2_scalar(fq2_mul(x1, x1), 3), fq2_inv(fq2_scalar(y1, 2)))
    else:
        lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    x3 = fq2_sub(fq2_sub(fq2_mul(lam, lam), x1), x2)
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_mul(p, k: int):
    k %= R_MOD
    acc = None
    base = p
    while k:
        if k & 1:
            acc = g2_add(acc, base)
        base = g2_add(base, base)
        k >>= 1
    return acc
