"""Groth16 over BN254 as the deployed reveal verifier checks it
(RevealVerifier.sol::verifyRevealWithSnark through Groth16Verifier.sol):

    e(A, B) = e(alpha, beta) * e(IC_0 + sum_i z_i IC_i, gamma) * e(C, delta)

with the verifier part of the published ark proving key
(`shuffle/parameters/groth16_pk.bin`, ark-serialize compressed: alpha_g1,
beta_g2, gamma_g2, delta_g2, gamma_abc_g1, then beta_g1, delta_g1 and the
five query vectors, each a u64 length and its points), read here with this
module's own G2 decompression over Fq2 = Fq[u] / (u^2 + 1).  A proof
crosses the interface as the contract's eight words, [a.x, a.y, b.x.c1,
b.x.c0, b.y.c1, b.y.c0, c.x, c.y].
"""

import random
import re
from types import SimpleNamespace
from typing import List, Optional

from .bn254 import Q_MOD, R_MOD, g1_msm, g1_mul, g1_neg, g1_on_curve, multi_pairing_is_one
from .params import _INF, _NEG, Bytes

Q = Q_MOD
WORD = re.compile(r"0x[0-9a-fA-F]{64}")


# ------------------------------------------------------------------ Fq2

def f2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def f2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def f2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % Q, (a[0] * b[1] + a[1] * b[0]) % Q)


def f2_inv(a):
    n = pow((a[0] * a[0] + a[1] * a[1]) % Q, Q - 2, Q)
    return (a[0] * n % Q, -a[1] * n % Q)


def f2_pow(a, e: int):
    out = (1, 0)
    for bit in bin(e)[2:]:
        out = f2_mul(out, out)
        if bit == "1":
            out = f2_mul(out, a)
    return out


MINUS_ONE = (Q - 1, 0)
TWIST_B = f2_mul((3, 0), f2_inv((9, 1)))  # y^2 = x^3 + 3 / (9 + u)


def f2_sqrt(a):
    """A square root of `a`, or None: q = 3 mod 4, so Algorithm 9 of Adj and
    Rodriguez-Henriquez, "Square root computation over even extension
    fields" (2014)."""
    a1 = f2_pow(a, (Q - 3) // 4)
    alpha = f2_mul(a1, f2_mul(a1, a))
    x0 = f2_mul(a1, a)
    if alpha == MINUS_ONE:
        x = ((-x0[1]) % Q, x0[0])  # u * x0
    else:
        x = f2_mul(f2_pow(f2_add((1, 0), alpha), (Q - 1) // 2), x0)
    return x if f2_mul(x, x) == (a[0] % Q, a[1] % Q) else None


def f2_greater_than_negation(y) -> bool:
    """ark's order on Fq2 (c1 first, then c0): y > -y."""
    n = ((-y[0]) % Q, (-y[1]) % Q)
    return (y[1], y[0]) > (n[1], n[0])


# ------------------------------------------------------------------- G2

def g2_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return f2_mul(y, y) == f2_add(f2_mul(f2_mul(x, x), x), TWIST_B)


def g2_add(p, r):
    if p is None:
        return r
    if r is None:
        return p
    (x1, y1), (x2, y2) = p, r
    if x1 == x2:
        if y1 != y2 or y1 == (0, 0):
            return None
        lam = f2_mul(f2_mul((3, 0), f2_mul(x1, x1)), f2_inv(f2_add(y1, y1)))
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_mul(lam, lam), x1), x2)
    return (x3, f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1))


def g2_mul(p, k: int):
    out = None
    for bit in bin(k)[2:]:
        out = g2_add(out, out)
        if bit == "1":
            out = g2_add(out, p)
    return out


def g2_in_group(p) -> bool:
    """On the twist and of order r (EIP-197 refuses any other G2 input)."""
    return g2_on_curve(p) and g2_mul(p, R_MOD) is None


def g2_compressed(data: bytes):
    """ark's 64-byte compressed G2: x.c0, x.c1 little-endian, the flags in
    byte 63 (bit 6 infinity, bit 7 y > -y)."""
    if len(data) != 64:
        raise ValueError("a compressed G2 point is 64 bytes")
    top = data[63]
    if top & _INF:
        return None
    x = (int.from_bytes(data[:32], "little"),
         int.from_bytes(data[32:63] + bytes([top & 0x3F]), "little"))
    if max(x) >= Q:
        raise ValueError("compressed G2 x not canonical")
    y = f2_sqrt(f2_add(f2_mul(f2_mul(x, x), x), TWIST_B))
    if y is None:
        raise ValueError("compressed G2 x off the twist")
    if f2_greater_than_negation(y) != bool(top & _NEG):
        y = ((-y[0]) % Q, (-y[1]) % Q)
    return (x, y)


# ------------------------------------------------------- the key's reader

def read_verifier_key(data: bytes) -> SimpleNamespace:
    """The verifier part of an ark ProvingKey<Bn254> (compressed), and the
    key's sizes from its vectors' lengths: num_instance (IC points, ONE
    among them), num_variables (a_query), num_witness (l_query) and domain
    (h_query + 1)."""
    r = Bytes(data)
    alpha = r.g1_compressed()
    beta, gamma, delta = (g2_compressed(r.take(64)) for _ in range(3))
    ic = [r.g1_compressed() for _ in range(r.u64())]
    r.take(2 * 32)  # beta_g1, delta_g1
    lengths = {}
    for name, size in (("a", 32), ("b_g1", 32), ("b_g2", 64), ("h", 32), ("l", 32)):
        lengths[name] = r.u64()
        r.take(lengths[name] * size)
    r.done()
    if not lengths["a"] == lengths["b_g1"] == lengths["b_g2"]:
        raise ValueError("the key's a, b_g1 and b_g2 queries differ in length")
    return SimpleNamespace(alpha_g1=alpha, beta_g2=beta, gamma_g2=gamma, delta_g2=delta,
                           gamma_abc_g1=ic, num_instance=len(ic), num_variables=lengths["a"],
                           num_witness=lengths["l"], domain=lengths["h"] + 1)


# ------------------------------------------------------------- the check

def proof_from_words(words):
    """(A, B, C) from the contract's eight hex words, None where they are
    not eight canonical words or a point is not on its curve (G2: in its
    group).  (0, 0) is the identity, as the precompiles take it."""
    if not isinstance(words, (list, tuple)) or len(words) != 8:
        return None
    if not all(isinstance(w, str) and WORD.fullmatch(w) for w in words):
        return None
    w = [int(v[2:], 16) for v in words]
    if max(w) >= Q:
        return None
    A = None if w[0] == w[1] == 0 else (w[0], w[1])
    C = None if w[6] == w[7] == 0 else (w[6], w[7])
    B = None if not any(w[2:6]) else ((w[3], w[2]), (w[5], w[4]))
    if not (g1_on_curve(A) and g1_on_curve(C) and g2_in_group(B)):
        return None
    return A, B, C


def _inputs_ok(vk, inputs) -> bool:
    return len(inputs) == len(vk.gamma_abc_g1) - 1 and all(0 <= x < R_MOD for x in inputs)


def verify(vk, proof, inputs: List[int]) -> bool:
    """One proof, one multi-pairing."""
    if proof is None or not _inputs_ok(vk, inputs):
        return False
    A, B, C = proof
    vk_x = g1_msm(vk.gamma_abc_g1, [1] + list(inputs))
    return multi_pairing_is_one([(A, B), (g1_neg(vk.alpha_g1), vk.beta_g2),
                                 (g1_neg(vk_x), vk.gamma_g2), (g1_neg(C), vk.delta_g2)])


def verify_batch(vk, items: List[Optional[tuple]], rng: random.Random) -> List[bool]:
    """Judge many proofs: `items` are (proof, public inputs), or None for an
    answer refused before the pairing.  One multi-pairing checks a random
    combination rho_i of all of them, a Miller loop per proof and three:
    prod e(rho_i A_i, B_i) = e(sum rho_i alpha, beta) e(sum rho_i vk_x_i,
    gamma) e(sum rho_i C_i, delta).  Only where it fails is each proof
    checked alone.  Returns one verdict per item."""
    out = [False] * len(items)
    live = [i for i, it in enumerate(items)
            if it is not None and it[0] is not None and _inputs_ok(vk, it[1])]
    if not live:
        return out
    rhos = [rng.randrange(1, R_MOD) for _ in live]
    total = sum(rhos) % R_MOD
    weights = [total] + [sum(rho * items[i][1][j] for i, rho in zip(live, rhos)) % R_MOD
                         for j in range(len(vk.gamma_abc_g1) - 1)]
    pairs = [(g1_mul(items[i][0][0], rho), items[i][0][1]) for i, rho in zip(live, rhos)]
    pairs += [(g1_neg(g1_mul(vk.alpha_g1, total)), vk.beta_g2),
              (g1_neg(g1_msm(vk.gamma_abc_g1, weights)), vk.gamma_g2),
              (g1_neg(g1_msm([items[i][0][2] for i in live], rhos)), vk.delta_g2)]
    if multi_pairing_is_one(pairs):
        for i in live:
            out[i] = True
        return out
    for i in live:
        out[i] = verify(vk, *items[i])
    return out
