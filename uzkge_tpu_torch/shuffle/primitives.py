"""Shuffle-layer cryptographic primitives: ElGamal ciphertexts over
BabyJubjub, the signed-window 'remark' (re-randomization) walk with circuit
traces, and permutation matrices.

Reference: uzkge/src/shuffle/{mod.rs, remark.rs, trace.rs, permutation.rs}
and the preprocessed window tables in babyjubjub.rs (extracted to
constants/bjj_generators.py).
"""

import random as _random
from dataclasses import dataclass, field
from typing import List, Tuple

from ..constants.bn254 import R_MOD as P
from ..constants.bjj_generators import GENERATORS_X, GENERATORS_Y, NUM_ITERATIONS
from ..constants.bn254 import EDWARDS_D
from ..curve import babyjubjub as bjj

N_SELECT_BITS = 4
N_WIRE_SELECTORS = 3


@dataclass(frozen=True)
class Ciphertext:
    """ElGamal ciphertext (e1, e2) = (r*G, M + r*pk) on BabyJubjub
    (reference shuffle/mod.rs:22-69). Points are affine (x, y) tuples."""

    e1: Tuple[int, int]
    e2: Tuple[int, int]

    @staticmethod
    def encrypt(m, pk, r: int, ) -> "Ciphertext":
        e1 = bjj.mul(bjj.GENERATOR, r)
        e2 = bjj.add(m, bjj.mul(pk, r))
        return Ciphertext(e1, e2)

    @staticmethod
    def rand(rng: _random.Random) -> "Ciphertext":
        m = bjj.mul(bjj.GENERATOR, rng.randrange(1, bjj.ORDER))
        pk = bjj.mul(bjj.GENERATOR, rng.randrange(1, bjj.ORDER))
        return Ciphertext.encrypt(m, pk, rng.randrange(1, bjj.ORDER))

    def flatten(self) -> List[int]:
        """Public-input order [e2.x, e2.y, e1.x, e1.y] (shuffle/mod.rs:64-68)."""
        return [self.e2[0], self.e2[1], self.e1[0], self.e1[1]]


@dataclass
class RemarkTrace:
    """Per-iteration witness values for the remark gadget
    (reference shuffle/trace.rs:9-18)."""

    bits: List[List[int]] = field(default_factory=list)  # [s1, s2, s3] field values
    intermediate_values: List[List[int]] = field(default_factory=list)  # [c2x,c2y,c1x,c1y]
    output: List[int] = field(default_factory=list)
    n_round: int = 0


def sample_random_scalar_bits(rng: _random.Random) -> List[Tuple[bool, bool, bool]]:
    """84 iterations x 3 random bits (reference remark.rs:19-27)."""
    return [
        (bool(rng.getrandbits(1)), bool(rng.getrandbits(1)), bool(rng.getrandbits(1)))
        for _ in range(NUM_ITERATIONS)
    ]


from functools import lru_cache


@lru_cache(maxsize=16)
def create_windows(base) -> List[List[Tuple[int, int]]]:
    """[{1,2,3,4} * 16^i * base for i in 0..83] (reference remark.rs:39-84,
    both `crate_generators` and `crate_public_keys`).  Cached per base point
    (the 84x4 window walk costs ~1.3k curve adds)."""
    windows = []
    g = base
    for _ in range(NUM_ITERATIONS):
        seg = []
        cur = g
        for _ in range(N_SELECT_BITS):
            seg.append(cur)
            cur = bjj.add(cur, g)
        windows.append(seg)
        for _ in range(N_SELECT_BITS):
            g = bjj.add(g, g)
    return windows


GENERATOR_WINDOWS = [
    [(GENERATORS_X[i][j], GENERATORS_Y[i][j]) for j in range(N_SELECT_BITS)]
    for i in range(NUM_ITERATIONS)
]


def windows_xydxy(windows):
    """Window points -> (x, y, d*x*y) triples used as circuit selectors
    (turbo/mod.rs:926-965)."""
    xs, ys, dxys = [], [], []
    for seg in windows:
        xs.append([p[0] for p in seg])
        ys.append([p[1] for p in seg])
        dxys.append([p[0] * p[1] % P * EDWARDS_D % P for p in seg])
    return xs, ys, dxys


def eval_remark_with_trace(input_ct: Ciphertext, r_bits, pk) -> Tuple[RemarkTrace, Ciphertext]:
    """Signed-window re-randomization walk (reference remark.rs:141-231):
    iteration i adds  sign * mult * 16^i * (G, PK)  with mult = 1 + b0 + 2*b1
    and sign = +1 if b2 else -1; the trace records the [c2x, c2y, c1x, c1y]
    intermediate points and the field-encoded selector bits."""
    assert len(r_bits) == NUM_ITERATIONS
    pks = create_windows(pk)
    gens = GENERATOR_WINDOWS

    c1, c2 = input_ct.e1, input_ct.e2
    trace = RemarkTrace(n_round=NUM_ITERATIONS)
    minus_one = P - 1
    for i, (b0, b1, b2) in enumerate(r_bits):
        sel = int(b0) + 2 * int(b1)
        gp, pp = gens[i][sel], pks[i][sel]
        if not b2:
            gp, pp = bjj.neg(gp), bjj.neg(pp)
        c1 = bjj.add(c1, gp)
        c2 = bjj.add(c2, pp)
        trace.bits.append([int(b0), int(b1), 1 if b2 else minus_one])
        trace.intermediate_values.append([c2[0], c2[1], c1[0], c1[1]])
    trace.output = list(trace.intermediate_values[-1])
    return trace, Ciphertext(c1, c2)


class Permutation:
    """n x n 0/1 permutation matrix (reference shuffle/permutation.rs:5-42)."""

    def __init__(self, matrix: List[List[int]]):
        self.matrix = matrix

    @staticmethod
    def rand(rng: _random.Random, n: int) -> "Permutation":
        matrix = [[0] * n for _ in range(n)]
        remainder = list(range(n))
        for i in range(n):
            r = rng.randrange(len(remainder))
            matrix[i][remainder.pop(r)] = 1
        return Permutation(matrix)

    def __len__(self):
        return len(self.matrix)
