"""The reference for the zshuffle deployment: the table's keys and deck, the
public-key selectors' commitments, the proof's public inputs and the
decryption of every output deck.

A table is drawn from a seed: `players` secret keys, their joint key, and
the deck of `n_cards` cards, card i being (i + 1) G masked under the joint
key.  The circuit's remark gadget of card c sits at rows first + c * stride
.. + iterations - 1; its public-key selectors are, at row j of a gadget,
the x, y and d x y of the four window points m 16^j pk (m = 1..4), the same
in every gadget.  So each selector's commitment over the Lagrange SRS is
sum_j value_j * S_j, S_j being the sum of the Lagrange points at row j of
every gadget.  The same sum with the generator's windows has to give the
published key's generator commitments: that holds the rows to the circuit.
"""

import random
from typing import List, Sequence

from . import babyjubjub as bjj
from .bn254 import g1_msm
from .plonk import pairing_inputs

LABEL = b"Plonk shuffle Proof"


class Table:
    def __init__(self, rng: random.Random, n_cards: int, players: int):
        self.secrets = [rng.randrange(1, bjj.ORDER) for _ in range(players)]
        self.secret = sum(self.secrets) % bjj.ORDER
        self.joint = bjj.IDENTITY
        for s in self.secrets:
            self.joint = bjj.add(self.joint, bjj.mul(bjj.GENERATOR, s))
        self.cards = [bjj.mul(bjj.GENERATOR, i + 1) for i in range(n_cards)]
        self.deck = []  # (e1, e2) pairs
        for m in self.cards:
            r = rng.randrange(1, bjj.ORDER)
            self.deck.append((bjj.mul(bjj.GENERATOR, r), bjj.add(m, bjj.mul(self.joint, r))))

    def decrypt(self, ct) -> tuple:
        e1, e2 = ct
        return bjj.add(e2, bjj.neg(bjj.mul(e1, self.secret)))

    def bad_cards(self, deck: Sequence) -> int:
        """Cards of `deck` that do not decrypt to a distinct card of the
        table: 0 for a permutation of the deck it was dealt."""
        index = {m: i for i, m in enumerate(self.cards)}
        seen, bad = set(), 0
        for ct in deck:
            if not (bjj.on_curve(ct[0]) and bjj.on_curve(ct[1])):
                bad += 1
                continue
            i = index.get(self.decrypt(ct))
            if i is None or i in seen:
                bad += 1
            seen.add(i)
        return bad + max(0, len(self.cards) - len(deck))


def selector_rows(lagrange, rows: dict, iterations: int) -> List:
    """S_j, j < iterations: the sum of the Lagrange points at row j of every
    remark gadget."""
    starts = [rows["first"] + c * rows["stride"] for c in range(rows["count"])]
    return [g1_msm([lagrange.g1(s + j) for s in starts], [1] * len(starts))
            for j in range(iterations)]


def selector_commitments(base, sums: List) -> List:
    """The 12 commitments [x_m, y_m, dxy_m for m = 1..4] of the window
    selectors of `base`, in the key's order (x 0..3, y 0..3, dxy 0..3)."""
    win = bjj.windows(base, len(sums))
    vals = [[p[0] for p in seg] for seg in win], [[p[1] for p in seg] for seg in win], \
        [[p[0] * p[1] % bjj.P * bjj.D % bjj.P for p in seg] for seg in win]
    out = []
    for coord in vals:
        for m in range(4):
            out.append(g1_msm(sums, [coord[j][m] for j in range(len(sums))]))
    return out


def flatten(ct) -> List[int]:
    """A ciphertext's public inputs: e2.x, e2.y, e1.x, e1.y (shuffle/mod.rs:64-68)."""
    e1, e2 = ct
    return [e2[0], e2[1], e1[0], e1[1]]


def proof_inputs(vk, deck_in, deck_out, proof):
    pis = [v for ct in deck_in for v in flatten(ct)] + [v for ct in deck_out for v in flatten(ct)]
    return pairing_inputs(LABEL, len(deck_in), vk, pis, proof)
