"""The reference for the zmatchmaking deployment: a lobby drawn from a seed,
the seed's commitment, the Fisher-Yates pairing it commits to
(matchmaking.rs:42-229), and the proof's public inputs."""

import random
from typing import List

from . import anemoi
from .bn254 import R_MOD as P
from .plonk import pairing_inputs

LABEL = b"Plonk Matchmaking Proof"


def lobby(rng: random.Random, players: int):
    """(player ids, committed seed, random number)."""
    return [rng.randrange(P) for _ in range(players)], rng.randrange(P), rng.randrange(P)


def matched(ids: List[int], seed: int, number: int) -> List[int]:
    """Fisher-Yates over the ids: step i swaps i with r = s_i mod (i + 1), s
    the Anemoi stream of (seed, number)."""
    out = list(ids)
    stream = anemoi.stream_cipher([seed, number], len(ids) - 1)
    for i in range(1, len(ids)):
        r = stream[i - 1] % (i + 1)
        out[i], out[r] = out[r], out[i]
    return out


def proof_inputs(vk, ids, outputs, number, commitment, proof):
    return pairing_inputs(LABEL, len(ids), vk, list(ids) + list(outputs) + [number, commitment],
                          proof)
