"""zshuffle application on the torch prover: circuit, keys, prove, verify,
mask / reveal / unmask.

Counterpart of `uzkge_tpu/shuffle/app.py` (reference shuffle/src/{build_cs.rs,
keygen.rs, mask.rs, reveal.rs, gen_params}).  `build_cs` and the game flow
are copies of the host code there, over this package's own copies of the
circuit, card and Chaum-Pedersen primitives (plonk/cs.py, plonk/gadgets.py,
shuffle/primitives.py, crypto/chaum_pedersen.py).
"""

import random as _random
from typing import List, Tuple

from ..crypto.chaum_pedersen import cp_prove, cp_prove0, cp_verify, cp_verify0
from ..curve import babyjubjub as bjj
from ..plonk import gadgets as _gadgets  # noqa: F401  (attaches gadget methods)
from ..plonk.cs import TurboCS
from ..plonk.indexer import ProverParams, indexer
from ..plonk.prover import prover
from ..plonk.verifier import verifier
from ..utils.stagetimer import stage
from ..utils.transcript import Transcript
from .primitives import (
    Ciphertext,
    Permutation,
    eval_remark_with_trace,
    sample_random_scalar_bits,
)

PLONK_PROOF_TRANSCRIPT = b"Plonk shuffle Proof"


# ------------------------------------------------------------------- keygen


class Keypair:
    """(keygen.rs:11-26)"""

    def __init__(self, secret: int):
        self.secret = secret % bjj.ORDER
        self.public = bjj.mul(bjj.GENERATOR, self.secret)

    @staticmethod
    def generate(rng: _random.Random) -> "Keypair":
        return Keypair(rng.randrange(1, bjj.ORDER))


def aggregate_keys(keys: List[Tuple[int, int]]):
    acc = bjj.IDENTITY
    for k in keys:
        acc = bjj.add(acc, k)
    return acc


# ------------------------------------------------------------- mask / reveal


def mask(rng, shared_key, card, r: int):
    """ElGamal mask + Chaum-Pedersen proof (mask.rs:13-35)."""
    e1 = bjj.mul(bjj.GENERATOR, r)
    e2 = bjj.add(card, bjj.mul(shared_key, r))
    ce2 = bjj.add(e2, bjj.neg(card))
    transcript = Transcript(b"Masking")
    proof = cp_prove(rng, bjj.GENERATOR, shared_key, transcript, r, e1, ce2)
    return Ciphertext(e1, e2), proof


def verify_mask(shared_key, card, masked: Ciphertext, proof) -> bool:
    ce2 = bjj.add(masked.e2, bjj.neg(card))
    transcript = Transcript(b"Masking")
    return cp_verify(bjj.GENERATOR, shared_key, transcript, masked.e1, ce2, proof)


def reveal(rng, keypair: Keypair, masked: Ciphertext):
    """Partial decryption share + CP proof (reveal.rs:18-41)."""
    share = bjj.mul(masked.e1, keypair.secret)
    transcript = Transcript(b"Revealing")
    proof = cp_prove(rng, masked.e1, bjj.GENERATOR, transcript, keypair.secret, share, keypair.public)
    return share, proof


def verify_reveal(pk, masked: Ciphertext, reveal_card, proof) -> bool:
    transcript = Transcript(b"Revealing")
    return cp_verify(masked.e1, bjj.GENERATOR, transcript, reveal_card, pk, proof)


def reveal0(rng, keypair: Keypair, masked: Ciphertext):
    """zk-friendly (Anemoi-challenge) reveal (reveal.rs:44-60)."""
    share = bjj.mul(masked.e1, keypair.secret)
    proof = cp_prove0(rng, masked.e1, bjj.GENERATOR, keypair.secret, share, keypair.public)
    return share, proof


def verify_reveal0(pk, masked: Ciphertext, reveal_card, proof) -> bool:
    """(reveal.rs:78-90)"""
    return cp_verify0(masked.e1, bjj.GENERATOR, reveal_card, pk, proof)


def unmask(masked: Ciphertext, reveal_cards: List):
    """e2 - sum(shares) (reveal.rs:93-97)."""
    agg = bjj.IDENTITY
    for r in reveal_cards:
        agg = bjj.add(agg, r)
    return bjj.add(masked.e2, bjj.neg(agg))


# ------------------------------------------------------------------ circuit


def seeded_game(rng, n_cards: int, n_players: int = 4) -> Tuple[tuple, List[Ciphertext]]:
    """A reproducible table: the players' joint key and a deck of `n_cards`
    cards (card i is (i+1)*G) masked under it, all drawn from `rng`."""
    joint = bjj.IDENTITY
    for _ in range(n_players):
        joint = bjj.add(joint, bjj.mul(bjj.GENERATOR, rng.randrange(1, bjj.ORDER)))
    deck = [
        Ciphertext.encrypt(bjj.mul(bjj.GENERATOR, i + 1), joint, rng.randrange(1, bjj.ORDER))
        for i in range(n_cards)
    ]
    return joint, deck


def build_cs(rng, aggregate_public_key, input_cards: List[Ciphertext]):
    """(build_cs.rs:26-55)"""
    n = len(input_cards)
    cs = TurboCS()
    cs.load_shuffle_remark_parameters(aggregate_public_key)

    remark_card_vars = []
    for card in input_cards:
        bits = sample_random_scalar_bits(rng)
        trace, _ = eval_remark_with_trace(card, bits, aggregate_public_key)
        input_var = cs.new_card_variable(card)
        cs.prepare_pi_card_variable(input_var)
        output_var = cs.eval_card_remark(trace, input_var)
        remark_card_vars.append(output_var)

    permutation = Permutation.rand(rng, n)
    shuffled = cs.shuffle_card(remark_card_vars, permutation)
    for cv in shuffled:
        cs.prepare_pi_card_variable(cv)
    cs.pad()
    return cs, shuffled


def gen_shuffle_prover_params(n_cards: int, device=None, fixed_base=None,
                              group=None) -> Tuple[ProverParams, TurboCS, object]:
    """(shuffle/src/gen_params/params.rs:29-54)  Returns (pp, cs, kzg), with
    the proving key's tensors on `device` and the KZG's commit route set by
    `fixed_base` and `group` (see pcs/kzg.py::KZG).  The params serve a KZG
    of any route: `prove_shuffle` takes the KZG apart."""
    from ..gen_params import load_shuffle_verifier_params, load_srs

    rng = _random.Random(0)
    apk = bjj.mul(bjj.GENERATOR, rng.randrange(1, bjj.ORDER))
    cards = [Ciphertext.rand(rng) for _ in range(n_cards)]
    cs, _ = build_cs(rng, apk, cards)
    kzg = load_srs(cs.size, device, fixed_base, group)
    vk = None
    if n_cards in (48, 52, 54):
        vk = load_shuffle_verifier_params(n_cards)
    pp = indexer(cs, kzg, verifier_params=vk, with_shuffle=True)
    return pp, cs, kzg


def prove_shuffle(rng, aggregate_public_key, input_cards: List[Ciphertext],
                  pp: ProverParams, kzg) -> Tuple[dict, List[Ciphertext]]:
    """(build_cs.rs:57-97)"""
    n = len(input_cards)
    with stage("r0_build_cs"):
        cs, output_vars = build_cs(rng, aggregate_public_key, input_cards)
        witness = cs.get_and_clear_witness()

    transcript = Transcript(PLONK_PROOF_TRANSCRIPT)
    transcript.append_u64(n)
    proof = prover(rng, transcript, kzg, cs, pp, witness)

    outputs = []
    for ov in output_vars:
        vals = [witness[v] for v in ov.as_list()]
        outputs.append(Ciphertext((vals[2], vals[3]), (vals[0], vals[1])))
    return proof, outputs


def verify_shuffle(vk, kzg, input_cards: List[Ciphertext], output_cards: List[Ciphertext],
                   proof: dict) -> bool:
    """(build_cs.rs:99-129)"""
    transcript = Transcript(PLONK_PROOF_TRANSCRIPT)
    transcript.append_u64(len(input_cards))
    online_inputs = []
    for c in input_cards:
        online_inputs += c.flatten()
    for c in output_cards:
        online_inputs += c.flatten()
    return verifier(transcript, kzg, vk, online_inputs, proof)
