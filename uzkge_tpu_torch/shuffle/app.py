"""zshuffle application on the torch prover: circuit, keys, prove, verify.

Counterpart of the proving half of `uzkge_tpu/shuffle/app.py` (reference
shuffle/src/{build_cs.rs, gen_params}).  `build_cs` is a copy of the host
circuit builder there (that module imports the JAX prover); everything it
calls is JAX-free host code of `uzkge_tpu`.
"""

import random as _random
from typing import List, Tuple

from uzkge_tpu.curve import babyjubjub as bjj
from uzkge_tpu.plonk import gadgets as _gadgets  # noqa: F401  (attaches gadget methods)
from uzkge_tpu.plonk.cs import TurboCS
from uzkge_tpu.shuffle.primitives import (
    Ciphertext,
    Permutation,
    eval_remark_with_trace,
    sample_random_scalar_bits,
)
from uzkge_tpu.utils.transcript import Transcript

from ..plonk.indexer import ProverParams, indexer
from ..plonk.prover import prover
from ..plonk.verifier import verifier
from ..utils.stagetimer import stage

PLONK_PROOF_TRANSCRIPT = b"Plonk shuffle Proof"


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


def gen_shuffle_prover_params(n_cards: int, device=None) -> Tuple[ProverParams, TurboCS, object]:
    """(shuffle/src/gen_params/params.rs:29-54)  Returns (pp, cs, kzg), with
    the proving key's tensors on `device`."""
    from ..gen_params import load_shuffle_verifier_params, load_srs

    rng = _random.Random(0)
    apk = bjj.mul(bjj.GENERATOR, rng.randrange(1, bjj.ORDER))
    cards = [Ciphertext.rand(rng) for _ in range(n_cards)]
    cs, _ = build_cs(rng, apk, cards)
    kzg = load_srs(cs.size, device)
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
