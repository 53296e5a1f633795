"""The on-chain reveal as the benchmark serves it: the benchmark's plain
reference (`zkbench/reference/groth16.py`, `babyjubjub.py`) against the
port, and the SDK's seeded reveal.

  * the reference's reader of the key's verifier part against the port's
    ark readers on the same bytes of groth16_pk.bin, point for point, and
    the key's sizes from its vectors' lengths;
  * the reference verifier accepts the port's groth16.prove(device="cpu")
    proof of the 40-product chain (domain 64, the `g16toy64` case), alone
    and in a batch, and rejects it with one public input changed and with
    C moved;
  * the reference's sk * e1 and sk * G are the public inputs that the
    port's prove_reveal_onchain hands its prover, for seeded keys;
  * sdk.reveal_card_with_snark(..., rng=random.Random(s)) draws r and s as
    prove_reveal_onchain(rng=random.Random(s)) does, and from `_RNG`
    without one (the prover and the key's load stubbed);
  * slow (the key's load ~40 s, a CPU proof ~40 s): the SDK's seeded
    reveal on the CPU, accepted by the reference verifier under the
    reference's read of the key, its words hashing to the golden `reveal`
    digest when given the golden's rng.
"""

import json
import os
import random
import struct
from types import SimpleNamespace

import pytest
import torch

from uzkge_tpu_torch.constants.bn254 import BJJ_GENERATOR, R_MOD
from uzkge_tpu_torch.curve import babyjubjub as tbjj
from uzkge_tpu_torch.curve.bn254 import G1_GEN, g1_add
from uzkge_tpu_torch.groth16 import ark_pk, ark_prove
from uzkge_tpu_torch.groth16 import groth16 as pg
from uzkge_tpu_torch.groth16 import reveal
from uzkge_tpu_torch.shuffle import sdk
from uzkge_tpu_torch.shuffle.primitives import Ciphertext
from uzkge_tpu_torch.utils.serialize import ark_g1_compressed_read, ark_g2_compressed_read
from zkbench.reference import babyjubjub as rbjj
from zkbench.reference import groth16 as rg16

from .torch_golden import g16_rng, g16toy_circuit, words_digest

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PK_BIN = os.path.join(ROOT, "uzkge_tpu", "parameters", "groth16_pk.bin")
GOLDEN = json.load(open(os.path.join(ROOT, "tests", "data", "torch_golden.json")))


def _hex(words):
    return ["0x" + int(w).to_bytes(32, "big").hex() for w in words]


def test_reference_key_reader_matches_the_ports():
    data = open(PK_BIN, "rb").read()
    vk = rg16.read_verifier_key(data)
    assert vk.alpha_g1 == ark_g1_compressed_read(data[0:32])
    assert [vk.beta_g2, vk.gamma_g2, vk.delta_g2] == [
        ark_g2_compressed_read(data[off:off + 64]) for off in (32, 96, 160)]
    n_ic = struct.unpack("<Q", data[224:232])[0]
    assert vk.gamma_abc_g1 == [ark_g1_compressed_read(data[232 + 32 * i:264 + 32 * i])
                               for i in range(n_ic)]
    assert (vk.num_instance, vk.num_variables, vk.num_witness, vk.domain) == (7, 4869, 4862, 8192)
    assert all(rg16.g2_in_group(p) for p in (vk.beta_g2, vk.gamma_g2, vk.delta_g2))


@pytest.fixture(scope="module")
def toy64():
    """The port's setup and CPU proof of the 40-product chain, the proof as
    the contract's words, the key's vk as the reference takes it."""
    cs = g16toy_circuit(products=GOLDEN["g16toy64"]["products"])
    pk = pg.setup(cs, seed=GOLDEN["g16toy64"]["setup_seed"].encode())
    proof = pg.prove(pk, cs, rng=g16_rng(), device="cpu")
    assert words_digest(proof.to_solidity_words()) == GOLDEN["g16toy64"]["sha256"]
    v = pk.vk
    vk = SimpleNamespace(alpha_g1=v.alpha_g1, beta_g2=v.beta_g2, gamma_g2=v.gamma_g2,
                         delta_g2=v.delta_g2, gamma_abc_g1=list(v.gamma_abc_g1))
    return vk, _hex(proof.to_solidity_words()), cs.public_inputs()


def test_reference_verifier_judges_the_ports_proof(toy64):
    vk, words, public = toy64
    proof = rg16.proof_from_words(words)
    assert proof is not None
    A, B, C = proof
    moved = (A, B, g1_add(C, G1_GEN))
    wrong = [public[0], (public[1] + 1) % R_MOD]
    rng = random.Random(1)
    assert rg16.verify_batch(vk, [(proof, public)], rng) == [True]
    # the batch fails, then each proof is checked alone
    assert rg16.verify_batch(vk, [(proof, public), None, (moved, public), (proof, wrong),
                                  (proof, public[:1])], rng) == [True, False, False, False, False]
    bent = list(words)
    bent[0] = "0x" + (int(words[0], 16) + 1).to_bytes(32, "big").hex()
    assert rg16.proof_from_words(bent) is None  # A off the curve
    assert rg16.proof_from_words(words[:7]) is None


def _stub_prover(monkeypatch):
    """prove_reveal_onchain with the key's load and the prover stubbed: each
    call's (instance inputs, r, s) is kept."""
    seen = []

    def prove(apk, matrices, assignment, num_instance, r, s, device=None):
        seen.append((assignment[1:num_instance], r, s))
        return G1_GEN, ((1, 2), (3, 4)), G1_GEN

    monkeypatch.setattr(ark_pk, "load_reference_groth16_pk", lambda: None)
    monkeypatch.setattr(ark_prove, "groth16_prove_with_pk", prove)
    return seen


def test_reference_reveal_values_are_the_ports(monkeypatch):
    assert BJJ_GENERATOR == rbjj.GENERATOR
    seen = _stub_prover(monkeypatch)
    for seed in (1, 2, 3):
        sk, e1 = reveal.seeded_reveal(random.Random(seed))
        pt, _ = reveal.prove_reveal_onchain(sk, e1, rng=random.Random(0), device="cpu")
        want = rbjj.mul(e1, sk)
        pk = rbjj.mul(rbjj.GENERATOR, sk)
        assert pt == want == tbjj.mul(e1, sk)
        assert seen[-1][0] == [e1[0], e1[1], want[0], want[1], pk[0], pk[1]]


def test_sdk_rng_draws_r_and_s_as_prove_reveal_onchain(monkeypatch):
    seen = _stub_prover(monkeypatch)
    sk, e1 = reveal.seeded_reveal(random.Random(7))
    card = sdk.masked_card_serialize(Ciphertext(e1, tbjj.mul(BJJ_GENERATOR, 9)))
    out = sdk.reveal_card_with_snark(sdk.scalar_to_hex(sk), card, device="cpu",
                                     rng=random.Random(41))
    reveal.prove_reveal_onchain(sk, e1, rng=random.Random(41), device="cpu")
    monkeypatch.setattr(sdk, "_RNG", random.Random(41))
    sdk.reveal_card_with_snark(sdk.scalar_to_hex(sk), card, device="cpu")
    want = random.Random(41)
    r, s = want.randrange(1, R_MOD), want.randrange(1, R_MOD)
    assert [x[1:] for x in seen] == [(r, s)] * 3
    assert out["card"] == sdk.point_to_hex(rbjj.mul(e1, sk))
    assert out["snark_proof"] == _hex([G1_GEN[0], G1_GEN[1], 2, 1, 4, 3, G1_GEN[0], G1_GEN[1]])


@pytest.mark.slow
def test_sdk_seeded_reveal_accepted_by_the_reference():
    golden = GOLDEN["reveal"]
    sk, e1 = reveal.seeded_reveal(random.Random(golden["seed"]))
    card = sdk.masked_card_serialize(Ciphertext(e1, tbjj.mul(BJJ_GENERATOR, 17)))
    out = sdk.reveal_card_with_snark(sdk.scalar_to_hex(sk), card, device="cpu",
                                     rng=random.Random(golden["seed"]))
    pt = sdk.hex_to_point(out["card"])
    assert pt == rbjj.mul(e1, sk)
    words = [int(w, 16) for w in out["snark_proof"]] + list(pt)
    assert words_digest(words) == golden["sha256"]
    vk = rg16.read_verifier_key(open(PK_BIN, "rb").read())
    pk = rbjj.mul(rbjj.GENERATOR, sk)
    proof = rg16.proof_from_words(out["snark_proof"])
    assert rg16.verify(vk, proof, [e1[0], e1[1], pt[0], pt[1], pk[0], pk[1]])
    assert not rg16.verify(vk, proof, [e1[0], e1[1], pt[0], pt[1] + 1, pk[0], pk[1]])
