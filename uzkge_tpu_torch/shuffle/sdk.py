"""Stringly-typed game SDK on the torch prover, a copy of
`uzkge_tpu/shuffle/sdk.py` whose proving entry points take a `device`,
mirroring the reference's `shuffle/src/sdk.rs` surface (and the WASM
bindings' names): a stateful, hex-I/O API covering the whole game flow

  init_prover_key -> aggregate_keys -> refresh_joint_key -> init_masked_cards
  -> shuffle_cards -> verify_shuffled_cards -> reveal_card
  (or reveal_card_with_snark) -> unmask_card

Card index <-> point mapping uses the 54-entry deck table
(shuffle/src/card_maps.rs via constants/card_maps.py).
"""

import secrets
from typing import Dict, List, Tuple

from ..constants.bn254 import R_MOD
from ..constants.card_maps import CARD_MAPS
from ..curve import babyjubjub as bjj
from ..ff.host_field import Fr
from ..plonk.indexer import refresh_prover_params_public_key
from ..plonk.proof_io import proof_to_bytes_be, proof_from_bytes_be
from ..crypto.chaum_pedersen import ChaumPedersenDLProof
from . import app
from .primitives import Ciphertext

_PARAMS: Dict[int, tuple] = {}  # n -> (pp, cs, kzg)
# CSPRNG for every piece of proof randomness (blinding, masking, shuffle
# permutations): the reference SDK uses a CSPRNG (default_prng in sdk.rs),
# and a Mersenne Twister seeded with 64 bits would cap the zero-knowledge
# blinding at 64 bits of entropy.
_RNG = secrets.SystemRandom()


# ------------------------------------------------------------ hex helpers


def point_to_hex(pt) -> str:
    """0x || BE x || BE y (matches utils.rs point_to_uncompress hex form)."""
    return "0x" + int(pt[0]).to_bytes(32, "big").hex() + int(pt[1]).to_bytes(32, "big").hex()


def hex_to_point(s: str):
    b = bytes.fromhex(s.removeprefix("0x"))
    return (int.from_bytes(b[:32], "big"), int.from_bytes(b[32:], "big"))


def scalar_to_hex(v: int) -> str:
    return "0x" + int(v).to_bytes(32, "big").hex()


def hex_to_scalar(s: str) -> int:
    return int(s.removeprefix("0x"), 16)


def index_to_point(index: int):
    """Card index -> BabyJubjub point with the mapped y and 'greatest' x
    (sdk.rs:87-94)."""
    y = CARD_MAPS[index] % R_MOD
    # solve a x^2 + y^2 = 1 + d x^2 y^2 for x^2
    num = (y * y - 1) % R_MOD
    den = (bjj.D * y * y - bjj.A) % R_MOD
    x2 = num * pow(den, R_MOD - 2, R_MOD) % R_MOD
    x = Fr.sqrt(x2)
    assert x is not None, "card y not on curve"
    # 'greatest' root convention (ark get_point_from_y_unchecked(y, true))
    if not (x > (R_MOD - x) % R_MOD):
        x = (R_MOD - x) % R_MOD
    return (x, y)


def point_to_index(pt) -> int:
    """(sdk.rs:96-106)"""
    y = pt[1]
    for i, cy in enumerate(CARD_MAPS):
        if cy == y:
            return i
    raise ValueError("point does not map to a card")


def masked_card_serialize(ct: Ciphertext) -> List[str]:
    """-> [e2.x, e2.y, e1.x, e1.y] hex words (sdk.rs:109-113)."""
    return [scalar_to_hex(v) for v in ct.flatten()]


def masked_card_deserialize(words: List[str]) -> Ciphertext:
    v = [hex_to_scalar(w) for w in words]
    return Ciphertext((v[2], v[3]), (v[0], v[1]))


# ------------------------------------------------------------- the SDK


def init_prover_key(num: int, device=None):
    """(sdk.rs:121-131)  The proving key's tensors go to `device` (the card
    by default, see device.py::resolve)."""
    if num not in _PARAMS:
        _PARAMS[num] = app.gen_shuffle_prover_params(num, device)


def generate_keypair() -> Tuple[str, str]:
    kp = app.Keypair.generate(_RNG)
    return scalar_to_hex(kp.secret), point_to_hex(kp.public)


def aggregate_keys(publics: List[str]) -> str:
    """(sdk.rs:133-141)"""
    pk = app.aggregate_keys([hex_to_point(p) for p in publics])
    return point_to_hex(pk)


def refresh_joint_key(joint: str, num: int) -> List[str]:
    """Install the joint public key into the prover params; returns the
    48-word public-key commitment for on-chain use (sdk.rs:143-167)."""
    init_prover_key(num)
    pp, cs, kzg = _PARAMS[num]
    cms = refresh_prover_params_public_key(pp, cs, kzg, hex_to_point(joint))
    out = []
    for cm in cms:
        out.append(scalar_to_hex(cm[0]))
        out.append(scalar_to_hex(cm[1]))
    return out


def init_masked_cards(joint: str, num: int) -> List[dict]:
    """Initial masking of the deck with proofs (sdk.rs:169-194)."""
    joint_pk = hex_to_point(joint)
    out = []
    for i in range(num):
        card = index_to_point(i)
        r = _RNG.randrange(1, bjj.ORDER)
        masked, proof = app.mask(_RNG, joint_pk, card, r)
        out.append(
            {"card": masked_card_serialize(masked), "proof": "0x" + proof.to_uncompress().hex()}
        )
    return out


def verify_masked_card(joint: str, index: int, card: List[str], proof: str) -> bool:
    return app.verify_mask(
        hex_to_point(joint),
        index_to_point(index),
        masked_card_deserialize(card),
        ChaumPedersenDLProof.from_uncompress(bytes.fromhex(proof.removeprefix("0x"))),
    )


def shuffle_cards(joint: str, deck: List[List[str]]) -> dict:
    """(sdk.rs:196-227)"""
    num = len(deck)
    init_prover_key(num)
    pp, cs, kzg = _PARAMS[num]
    joint_pk = hex_to_point(joint)
    inputs = [masked_card_deserialize(c) for c in deck]
    proof, outputs = app.prove_shuffle(_RNG, joint_pk, inputs, pp, kzg)
    return {
        "cards": [masked_card_serialize(c) for c in outputs],
        "proof": "0x" + proof_to_bytes_be(proof).hex(),
    }


def verify_shuffled_cards(deck1: List[List[str]], deck2: List[List[str]], proof: str) -> bool:
    """(sdk.rs:229-259)"""
    num = len(deck1)
    init_prover_key(num)
    pp, _, kzg = _PARAMS[num]
    return app.verify_shuffle(
        pp.verifier_params,
        kzg,
        [masked_card_deserialize(c) for c in deck1],
        [masked_card_deserialize(c) for c in deck2],
        proof_from_bytes_be(bytes.fromhex(proof.removeprefix("0x"))),
    )


def reveal_card(sk: str, card: List[str]) -> dict:
    """(sdk.rs:270-286)"""
    keypair = app.Keypair(hex_to_scalar(sk))
    masked = masked_card_deserialize(card)
    share, proof = app.reveal(_RNG, keypair, masked)
    return {"card": point_to_hex(share), "proof": "0x" + proof.to_uncompress().hex()}


def reveal_card_with_snark(sk: str, card: List[str], device=None, rng=None) -> dict:
    """Reveal share plus a Groth16 proof the DEPLOYED Groth16Verifier.sol
    accepts (sdk.rs:288-326).  snark_proof word order matches the contract
    calldata: [a.x, a.y, b.x.c1, b.x.c0, b.y.c1, b.y.c0, c.x, c.y].  The
    proof's witness map and G1 and G2 MSMs run on `device` (the card by default).
    The proof's randomness r, s comes from `rng` (a `random.Random`-like
    source), `_RNG` when none is given."""
    from ..groth16.reveal import prove_reveal_onchain

    secret = hex_to_scalar(sk)
    masked = masked_card_deserialize(card)
    reveal_pt, (A, B, C) = prove_reveal_onchain(secret, masked.e1,
                                                rng=_RNG if rng is None else rng, device=device)
    snark_proof = [
        scalar_to_hex(A[0]), scalar_to_hex(A[1]),
        scalar_to_hex(B[0][1]), scalar_to_hex(B[0][0]),
        scalar_to_hex(B[1][1]), scalar_to_hex(B[1][0]),
        scalar_to_hex(C[0]), scalar_to_hex(C[1]),
    ]
    return {"card": point_to_hex(reveal_pt), "snark_proof": snark_proof}


def verify_revealed_card(pk: str, card: List[str], reveal: dict) -> bool:
    return app.verify_reveal(
        hex_to_point(pk),
        masked_card_deserialize(card),
        hex_to_point(reveal["card"]),
        ChaumPedersenDLProof.from_uncompress(bytes.fromhex(reveal["proof"].removeprefix("0x"))),
    )


def unmask_card(sk: str, card: List[str], reveals: List[str]) -> int:
    """Final decryption with own key + other players' shares; returns the
    card index (sdk.rs:329-345)."""
    keypair = app.Keypair(hex_to_scalar(sk))
    masked = masked_card_deserialize(card)
    shares = [hex_to_point(r) for r in reveals]
    own_share = bjj.mul(masked.e1, keypair.secret)
    pt = app.unmask(masked, shares + [own_share])
    return point_to_index(pt)
