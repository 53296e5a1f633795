"""The port's zshuffle game flow (keys, mask, reveal, unmask), its
Chaum-Pedersen proofs, card maps and SDK host functions against the JAX
package, exactly.

  * keys, masks, reveals (the transcript CP proof and the Anemoi one) and
    unmask from one seeded `random.Random` give equal points and equal
    `ChaumPedersenDLProof` bytes, and both packages verify each other's
    proofs;
  * the card maps and the hex helpers are equal (all 54 cards);
  * the SDK's host functions, with `_RNG` replaced in both packages by one
    seeded `random.Random`, give equal hex outputs, through a 2-player
    game of 2 cards: keypairs, `aggregate_keys`, `init_masked_cards`,
    `verify_masked_card`, `reveal_card`, `verify_revealed_card`,
    `unmask_card`.  (`shuffle_cards` and `refresh_joint_key` need 52-card
    prover params: the card's smoke run drives them.)
"""

import inspect
import random

import pytest

from uzkge_tpu.crypto import chaum_pedersen as jcp
from uzkge_tpu.shuffle import app as japp
from uzkge_tpu.shuffle import sdk as jsdk
from uzkge_tpu.shuffle.primitives import Ciphertext as JaxCiphertext
from uzkge_tpu_torch.crypto import chaum_pedersen as tcp
from uzkge_tpu_torch.curve import babyjubjub as bjj
from uzkge_tpu_torch.shuffle import app as tapp
from uzkge_tpu_torch.shuffle import sdk as tsdk


def _flow(app, cp, sdk, seed: int, n_players: int = 2):
    """One table's game flow through `app`, every draw from one rng; returns
    what it made, points and proof bytes.  (Two players: a host BabyJubjub
    product takes ~0.2 s, and each player adds ~18 of them.)"""
    rng = random.Random(seed)
    players = [app.Keypair.generate(rng) for _ in range(n_players)]
    joint = app.aggregate_keys([p.public for p in players])
    card = sdk.index_to_point(17)
    masked, mproof = app.mask(rng, joint, card, rng.randrange(1, bjj.ORDER))
    assert app.verify_mask(joint, card, masked, mproof)
    assert not app.verify_mask(joint, sdk.index_to_point(18), masked, mproof)
    shares, proofs, proofs0 = [], [], []
    for p in players:
        share, proof = app.reveal(rng, p, masked)
        share0, proof0 = app.reveal0(rng, p, masked)
        assert share0 == share
        assert app.verify_reveal(p.public, masked, share, proof)
        assert app.verify_reveal0(p.public, masked, share, proof0)
        other = players[1] if p is players[0] else players[0]
        assert not app.verify_reveal0(other.public, masked, share, proof0)
        shares.append(share)
        proofs.append(proof.to_uncompress())
        proofs0.append(proof0.to_uncompress())
    assert app.unmask(masked, shares) == card
    return dict(secrets=[p.secret for p in players], joint=joint, e1=masked.e1, e2=masked.e2,
                mask_proof=mproof.to_uncompress(), shares=shares, proofs=proofs,
                proofs0=proofs0, tail=rng.random())


def test_game_flow_matches_jax():
    assert _flow(tapp, tcp, tsdk, 21) == _flow(japp, jcp, jsdk, 21)


def test_proofs_cross_verify():
    rng = random.Random(23)
    kp = tapp.Keypair.generate(rng)
    card = tsdk.index_to_point(3)
    masked, proof = tapp.mask(rng, kp.public, card, rng.randrange(1, bjj.ORDER))
    jproof = jcp.ChaumPedersenDLProof.from_uncompress(proof.to_uncompress())
    jmasked = JaxCiphertext(masked.e1, masked.e2)
    assert japp.verify_mask(kp.public, card, jmasked, jproof)
    share, rproof = japp.reveal0(rng, japp.Keypair(kp.secret), jmasked)
    back = tcp.ChaumPedersenDLProof.from_uncompress(rproof.to_uncompress())
    assert tapp.verify_reveal0(kp.public, masked, share, back)
    w = rng.randrange(1, bjj.ORDER)
    h = bjj.mul(bjj.GENERATOR, 777)
    c1, c2 = bjj.mul(bjj.GENERATOR, w), bjj.mul(h, w)
    p0 = tcp.cp_prove0(random.Random(5), bjj.GENERATOR, h, w, c1, c2)
    assert p0.to_uncompress() == \
        jcp.cp_prove0(random.Random(5), bjj.GENERATOR, h, w, c1, c2).to_uncompress()
    assert not tcp.cp_verify0(bjj.GENERATOR, h, bjj.mul(bjj.GENERATOR, w + 1), c2, p0)


def test_card_maps_and_hex_helpers_match_jax():
    from uzkge_tpu.constants.card_maps import CARD_MAPS as JAX_MAPS
    from uzkge_tpu_torch.constants.card_maps import CARD_MAPS

    assert CARD_MAPS == JAX_MAPS and len(CARD_MAPS) == 54
    for i in range(54):
        pt = tsdk.index_to_point(i)
        assert pt == jsdk.index_to_point(i) and tsdk.point_to_index(pt) == i
        assert tsdk.point_to_hex(pt) == jsdk.point_to_hex(pt)
        assert tsdk.hex_to_point(tsdk.point_to_hex(pt)) == pt
    with pytest.raises(ValueError):
        tsdk.point_to_index(bjj.GENERATOR)
    v = random.Random(24).randrange(bjj.ORDER)
    assert tsdk.scalar_to_hex(v) == jsdk.scalar_to_hex(v)
    assert tsdk.hex_to_scalar(tsdk.scalar_to_hex(v)) == v
    ct = tapp.Ciphertext(bjj.mul(bjj.GENERATOR, 5), bjj.mul(bjj.GENERATOR, 6))
    words = tsdk.masked_card_serialize(ct)
    assert words == jsdk.masked_card_serialize(JaxCiphertext(ct.e1, ct.e2))
    back = tsdk.masked_card_deserialize(words)
    assert (back.e1, back.e2) == (ct.e1, ct.e2)


def _sdk_flow(sdk, n_cards: int, n_players: int = 2):
    players = [sdk.generate_keypair() for _ in range(n_players)]
    joint = sdk.aggregate_keys([pk for _, pk in players])
    deck = sdk.init_masked_cards(joint, n_cards)
    assert all(sdk.verify_masked_card(joint, i, c["card"], c["proof"])
               for i, c in enumerate(deck))
    assert not sdk.verify_masked_card(joint, 1, deck[0]["card"], deck[0]["proof"])
    out = dict(players=players, joint=joint, deck=deck, reveals=[], indices=[])
    for c in deck:
        reveals = [sdk.reveal_card(sk, c["card"]) for sk, _ in players]
        assert all(sdk.verify_revealed_card(pk, c["card"], r)
                   for (_, pk), r in zip(players, reveals))
        assert not sdk.verify_revealed_card(players[1][1], c["card"], reveals[0])
        out["reveals"].append(reveals)
        out["indices"].append(sdk.unmask_card(players[0][0], c["card"],
                                              [r["card"] for r in reveals[1:]]))
    return out


def test_sdk_host_functions_match_jax(monkeypatch):
    monkeypatch.setattr(tsdk, "_RNG", random.Random(25))
    monkeypatch.setattr(jsdk, "_RNG", random.Random(25))
    t = _sdk_flow(tsdk, 2)
    assert t == _sdk_flow(jsdk, 2)
    assert t["indices"] == [0, 1]
    assert tsdk._RNG.random() == jsdk._RNG.random()  # the same number of draws
    # the Groth16 reveal (tests/test_torch_groth16_ark.py): the JAX
    # package's arguments, then the device its MSMs and NTTs run on and the
    # source of its proof's r and s (tests/test_torch_reveal_cell.py)
    assert list(inspect.signature(tsdk.reveal_card_with_snark).parameters) == [
        *inspect.signature(jsdk.reveal_card_with_snark).parameters, "device", "rng"]


def test_sdk_default_rng_is_a_csprng():
    import secrets

    assert isinstance(tsdk._RNG, secrets.SystemRandom)
