"""Golden proof digests for the torch port, made by the JAX package.

Runs the seeded shuffle proof of `chip_smoke.py` (or, with `mm50`, its
seeded 50-player matchmaking proof) through `uzkge_tpu` with variable-base
commits (UZKGE_FB=0) and writes its sha256 to tests/data/torch_golden.json:

    UZKGE_FB=0 JAX_PLATFORMS=cpu python tests/torch_golden.py 52
    UZKGE_FB=0 JAX_PLATFORMS=cpu python tests/torch_golden.py mm50

`reveal` is the seeded Groth16 reveal for the deployed verifier
(`prove_reveal_onchain` on the embedded proving key, host code throughout);
`g16toy` the own-shape Groth16 `setup` + `prove` of a 700-product chain
(domain 1024) with every MSM on the JAX package's host Pippenger (its
device route drops chunks at this n: ROADMAP queue 3), `g16toy64` that of
a 40-product chain (domain 64):

    UZKGE_FB=0 JAX_PLATFORMS=cpu python tests/torch_golden.py reveal
    UZKGE_FB=0 JAX_PLATFORMS=cpu python tests/torch_golden.py g16toy
    UZKGE_FB=0 JAX_PLATFORMS=cpu python tests/torch_golden.py g16toy64
"""

import hashlib
import json
import os
import random
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden.json")
SEED = 52
G16TOY = {"products": 700, "setup_seed": "uzkge-tpu groth16 toy"}  # domain 1024
G16TOY64 = {"products": 40, "setup_seed": "uzkge-tpu groth16 toy"}  # domain 64


def proof_digest(app, refresh, n_cards: int, seed: int = SEED, **params) -> str:
    """sha256 of the on-chain bytes of the seeded n-card shuffle proof made by
    `app` (either package's shuffle app; `params` go to its
    gen_shuffle_prover_params, e.g. device="cpu" for the port)."""
    from uzkge_tpu_torch.plonk.proof_io import proof_to_bytes_be
    from uzkge_tpu_torch.shuffle.app import seeded_game

    pp, cs, kzg = app.gen_shuffle_prover_params(n_cards, **params)
    rng = random.Random(seed)
    joint, deck = seeded_game(rng, n_cards)
    deck = [app.Ciphertext(c.e1, c.e2) for c in deck]  # the app's own card type
    refresh(pp, cs, kzg, joint)
    proof, outputs = app.prove_shuffle(rng, joint, deck, pp, kzg)
    assert app.verify_shuffle(pp.verifier_params, kzg, deck, outputs, proof)
    return hashlib.sha256(proof_to_bytes_be(proof)).hexdigest()


def matchmaking_digest(app, n: int, seed: int = SEED, **params):
    """sha256 of the bytes (generic shape) of the seeded n-player
    matchmaking proof made by `app` (either package's matchmaking app;
    `params` go to its gen_matchmaking_prover_params), and the prover
    params."""
    from uzkge_tpu_torch.hash.anemoi import eval_variable_length_hash
    from uzkge_tpu_torch.matchmaking.app import seeded_match
    from uzkge_tpu_torch.plonk.proof_io import proof_to_bytes_be

    pp, cs, kzg = app.gen_matchmaking_prover_params(n, **params)
    rng = random.Random(seed)
    inputs, committed_seed, random_number = seeded_match(rng, n)
    proof, outputs = app.prove_matchmaking(rng, inputs, committed_seed, random_number, pp, kzg, n)
    assert sorted(outputs) == sorted(inputs)
    commitment = eval_variable_length_hash([committed_seed])
    assert app.verify_matchmaking(pp.verifier_params, kzg, inputs, outputs, commitment,
                                  random_number, proof, n)
    return hashlib.sha256(proof_to_bytes_be(proof, with_shuffle=False)).hexdigest(), pp


def words_digest(words) -> str:
    """sha256 of field elements as 32-byte big-endian words (Solidity's)."""
    return hashlib.sha256(b"".join(int(w).to_bytes(32, "big") for w in words)).hexdigest()


def reveal_digest(reveal, seed: int = SEED, **kw):
    """sha256 of the on-chain words (proof, then reveal point) of the seeded
    reveal made by `reveal` (either package's groth16.reveal module): sk and
    e1 from the port's seeded_reveal(random.Random(seed)), the proof's r and
    s from another random.Random(seed); `kw` go to prove_reveal_onchain
    (device="cpu" for the port).  Also returns (sk, e1, reveal point, proof)."""
    from uzkge_tpu_torch.groth16.reveal import onchain_words, seeded_reveal

    sk, e1 = seeded_reveal(random.Random(seed))
    reveal_pt, proof = reveal.prove_reveal_onchain(sk, e1, rng=random.Random(seed), **kw)
    return words_digest(onchain_words(reveal_pt, proof)), (sk, e1, reveal_pt, proof)


def g16toy_circuit(seed: int = SEED, products: int = G16TOY["products"]):
    """The port's R1CS of the seeded toy: chain_circuit(products, x), x drawn
    from random.Random(seed)."""
    from uzkge_tpu_torch.constants.bn254 import R_MOD
    from uzkge_tpu_torch.groth16.r1cs import chain_circuit

    return chain_circuit(products, random.Random(seed).randrange(1, R_MOD))


def to_jax_r1cs(cs):
    """The same constraint system as the JAX package's R1CS."""
    from uzkge_tpu.groth16.r1cs import LC, R1CS

    out = R1CS()
    out.num_instance = cs.num_instance
    out.assignment = list(cs.assignment)
    out.instance_ids = list(cs.instance_ids)
    out.witness_ids = list(cs.witness_ids)
    out.constraints = [tuple(LC(lc) for lc in row) for row in cs.constraints]
    return out


def g16_rng(seed: int = SEED):
    """The prover's ChaCha20Rng for a seed (either package's accepts it)."""
    from uzkge_tpu_torch.utils.chacha import ChaCha20Rng

    return ChaCha20Rng(seed.to_bytes(32, "little"))


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "52"
    assert os.environ.get("UZKGE_FB") == "0", "run with UZKGE_FB=0"
    sys.path.insert(0, ROOT)
    t0 = time.time()
    extra = {}
    if mode == "reveal":
        from uzkge_tpu.groth16 import reveal
        from uzkge_tpu.groth16.reveal import verify_reveal_onchain

        digest, (sk, e1, reveal_pt, proof) = reveal_digest(reveal)
        from uzkge_tpu.curve import babyjubjub as bjj

        assert verify_reveal_onchain(e1, reveal_pt, bjj.mul(bjj.GENERATOR, sk), proof)
    elif mode in ("g16toy", "g16toy64"):
        import uzkge_tpu.msm.msm as jmsm
        from uzkge_tpu.groth16 import groth16 as jg

        jmsm.HOST_MSM_MAX = 10**9  # the host Pippenger for every MSM
        extra = dict(G16TOY if mode == "g16toy" else G16TOY64)
        cs = to_jax_r1cs(g16toy_circuit(products=extra["products"]))
        pk = jg.setup(cs, seed=extra["setup_seed"].encode())
        proof = jg.prove(pk, cs, rng=g16_rng())
        assert jg.verify(pk.vk, cs.public_inputs(), proof)
        digest = words_digest(proof.to_solidity_words())
    elif mode.startswith("mm"):
        from uzkge_tpu.matchmaking import app

        digest, _ = matchmaking_digest(app, int(mode[2:]))
    else:
        from uzkge_tpu.shuffle import app
        from uzkge_tpu.plonk.indexer import refresh_prover_params_public_key

        digest = proof_digest(app, refresh_prover_params_public_key, int(mode))
    rec = json.load(open(GOLDEN)) if os.path.exists(GOLDEN) else {}
    rec[mode] = {
        "sha256": digest,
        "seed": SEED,
        "command": f"UZKGE_FB=0 JAX_PLATFORMS=cpu python tests/torch_golden.py {mode}",
        "seconds_on_cpu": round(time.time() - t0, 1),
        **extra,
    }
    with open(GOLDEN, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
        f.write("\n")
    print(mode, digest)


if __name__ == "__main__":
    main()
