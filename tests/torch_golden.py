"""Golden proof digests for the torch port, made by the JAX package.

Runs the seeded shuffle proof of `chip_smoke.py` (or, with `mm50`, its
seeded 50-player matchmaking proof) through `uzkge_tpu` with variable-base
commits (UZKGE_FB=0) and writes its sha256 to tests/data/torch_golden.json:

    UZKGE_FB=0 JAX_PLATFORMS=cpu python tests/torch_golden.py 52
    UZKGE_FB=0 JAX_PLATFORMS=cpu python tests/torch_golden.py mm50
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


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "52"
    assert os.environ.get("UZKGE_FB") == "0", "run with UZKGE_FB=0"
    sys.path.insert(0, ROOT)
    t0 = time.time()
    if mode.startswith("mm"):
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
    }
    with open(GOLDEN, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
        f.write("\n")
    print(mode, digest)


if __name__ == "__main__":
    main()
