"""Golden proof digest for the torch port, made by the JAX package.

Runs the seeded shuffle proof of `chip_smoke.py` through `uzkge_tpu` with
variable-base commits (UZKGE_FB=0) and writes its sha256 to
tests/data/torch_golden.json:

    UZKGE_FB=0 JAX_PLATFORMS=cpu python tests/torch_golden.py 52
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


def proof_digest(app, refresh, n_cards: int, seed: int = SEED) -> str:
    """sha256 of the on-chain bytes of the seeded n-card shuffle proof."""
    from uzkge_tpu.plonk.proof_io import proof_to_bytes_be
    from uzkge_tpu_torch.shuffle.app import seeded_game

    pp, cs, kzg = app.gen_shuffle_prover_params(n_cards)
    rng = random.Random(seed)
    joint, deck = seeded_game(rng, n_cards)
    refresh(pp, cs, kzg, joint)
    proof, outputs = app.prove_shuffle(rng, joint, deck, pp, kzg)
    assert app.verify_shuffle(pp.verifier_params, kzg, deck, outputs, proof)
    return hashlib.sha256(proof_to_bytes_be(proof)).hexdigest()


def main():
    n_cards = int(sys.argv[1]) if len(sys.argv) > 1 else 52
    assert os.environ.get("UZKGE_FB") == "0", "run with UZKGE_FB=0"
    sys.path.insert(0, ROOT)
    from uzkge_tpu.shuffle import app
    from uzkge_tpu.plonk.indexer import refresh_prover_params_public_key

    t0 = time.time()
    digest = proof_digest(app, refresh_prover_params_public_key, n_cards)
    rec = json.load(open(GOLDEN)) if os.path.exists(GOLDEN) else {}
    rec[str(n_cards)] = {
        "sha256": digest,
        "seed": SEED,
        "command": f"UZKGE_FB=0 JAX_PLATFORMS=cpu python tests/torch_golden.py {n_cards}",
        "seconds_on_cpu": round(time.time() - t0, 1),
    }
    with open(GOLDEN, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
        f.write("\n")
    print(n_cards, digest)


if __name__ == "__main__":
    main()
