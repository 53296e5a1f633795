"""zshuffle: a table of the configuration's players and deck, proved turn
after turn on the port (`shuffle/app.py::prove_shuffle`).

Set-up loads the unrefreshed proving key from the port's params cache (the
first run in a checkout indexes the circuit and saves it), deals the
seed's table, and refreshes the key's public-key selectors for its joint
key (`plonk/indexer.py::refresh_prover_params_public_key`), which builds the
fixed-base table on its first commit.  Each request shuffles a deck with a
prover rng drawn from the seed.  The reference judges every proof of the
run against the published key with its own public-key commitments, every
output deck by decryption, and the refresh's commitments.
"""

import os
import random
import time

from ..reference import params
from ..reference import shuffle as ref
from ..reference.plonk import verify_batch
from . import published, sync


class Session:
    def __init__(self, config: dict, traffic, device, root: str):
        self.cfg, self.traffic, self.device, self.root = config, traffic, device, root
        self.pieces = {}

    def setup(self):
        from uzkge_tpu_torch.gen_params import load_srs
        from uzkge_tpu_torch.plonk.indexer import ProverParams, refresh_prover_params_public_key
        from uzkge_tpu_torch.shuffle import app
        from uzkge_tpu_torch.shuffle.primitives import Ciphertext
        from uzkge_tpu_torch.utils import params_cache

        cfg = self.cfg
        t = time.perf_counter()
        self.kzg = load_srs(cfg["n"], self.device, cfg["fixed_base"])
        self.pieces["srs"] = time.perf_counter() - t

        t = time.perf_counter()
        self.table = ref.Table(self.traffic.rng("table"), cfg["n_cards"], cfg["players"])
        self.joint = self.table.joint
        self._Ciphertext = Ciphertext
        self.pieces["table_deal"] = time.perf_counter() - t

        t = time.perf_counter()
        path = os.path.join(params_cache.cache_dir(), f"shuffle-{cfg['n_cards']}-unrefreshed")
        pp = params_cache.load_pp(path, ProverParams, self.device)
        self.pieces["params_cache_hit"] = pp is not None
        if pp is None:
            pp, _, self.kzg = app.gen_shuffle_prover_params(cfg["n_cards"], self.device,
                                                            cfg["fixed_base"])
            params_cache.save_pp(path, pp)
        if pp.n != cfg["n"] or pp.m != cfg["m"]:
            raise RuntimeError(f"circuit n, m = {pp.n}, {pp.m}, not the configuration's")
        self.pp = pp
        self.pieces["proving_key"] = time.perf_counter() - t

        # The refresh reads the circuit's layout (its remark gadgets' rows),
        # which no deck changes: the table's own deck serves.
        t = time.perf_counter()
        cs, _ = app.build_cs(random.Random(0), self.joint,
                             [Ciphertext(e1, e2) for e1, e2 in self.table.deck])
        self.pieces["refresh_circuit"] = time.perf_counter() - t

        t = time.perf_counter()
        self.refresh_cms = refresh_prover_params_public_key(pp, cs, self.kzg, self.joint)
        sync(self.device)
        self.pieces["key_refresh_and_fb_table"] = time.perf_counter() - t
        self.deck = self.table.deck

    def request(self, i: int):
        deck = self.deck if self.traffic.chained or i == 0 else self.table.deck
        return {"i": i, "deck": deck}

    def serve(self, req):
        from uzkge_tpu_torch.shuffle.app import prove_shuffle

        cards = [self._Ciphertext(e1, e2) for e1, e2 in req["deck"]]
        proof, outs = prove_shuffle(self.traffic.rng("prover", req["i"]), self.joint, cards,
                                    self.pp, self.kzg)
        sync(self.device)
        return {"proof": proof, "deck": [(c.e1, c.e2) for c in outs]}

    def accept(self, req, answer):
        self.deck = answer["deck"]

    def release(self):
        self.pp = self.kzg = None

    def judge(self, served):
        """served: [(request, answer or None)].  Returns (verdicts, checks)."""
        cfg = self.cfg
        srs_pad = params.SRS(published(self.root, "srs-padding.bin"))
        vk = params.verifier_key(published(self.root, cfg["vk_file"]), True, srs_pad.g1(0))
        lagrange = params.SRS(published(self.root, cfg["lagrange_srs_file"]))
        sums = ref.selector_rows(lagrange, cfg["remark_rows"], cfg["remark_iterations"])
        gen_wrong = sum(a != b for a, b in zip(ref.selector_commitments(
            ref.bjj.GENERATOR, sums), vk.cm_shuffle_generator_vec))
        vk.cm_shuffle_public_key_vec = ref.selector_commitments(self.joint, sums)
        pk_wrong = sum(a != b for a, b in zip(vk.cm_shuffle_public_key_vec, self.refresh_cms)) \
            + abs(len(self.refresh_cms) - 12)

        items, bad_cards = [], 0
        for req, ans in served:
            if ans is None:
                items.append(None)
                continue
            bad_cards += self.table.bad_cards(ans["deck"])
            try:
                items.append(ref.proof_inputs(vk, req["deck"], ans["deck"], ans["proof"]))
            except (KeyError, IndexError, TypeError, ValueError):
                items.append(None)
        verdicts = verify_batch(items, srs_pad.g2(1), self.traffic.rng("judge"))
        checks = {
            "rows_wrong": (gen_wrong, 0),
            "pk_commitments_wrong": (pk_wrong, 0),
            "cards_wrong": (bad_cards, 0),
            "proofs_rejected": (sum(not v for v in verdicts), 0),
        }
        return verdicts, checks

