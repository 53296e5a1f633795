"""zmatchmaking: lobby after lobby proved on the port
(`matchmaking/app.py::prove_matchmaking`).

Set-up loads the proving key from the port's params cache (the first run in
a checkout re-indexes the circuit, the published key being stale, and saves
it).  Each request is a fresh lobby drawn from the seed: the players' ids, a
committed seed and a random number.  The reference recomputes every
lobby's pairing and the seed's commitment, and verifies every proof against
the published key.  That key holds eight selector commitments, q0..q6 and
q_out: it predates the ecc selector (position 7 of the circuit's nine),
which the generic shape never sets, so its commitment is the identity
(`q_identity_positions`).  The program's re-indexed key is held to it,
commitment for commitment.
"""

import os
import time

from ..reference import anemoi, params
from ..reference import matchmaking as ref
from ..reference.plonk import verify_batch
from . import published, sync


# the verifier key's entries that the re-indexed key is held to
KEY_FIELDS = ("cm_q_vec", "cm_s_vec", "cm_qb", "cm_prk_vec", "anemoi_generator",
              "anemoi_generator_inv", "k", "cs_size", "public_vars_constraint_indices",
              "lagrange_constants")


class Session:
    def __init__(self, config: dict, traffic, device, root: str):
        if not isinstance(config.get("vk_file"), str):
            raise ValueError(f"{config.get('name')}: no published key (vk_file); the reference "
                             "would judge the program by its own key")
        self.cfg, self.traffic, self.device, self.root = config, traffic, device, root
        self.pieces = {}

    def setup(self):
        from uzkge_tpu_torch.gen_params import load_srs
        from uzkge_tpu_torch.matchmaking import app
        from uzkge_tpu_torch.plonk.indexer import ProverParams
        from uzkge_tpu_torch.utils import params_cache

        cfg = self.cfg
        t = time.perf_counter()
        self.kzg = load_srs(cfg["n"], self.device, cfg["fixed_base"])
        self.pieces["srs"] = time.perf_counter() - t
        t = time.perf_counter()
        path = os.path.join(params_cache.cache_dir(), f"matchmaking-{cfg['players']}")
        pp = params_cache.load_pp(path, ProverParams, self.device)
        self.pieces["params_cache_hit"] = pp is not None
        if pp is None:
            pp, _, self.kzg = app.gen_matchmaking_prover_params(cfg["players"], self.device,
                                                                cfg["fixed_base"])
            params_cache.save_pp(path, pp)
        if pp.n != cfg["n"] or pp.m != cfg["m"]:
            raise RuntimeError(f"circuit n, m = {pp.n}, {pp.m}, not the configuration's")
        self.pp = pp
        self.vk = pp.verifier_params
        self.pieces["proving_key"] = time.perf_counter() - t
        t = time.perf_counter()
        if cfg["fixed_base"]:
            self.kzg.lagrange_fb_table()
        sync(self.device)
        self.pieces["fb_table"] = time.perf_counter() - t

    def request(self, i: int):
        ids, seed, number = ref.lobby(self.traffic.rng("lobby", i), self.cfg["players"])
        return {"i": i, "ids": ids, "seed": seed, "number": number}

    def serve(self, req):
        from uzkge_tpu_torch.matchmaking.app import prove_matchmaking

        proof, outs = prove_matchmaking(self.traffic.rng("prover", req["i"]), req["ids"],
                                        req["seed"], req["number"], self.pp, self.kzg,
                                        n=self.cfg["players"])
        sync(self.device)
        return {"proof": proof, "outputs": list(outs)}

    def accept(self, req, answer):
        pass

    def release(self):
        self.pp = self.kzg = None

    def published_key(self, g1):
        """The published key, with the configuration's identity commitments
        inserted."""
        vk = params.verifier_key(published(self.root, self.cfg["vk_file"]), False, g1)
        for pos in self.cfg["q_identity_positions"]:
            vk.cm_q_vec.insert(pos, None)
        return vk

    def _key(self, g1):
        """The published key and the count of the program's key entries
        that differ from it."""
        vk, prog = self.published_key(g1), self.vk
        wrong = 0
        for f in KEY_FIELDS:
            a, b = getattr(vk, f), getattr(prog, f)
            if isinstance(a, list):
                wrong += sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
            else:
                wrong += int(a != b)
        return vk, wrong

    def judge(self, served):
        srs_pad = params.SRS(published(self.root, "srs-padding.bin"))
        vk, key_wrong = self._key(srs_pad.g1(0))
        items, out_wrong = [], 0
        for req, ans in served:
            if ans is None:
                items.append(None)
                continue
            want = ref.matched(req["ids"], req["seed"], req["number"])
            out_wrong += want != ans["outputs"]
            commitment = anemoi.hash_vl([req["seed"]])
            try:
                items.append(ref.proof_inputs(vk, req["ids"], ans["outputs"], req["number"],
                                              commitment, ans["proof"]))
            except (KeyError, IndexError, TypeError, ValueError):
                items.append(None)
        verdicts = verify_batch(items, srs_pad.g2(1), self.traffic.rng("judge"))
        checks = {
            "key_commitments_wrong": (key_wrong, 0),
            "lobbies_wrong": (out_wrong, 0),
            "proofs_rejected": (sum(not v for v in verdicts), 0),
        }
        return verdicts, checks
