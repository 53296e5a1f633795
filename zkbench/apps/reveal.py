"""zshuffle's on-chain card reveal: Groth16 reveals through the port's SDK
(`shuffle/sdk.py::reveal_card_with_snark`, which proves with
`groth16/reveal.py::prove_reveal_onchain` under the published key).

Set-up deals the seed's table (the players' secret keys, the deck masked
under their joint key) and loads the published proving key through the
program, holding its sizes to the configuration's.  Request i is player
i mod players revealing card (i div players) mod n_cards of the dealt deck,
so each card is revealed by every player in turn; it goes in as the SDK's
hex words (the secret key, the masked card as [e2.x, e2.y, e1.x, e1.y]),
with the proof's r and s from the seed.  The answer is the SDK's dict: the
reveal point and the proof's eight words.

The reference judges every answer of the run: each proof under the key's
verifier part as the reference reads it from the published file, with the
public inputs in the contract's order (`proofs_rejected`); each reveal
point against sk * e1 (`reveals_wrong`); each card whose shares all came
back, unmasked (`cards_wrong`); and the program's verifier key entry for
entry against the reference's read (`vk_wrong`).

While a request is served, the Pippenger entry that the Groth16 prover
calls (`groth16/ark_prove.py`'s `msm`) is wrapped: the inputs of every call
and the program's count of `msm_bucket_reduce` launches are kept a request
for `msm_roofline`.  A metric reader is handed only the harness's `Run`,
whose `config` is the dict this session was given, so they are kept there,
under `OBSERVED`.
"""

import inspect
import sys
import time
from contextlib import contextmanager
from types import SimpleNamespace

from ..reference import babyjubjub as bjj
from ..reference import groth16 as ref
from ..reference.shuffle import Table
from . import published, sync

# the configuration's key under which a run's Pippenger calls are kept: one
# entry a request served, in order, {"calls": [(P, n, scalars, host)],
# "reduce_launches": int}
OBSERVED = "_observed_msm_calls"
VK_FIELDS = ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2")
SIZES = ("domain", "num_instance", "num_witness")


def word(v: int) -> str:
    return "0x" + int(v).to_bytes(32, "big").hex()


def point_from_hex(s):
    """(x, y) from the SDK's 0x-prefixed 64-byte hex, None if malformed."""
    if not (isinstance(s, str) and len(s) == 130 and ref.WORD.fullmatch(s[:66])
            and ref.WORD.fullmatch("0x" + s[66:])):
        return None
    return int(s[2:66], 16), int(s[66:], 16)


class Session:
    def __init__(self, config: dict, traffic, device, root: str):
        from uzkge_tpu_torch.shuffle import sdk

        if not isinstance(config.get("pk_file"), str):
            raise ValueError(f"{config.get('name')}: no published proving key (pk_file)")
        if "rng" not in inspect.signature(sdk.reveal_card_with_snark).parameters:
            raise RuntimeError(
                "this program's shuffle/sdk.py::reveal_card_with_snark takes no rng: a reveal's "
                "proof randomness cannot come from the run's seed, so the run could be neither "
                "replayed nor judged again; the cell needs an SDK that takes one")
        self.cfg, self.traffic, self.device, self.root = config, traffic, device, root
        self.pieces = {}
        self.observed = config[OBSERVED] = []

    def setup(self):
        from uzkge_tpu_torch.groth16.ark_pk import load_reference_groth16_pk

        cfg = self.cfg
        t = time.perf_counter()
        self.table = Table(self.traffic.rng("table"), cfg["n_cards"], cfg["players"])
        self.publics = [bjj.mul(bjj.GENERATOR, s) for s in self.table.secrets]
        self.pieces["table_deal"] = time.perf_counter() - t

        t = time.perf_counter()
        pk = load_reference_groth16_pk()
        got = {"domain": pk.domain_size, "num_instance": pk.num_instance,
               "num_witness": pk.num_witness}
        if any(got[k] != cfg[k] for k in SIZES):
            raise RuntimeError(f"the proving key's sizes {got} are not the configuration's")
        vk = pk.vk
        self.vk = SimpleNamespace(**{f: getattr(vk, f) for f in VK_FIELDS},
                                  gamma_abc_g1=list(vk.gamma_abc_g1))
        self.pieces["proving_key"] = time.perf_counter() - t

    def request(self, i: int):
        players = self.cfg["players"]
        p, c = i % players, (i // players) % self.cfg["n_cards"]
        e1, e2 = self.table.deck[c]
        return {"i": i, "player": p, "card": c, "sk": word(self.table.secrets[p]),
                "masked": [word(v) for v in (e2[0], e2[1], e1[0], e1[1])]}

    @contextmanager
    def _observed(self):
        """The Groth16 prover's Pippenger calls and the program's count of
        msm_bucket_reduce launches while the block runs, kept in
        `self.observed`."""
        from uzkge_tpu_torch import kernels
        from uzkge_tpu_torch.groth16 import ark_prove
        from uzkge_tpu_torch.msm import msm as pippenger

        msm, calls = ark_prove.msm, []

        def seen(bases, scalars):
            rows = scalars if scalars and isinstance(scalars[0], (list, tuple)) else [scalars]
            calls.append((len(rows), bases.n, [s for row in rows for s in row],
                          bases.n <= pippenger.HOST_MSM_MAX))
            return msm(bases, scalars)

        before = kernels.LAUNCHES.get("msm_bucket_reduce", 0)
        ark_prove.msm = seen
        try:
            yield
        finally:
            ark_prove.msm = msm
            self.observed.append({"calls": calls, "reduce_launches":
                                  kernels.LAUNCHES.get("msm_bucket_reduce", 0) - before})

    def serve(self, req):
        from uzkge_tpu_torch.shuffle import sdk

        with self._observed():
            ans = sdk.reveal_card_with_snark(req["sk"], req["masked"], device=self.device,
                                             rng=self.traffic.rng("prover", req["i"]))
            sync(self.device)
        return ans

    def accept(self, req, answer):
        pass

    def release(self):
        from uzkge_tpu_torch.groth16.ark_pk import load_reference_groth16_pk

        load_reference_groth16_pk()._msm_cache.clear()

    def judge(self, served):
        """served: [(request, answer or None)].  Returns (verdicts, checks)."""
        vk = ref.read_verifier_key(published(self.root, self.cfg["pk_file"]))
        mine = self.vk
        vk_wrong = sum(getattr(vk, f) != getattr(mine, f) for f in VK_FIELDS) \
            + sum(a != b for a, b in zip(vk.gamma_abc_g1, mine.gamma_abc_g1)) \
            + abs(len(vk.gamma_abc_g1) - len(mine.gamma_abc_g1))

        items, reveals_wrong, shares = [], 0, {}
        for req, ans in served:
            if ans is None:
                items.append(None)
                continue
            p, c = req["player"], req["card"]
            e1 = self.table.deck[c][0]
            ans = ans if isinstance(ans, dict) else {}
            pt = point_from_hex(ans.get("card"))
            reveals_wrong += pt != bjj.mul(e1, self.table.secrets[p])
            shares.setdefault(c, {})[p] = pt
            proof = ref.proof_from_words(ans.get("snark_proof"))
            pk = self.publics[p]
            items.append(None if pt is None else (proof, [e1[0], e1[1], pt[0], pt[1], pk[0], pk[1]]))
        verdicts = ref.verify_batch(vk, items, self.traffic.rng("judge"))

        cards_wrong = 0
        for c, got in shares.items():
            if len(got) < self.cfg["players"]:
                continue
            pts = list(got.values())
            if None in pts or not all(bjj.on_curve(q) for q in pts):
                cards_wrong += 1
                continue
            total = bjj.IDENTITY
            for q in pts:
                total = bjj.add(total, q)
            cards_wrong += bjj.add(self.table.deck[c][1], bjj.neg(total)) != self.table.cards[c]
        self.judged_cards = sum(len(got) == self.cfg["players"] for got in shares.values())
        print(f"cards_wrong: {self.judged_cards} card(s) with all {self.cfg['players']} shares "
              "unmasked", file=sys.stderr, flush=True)
        checks = {
            "vk_wrong": (vk_wrong, 0),
            "reveals_wrong": (reveals_wrong, 0),
            "cards_wrong": (cards_wrong, 0),
            "proofs_rejected": (sum(not v for v in verdicts), 0),
        }
        return verdicts, checks
