"""The on-chain reveal cell (`reveal_g16.onchain`): its entries in
BENCHMARK.json, the Pippenger's bounds against the port's digits and
`chip_smoke.py`'s bounds, its metric readers on synthetic runs, and its
judgement with faults planted.

On the CPU the faults go through `Session.judge` with one reveal proved once
through the SDK (the key's load ~40 s, the proof ~40 s): the masked card's
e1 handed back as the reveal point, one proof word moved by one, two
answers' reveal points exchanged after proving, one point of the program's
verifier key replaced.  Each reads 1 or more in its own check.  On a card
(`-m on_cuda`) the whole cell runs through `run.run_cell` on three seeds,
clean and with each fault planted through `wrap_session`.
"""

import copy
import json
import os
import random
import sys

import pytest
import torch

from .conftest import ROOT

sys.path.insert(0, ROOT)

from zkbench import run  # noqa: E402
from zkbench.apps import reveal as app  # noqa: E402
from zkbench.metrics import (g16_msm_g1_s, g16_msm_g2_s, g16_synth_s,  # noqa: E402
                             g16_witness_map_s, msm_roofline)
from zkbench.reference import babyjubjub as bjj  # noqa: E402
from zkbench.reference.bn254 import G1_GEN, R_MOD  # noqa: E402
from zkbench.traffic import Traffic  # noqa: E402
from zkbench.yardstick import msm_bounds  # noqa: E402

CELL, CONFIG = "reveal_g16.onchain", "reveal_g16"
METRICS = ["g16_synth_s", "g16_witness_map_s", "g16_msm_g1_s", "g16_msm_g2_s", "msm_roofline"]
SEEDS = (2**31 + 11, 7_000_001, 90_210)


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_entries_are_appended_and_follow_the_manifest(bench):
    cfg_entry, cell = bench["configs"][-1], bench["workloads"][-1]
    assert cfg_entry["name"] == CONFIG and cfg_entry["reduced"] == []
    assert cell == {**cell, "name": CELL, "config": CONFIG, "traffic": "onchain", "chips": 1}
    assert [m["name"] for m in bench["per_layer"][-5:]] == METRICS
    for m in bench["per_layer"][-5:]:
        assert m["moves"] == "proof_latency_s" and m["workloads"] == [CELL]
    assert all(CELL not in m.get("workloads", []) for m in bench["per_layer"][:-5])
    _, _, config, spec = run.load_cell(ROOT, CELL)
    assert config["app"] == "reveal" and config["pk_file"] == "groth16_pk.bin"
    assert (config["domain"], config["num_instance"], config["num_witness"]) == (8192, 7, 4862)
    assert set(config["assumed"]) == {"players", "n_cards"} and config["reduced"] == []
    assert spec["warmup"] == 1 and spec["next_input"] == "fresh"
    assert [m["name"] for m in run.cell_metrics(bench, cell, True)] == METRICS
    assert {m["name"] for m in run.cell_metrics(bench, cell, False)} == {
        "setup_s", "proof_latency_s", "peak_device_gb"}


def test_nonzero_digits_are_the_ports():
    from uzkge_tpu_torch.ff.field import fr
    from uzkge_tpu_torch.msm import msm as M

    rng = random.Random(3)
    for row in ([rng.randrange(R_MOD) for _ in range(300)] + [R_MOD - 1, R_MOD, R_MOD + 5],
                [rng.randrange(2) for _ in range(300)], [0] * 10, [1 << 200, 255, 256]):
        std = fr.from_mont(fr.to_mont_limbs(row, "cpu").reshape(1, len(row), 8))
        assert msm_bounds.nonzero_digits(row) == int((M._digits(std) != 0).sum())


@pytest.mark.parametrize("n", [2823, 8191])
def test_bounds_are_chip_smokes(n):
    import chip_smoke
    from uzkge_tpu_torch.ff.field import fr

    imul_rate = 132 * 64 * 1980e6
    rate = imul_rate / 264
    row = [random.Random(n).randrange(R_MOD) for _ in range(n)]
    std = fr.from_mont(fr.to_mont_limbs(row, "cpu").reshape(1, n, 8))
    nz = msm_bounds.nonzero_digits(row)
    acc, red = chip_smoke.acc_bound(std, n, imul_rate), chip_smoke.reduce_bound(1, 1, imul_rate)
    assert msm_bounds.accumulate_s(1, n, nz, rate) * 1e3 == pytest.approx(acc["bound_ms"], rel=1e-12)
    assert msm_bounds.reduce_s(1, 1, rate) * 1e3 == pytest.approx(red["bound_ms"], rel=1e-12)
    assert msm_bounds.msm_s(1, n, nz, rate) == pytest.approx(
        (acc["bound_ms"] + red["bound_ms"]) / 1e3, rel=1e-12)


def test_span_readers():
    r = run.Run({}, None)
    for reader in (g16_synth_s, g16_witness_map_s, g16_msm_g1_s, g16_msm_g2_s):
        assert reader.read(r) is None
    r.stages = [{"g16_synthesize": 1.0, "g16_witness_map": 0.2, "g16_msm_a": 0.01,
                 "g16_msm_b1": 0.02, "g16_msm_l": 0.03, "g16_msm_h": 0.04, "g16_msm_b2_host": 6.0},
                {"g16_synthesize": 3.0, "g16_witness_map": 0.4, "g16_msm_a": 0.03,
                 "g16_msm_b1": 0.02, "g16_msm_l": 0.01, "g16_msm_h": 0.04, "g16_msm_b2_host": 5.0}]
    assert g16_synth_s.read(r) == 2.0 and g16_msm_g2_s.read(r) == 5.5
    assert g16_witness_map_s.read(r) == pytest.approx(0.3)
    assert g16_msm_g1_s.read(r) == pytest.approx(0.1)
    r.stages = [{"r0_build_cs": 1.0}]  # a cell of another app
    assert all(m.read(r) is None for m in (g16_synth_s, g16_witness_map_s, g16_msm_g1_s,
                                           g16_msm_g2_s))


def test_msm_roofline_reads_the_windows_calls(capsys):
    rate = 132 * 64 * 1980e6 / 264
    rows = [[random.Random(i).randrange(R_MOD) for _ in range(n)] for i, n in enumerate((600, 900))]
    served = [{"calls": [(1, 600, [5] * 600, False)], "reduce_launches": 1},  # the warm-up
              {"calls": [(1, 600, rows[0], False), (1, 900, rows[1], False)],
               "reduce_launches": 2}]
    events = [(1.0, 1.5, "(anonymous namespace)::msm_bucket_accumulate_piece_kernel(int)"),
              (2.0, 2.25, "msm_bucket_reduce_kernel(unsigned int const*)"),
              (3.0, 3.5, "ntt_pass_kernel")]
    r = run.Run({app.OBSERVED: served}, rate)
    r.stages = [{"g16_msm_a": 1.0}]
    assert msm_roofline.read(r) is None  # no trace
    r.trace = run.Trace(events, 0.0, 10.0, [], [], [])
    want = sum(msm_bounds.msm_s(1, len(x), msm_bounds.nonzero_digits(x), rate) for x in rows)
    assert msm_roofline.read(r) == pytest.approx(100.0 * want / 0.75)
    served[1]["reduce_launches"] = 3
    assert msm_roofline.read(r) is None
    assert "2 calls observed but 3" in capsys.readouterr().err
    served[1]["reduce_launches"] = 2
    served[1]["calls"][0] = (1, 600, rows[0], True)
    assert msm_roofline.read(r) is None
    assert "host Pippenger" in capsys.readouterr().err
    r.config = {}  # a run whose prover was never observed
    assert msm_roofline.read(r) is None


# ----------------------------------------------------------------- faults

def _alter(kind, served, session):
    """A copy of `served` (and of the session's verifier key) with the fault
    `kind` planted."""
    served = copy.deepcopy(served)
    (req, ans) = served[0]
    if kind == "e1_as_reveal":
        e1 = session.table.deck[req["card"]][0]
        ans["card"] = app.word(e1[0]) + app.word(e1[1])[2:]
    elif kind == "word_moved":
        ans["snark_proof"][6] = app.word(int(ans["snark_proof"][6], 16) + 1)
    elif kind == "reveals_exchanged":
        a, b = served[0][1], served[1][1]
        a["card"], b["card"] = b["card"], a["card"]
    elif kind == "vk_replaced":
        session.vk = copy.deepcopy(session.vk)
        session.vk.gamma_abc_g1[3] = G1_GEN
    return served


CHECK_OF = {"e1_as_reveal": "reveals_wrong", "word_moved": "proofs_rejected",
            "reveals_exchanged": "reveals_wrong", "vk_replaced": "vk_wrong"}


class Faulty:
    """The cell's session with a fault planted in what it hands the judge."""

    def __init__(self, session, kind):
        self._s, self._kind = session, kind

    def __getattr__(self, name):
        return getattr(self._s, name)

    def judge(self, served):
        return self._s.judge(_alter(self._kind, served, self._s))


@pytest.fixture(scope="module")
def proved():
    """A CPU session of the cell and one reveal (request 0) served through
    the SDK; request 1 answered with a second reveal point (player 1's
    share of the same card, correct) on request 0's proof words."""
    bench_cell = run.load_cell(ROOT, CELL)
    config, spec = bench_cell[2], bench_cell[3]
    session = app.Session(config, Traffic(spec, SEEDS[0]), torch.device("cpu"), ROOT)
    session.setup()
    req0, req1 = session.request(0), session.request(1)
    assert (req0["card"], req1["card"], req0["player"], req1["player"]) == (0, 0, 0, 1)
    ans0 = session.serve(req0)
    share = bjj.mul(session.table.deck[0][0], session.table.secrets[1])
    ans1 = {"card": app.word(share[0]) + app.word(share[1])[2:],
            "snark_proof": list(ans0["snark_proof"])}
    return session, [(req0, ans0), (req1, ans1)]


def test_one_reveal_judged_correct(proved):
    session, served = proved
    verdicts, checks = session.judge(served[:1])
    assert verdicts == [True]
    assert {k: v for k, (v, _) in checks.items()} == {
        "vk_wrong": 0, "reveals_wrong": 0, "cards_wrong": 0, "proofs_rejected": 0}
    (observed,) = session.observed
    assert len(observed["calls"]) == 4 and observed["reduce_launches"] == 0  # CPU: no launch
    # the second answer's share is right, its proof is another's
    verdicts, checks = session.judge(served)
    assert verdicts == [True, False] and checks["reveals_wrong"][0] == 0


@pytest.mark.parametrize("kind", sorted(CHECK_OF))
def test_faults_read_in_their_check(proved, kind):
    session, served = proved
    faulty = Faulty(copy.copy(session), kind)
    n = 2 if kind == "reveals_exchanged" else 1
    _, checks = faulty.judge(served[:n])
    assert checks[CHECK_OF[kind]][0] >= 1


def test_malformed_answers_count_as_rejected(proved):
    session, served = proved
    req, ans = served[0]
    bad = [None, {}, {"card": 5, "snark_proof": "x"}, {**ans, "snark_proof": ans["snark_proof"][:7]},
           {**ans, "card": ans["card"][:-1] + "g"}]
    verdicts, checks = session.judge([(req, a) for a in bad])
    assert verdicts == [False] * len(bad)
    assert checks["proofs_rejected"][0] == len(bad)


def test_cards_are_unmasked_from_all_four_shares(proved):
    session, _ = proved
    reqs = [session.request(i) for i in range(4)]
    card = session.table.deck[0]
    shares = [bjj.mul(card[0], s) for s in session.table.secrets]
    answers = [{"card": app.word(p[0]) + app.word(p[1])[2:], "snark_proof": []} for p in shares]
    _, checks = session.judge(list(zip(reqs, answers)))
    assert checks["cards_wrong"][0] == 0 and session.judged_cards == 1
    answers[2]["card"] = answers[1]["card"]
    _, checks = session.judge(list(zip(reqs, answers)))
    assert checks["cards_wrong"][0] == 1


CARD_CASES = [("clean", seed) for seed in SEEDS] + [(kind, SEEDS[0]) for kind in sorted(CHECK_OF)]


@pytest.mark.on_cuda
@pytest.mark.parametrize("kind,seed", CARD_CASES)
def test_cell_judges_faults_on_the_card(cuda_device, kind, seed):
    run.environment()
    wrap = None if kind == "clean" else (lambda s: Faulty(s, kind))
    result, checks = run.run_cell(CELL, seed, 0.0, False, cuda_device, wrap_session=wrap)
    print(json.dumps({"cell": CELL, "seed": seed, "fault": kind, "correct": result["correct"],
                      "checks": result["checks"]}))
    assert result["attempted"] == 1
    assert result["correct"] is (kind == "clean")
    if kind != "clean":
        assert checks[CHECK_OF[kind]][0] >= 1
