"""The judgement of a run holds when the timed path is broken underneath.

Each fault wraps the app's session and breaks its answers where they are
produced; the rest of the run (set-up, warm-up, window, the reference's
judgement) is the harness's own, without its look for a card.  The faults
that a cell of one client on one card can have: its state returned
unchanged (the input deck or the ids handed back as the answer), an answer
altered (one evaluation of the proof moved by one), and the control, which
breaks the guarantee that the answer is the one proved (two cards of the
output deck or two matched players exchanged after proving).  Besides, on
the card, each remaining number gets the fault it is there to catch: a
card of the output deck duplicated (a deck that is no permutation), one of
the refreshed key's commitments replaced, one commitment of the
re-indexed key replaced.  No cell has a batch to halve or an exchange
between cards to drop.

On the CPU the 5-player lobby cell runs the first four (~3.5 min); on a
card (`-m on_cuda`) both cells of BENCHMARK.json at their own size, on
three seeds each.
"""

import copy
import json
import sys

import pytest
import torch

from .conftest import ROOT, add_small_lobby_cell, copy_checkout, own_key

sys.path.insert(0, ROOT)

from zkbench import run  # noqa: E402

SEEDS = (2**31 + 11, 7_000_001, 90_210)


def _alter(kind, req, ans):
    ans = copy.deepcopy(ans)
    if kind == "state_unchanged":
        if "deck" in ans:
            ans["deck"] = list(req["deck"])
        else:
            ans["outputs"] = list(req["ids"])
    elif kind == "answer_altered":
        ev = list(ans["proof"]["w_polys_eval_zeta"])
        ev[0] = (ev[0] + 1) % run.R_MOD
        ans["proof"]["w_polys_eval_zeta"] = ev
    elif kind == "control_exchanged":
        key = "deck" if "deck" in ans else "outputs"
        out = list(ans[key])
        out[0], out[1] = out[1], out[0]
        ans[key] = out
    elif kind == "card_duplicated":
        ans["deck"] = [ans["deck"][1]] + list(ans["deck"][1:])
    return ans


class Faulty:
    def __init__(self, session, kind):
        self._s, self._kind = session, kind

    def __getattr__(self, name):
        return getattr(self._s, name)

    def setup(self):
        self._s.setup()
        if self._kind == "refresh_altered":
            cms = self._s.refresh_cms
            self._s.refresh_cms = [cms[1]] + list(cms[1:])
        elif self._kind == "key_altered":
            vk = self._s.vk
            vk.cm_q_vec = [vk.cm_q_vec[1]] + list(vk.cm_q_vec[1:])

    def serve(self, req):
        return _alter(self._kind, req, self._s.serve(req))


def _drive(root, cell, seed, kind, device, own=None):
    """One run whose window holds one request (0 s: the first starts at
    once, no second); `own` wraps the session first."""
    def wrap(s):
        s = own(s) if own else s
        return s if kind == "clean" else Faulty(s, kind)

    result, checks = run.run_cell(cell, seed, 0.0, False, device, root=root, wrap_session=wrap)
    print(json.dumps({"cell": cell, "seed": seed, "fault": kind, "correct": result["correct"],
                      "attempted": result["attempted"], "failed": result["failed"],
                      "checks": result["checks"]}))
    return result


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    root = copy_checkout(str(tmp_path_factory.mktemp("checkout")))
    return root, add_small_lobby_cell(root)


@pytest.mark.parametrize("kind", ["clean", "state_unchanged", "answer_altered", "control_exchanged"])
def test_small_lobby_cell_judges_faults(small_root, kind, monkeypatch):
    root, cell = small_root
    monkeypatch.setenv("UZKGE_PARAMS_CACHE", f"{root}/zkbench/cache/params")
    result = _drive(root, cell, SEEDS[0], kind, torch.device("cpu"), own=own_key)
    assert result["attempted"] == 1
    assert result["correct"] is (kind == "clean")
    assert result["failed"] == (0 if kind == "clean" else 1)


ANSWER_FAULTS = ["state_unchanged", "answer_altered", "control_exchanged"]
CARD_CASES = [(cell, kind) for cell, extra in (
    ("shuffle52.turns", ["card_duplicated", "refresh_altered"]),
    ("mm50.lobbies", ["key_altered"])) for kind in ["clean"] + ANSWER_FAULTS + extra]


@pytest.mark.on_cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell,kind", CARD_CASES)
def test_cells_judge_faults_on_the_card(cuda_device, cell, kind, seed):
    run.environment()
    result = _drive(ROOT, cell, seed, kind, cuda_device)
    assert result["attempted"] == 1
    assert result["correct"] is (kind == "clean")
    # the prover's transcript opens with the key's selector commitments, so
    # a changed re-indexed key also fails the proofs; the refreshed
    # public-key commitments do not enter it
    assert result["failed"] == (0 if kind in ("clean", "refresh_altered") else 1)
