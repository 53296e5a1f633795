"""Fixtures of the benchmark's own tests (run them with
`python -m pytest zkbench/tests -q`; those marked on_cuda need a card)."""

import json
import os
import shutil
from types import SimpleNamespace

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def copy_checkout(dst: str) -> str:
    """BENCHMARK.json and zkbench/ copied into `dst`, the program and the
    published parameters linked: a checkout whose benchmark files a test
    may add to."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(ROOT, "zkbench"), os.path.join(dst, "zkbench"),
                    ignore=shutil.ignore_patterns("cache", "__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "uzkge_tpu_torch"), os.path.join(dst, "uzkge_tpu_torch"))
    os.makedirs(os.path.join(dst, "uzkge_tpu"))
    os.symlink(os.path.join(ROOT, "uzkge_tpu", "parameters"),
               os.path.join(dst, "uzkge_tpu", "parameters"))
    return dst


def add_small_lobby_cell(root: str) -> str:
    """A 5-player matchmaking cell (n = 128, Pippenger on the CPU) in the
    checkout at `root`; returns its name.  No key is published at that
    size: a run of it takes `own_key` as its session's wrapper."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(root, "zkbench", "configs", "mm50.json")) as f:
        cfg = json.load(f)
    cfg.update(name="mm5", players=5, n=128, m=1024, fixed_base=False)
    with open(os.path.join(root, "zkbench", "configs", "mm5.json"), "w") as f:
        json.dump(cfg, f)
    shutil.copy(os.path.join(root, "zkbench", "workloads", "mm50.lobbies.json"),
                os.path.join(root, "zkbench", "workloads", "mm5.lobbies.json"))
    bench["configs"].append({"name": "mm5", "source": "test", "file": "zkbench/configs/mm5.json",
                             "reduced": ["players"], "why": "test"})
    bench["workloads"].append({"name": "mm5.lobbies", "config": "mm5", "traffic": "lobbies",
                               "chips": 1, "why": "test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return "mm5.lobbies"


def own_key(session):
    """The small lobby cell's session with the program's own key standing
    in for the published one, which does not exist at its size: the faults
    it is run with alter the answers, not the key."""
    from zkbench.apps.matchmaking import KEY_FIELDS

    def key(g1):
        prog = session.vk
        return SimpleNamespace(with_shuffle=False, g1=g1, edwards_a=0,
                               **{f: getattr(prog, f) for f in KEY_FIELDS})

    session.published_key = key
    return session
