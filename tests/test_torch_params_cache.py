"""The port's params cache: its own format (numpy limbs and JSON, no pickle),
a round trip that proves the same bytes, and its keys.

  * an n = 64 ProverParams (the add-gate circuit of tests/test_torch_prover.py,
    its KZG and rng) saved and loaded back has equal tensors, host part and
    verifying key, under the shuffle shape and the generic one; the loaded
    shuffle-shape params prove the bytes of the fresh ones, which are the
    JAX package's (the digest "add64" of tests/data/torch_golden.json);
  * the shuffle key hashes the full joint-key point: `apk` and `-apk` (same
    y) key different files; the matchmaking key is by n;
  * another schema version misses, by name and by content; a missing or
    broken file misses.
"""

import hashlib
import json
import os
import random
from dataclasses import fields

import pytest
import torch

from uzkge_tpu_torch.curve import babyjubjub as bjj
from uzkge_tpu_torch.plonk.indexer import ProverParams
from uzkge_tpu_torch.plonk.proof_io import proof_to_bytes_be
from uzkge_tpu_torch.utils import params_cache as pc
from uzkge_tpu_torch.utils.transcript import Transcript

torch.set_num_threads(1)

TAU = 987654321987654321
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_golden.json")


@pytest.fixture(scope="module")
def setup():
    import uzkge_tpu_torch.plonk.gadgets  # noqa: F401
    from uzkge_tpu_torch.pcs.kzg import KZG
    from uzkge_tpu_torch.plonk.cs import TurboCS
    from uzkge_tpu_torch.plonk.indexer import indexer

    def circuit():
        cs = TurboCS()
        v1, v2, v3 = cs.new_variable(1), cs.new_variable(2), cs.new_variable(3)
        cs.insert_add_gate(v1, v2, v3)
        cs.prepare_pi_variable(v3)
        cs.pad(min_size=64)
        return cs, cs.get_and_clear_witness()

    cs, witness = circuit()
    kzg = KZG.setup_insecure(2 * cs.size + 10, tau=TAU, domain_n=cs.size, device="cpu",
                             fixed_base=False)
    pps = {shape: indexer(cs, kzg, with_shuffle=shape) for shape in (True, False)}
    return dict(cs=cs, witness=witness, kzg=kzg, pps=pps)


def _prove(setup, pp):
    from uzkge_tpu_torch.plonk.prover import prover

    proof = prover(random.Random(99), Transcript(b"Test"), setup["kzg"], setup["cs"], pp,
                   setup["witness"])
    return proof_to_bytes_be(proof, with_shuffle=pp.with_shuffle)


@pytest.mark.parametrize("with_shuffle", [True, False])
def test_round_trip_proves_same_bytes(setup, tmp_path, with_shuffle):
    pp = setup["pps"][with_shuffle]
    path = str(tmp_path / "pp")
    pc.save_pp(path, pp)
    with open(path + ".json") as fh:
        assert json.load(fh)["schema"] == pc.SCHEMA_VERSION
    got = pc.load_pp(path, ProverParams, device="cpu")
    assert got is not None
    for f in fields(ProverParams):
        a, b = getattr(got, f.name), getattr(pp, f.name)
        if isinstance(b, torch.Tensor):
            assert a.device.type == "cpu" and a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    if with_shuffle:
        digest = hashlib.sha256(_prove(setup, got)).hexdigest()
        assert digest == json.load(open(GOLDEN))["add64"]["sha256"]


def test_keys(monkeypatch, tmp_path):
    monkeypatch.setenv("UZKGE_PARAMS_CACHE", str(tmp_path))
    apk = bjj.mul(bjj.GENERATOR, 12345)
    neg = bjj.neg(apk)
    assert neg[1] == apk[1] and neg != apk
    a, b = pc.shuffle_pp_cache_path(52, apk), pc.shuffle_pp_cache_path(52, neg)
    assert a != b and a.startswith(str(tmp_path))
    assert pc.shuffle_pp_cache_path(52, apk) == a != pc.shuffle_pp_cache_path(48, apk)
    assert pc.matchmaking_pp_cache_path(50) != pc.matchmaking_pp_cache_path(5)
    monkeypatch.setattr(pc, "SCHEMA_VERSION", "torch-v0")
    assert pc.shuffle_pp_cache_path(52, apk) != a


def test_other_schema_or_broken_file_misses(setup, tmp_path, monkeypatch):
    path = str(tmp_path / "pp")
    assert pc.load_pp(path, ProverParams, device="cpu") is None
    pc.save_pp(path, setup["pps"][False])
    monkeypatch.setattr(pc, "SCHEMA_VERSION", "torch-v0")
    assert pc.load_pp(path, ProverParams, device="cpu") is None
    monkeypatch.undo()
    assert pc.load_pp(path, ProverParams, device="cpu") is not None
    with open(path + ".npz", "r+b") as fh:
        fh.truncate(100)
    assert pc.load_pp(path, ProverParams, device="cpu") is None
    with open(path + ".json", "w") as fh:
        fh.write("{")
    assert pc.load_pp(path, ProverParams, device="cpu") is None
