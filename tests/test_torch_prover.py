"""The torch port's prover slice against the JAX package, exactly.

On the add-gate circuit proven under the shuffle protocol shape
(tests/test_plonk_e2e.py:49-60, n = 64, KZG.setup_insecure):
  * the port's indexer against the JAX one, array by array;
  * `prover` on both packages with random.Random(99): byte-identical
    proof_io bytes, accepted by both verifiers.
The 20-card shuffle proof is held against the JAX package's digest in
tests/data/torch_golden.json, made under UZKGE_FB=0 (slow).
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from uzkge_tpu.constants.bn254 import R_MOD
from uzkge_tpu.plonk.cs import TurboCS
from uzkge_tpu.plonk.proof_io import proof_to_bytes_be
from uzkge_tpu.utils.transcript import Transcript
from uzkge_tpu_torch.ff import field as tf

torch.set_num_threads(1)

TAU = 987654321987654321
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_golden.json")


def _add_gate_circuit():
    import uzkge_tpu.plonk.gadgets  # noqa: F401  (attaches gadget methods)

    cs = TurboCS()
    v1 = cs.new_variable(1)
    v2 = cs.new_variable(2)
    v3 = cs.new_variable(3)
    cs.insert_add_gate(v1, v2, v3)
    cs.prepare_pi_variable(v3)
    cs.pad(min_size=64)
    return cs, cs.get_and_clear_witness()


@pytest.fixture(scope="module")
def both():
    """The same circuit, SRS and rng through both packages.  The port commits
    in the Lagrange basis through its device MSM; the JAX package, given the
    same SRS without Lagrange bases, commits in the coefficient basis with
    its host Pippenger.  A polynomial has one commitment whatever the basis,
    so equal proof bytes hold both commit paths to each other."""
    from uzkge_tpu.pcs.kzg import KZG as JaxKZG
    from uzkge_tpu.plonk.indexer import indexer as jax_indexer
    from uzkge_tpu.plonk.prover import prover as jax_prover
    from uzkge_tpu_torch.pcs.kzg import KZG
    from uzkge_tpu_torch.plonk.indexer import indexer
    from uzkge_tpu_torch.plonk.prover import prover

    cs, witness = _add_gate_circuit()
    n = cs.size
    tkzg = KZG.setup_insecure(2 * n + 10, tau=TAU, domain_n=n)
    jkzg = JaxKZG(tkzg.g1_powers, tkzg.g2_powers)
    jpp = jax_indexer(cs, jkzg, with_shuffle=True)
    jproof = jax_prover(random.Random(99), Transcript(b"Test"), jkzg, cs, jpp, witness)
    tpp = indexer(cs, tkzg, with_shuffle=True)
    tproof = prover(random.Random(99), Transcript(b"Test"), tkzg, cs, tpp, witness)
    return dict(cs=cs, witness=witness, jkzg=jkzg, jpp=jpp, jproof=jproof,
                tkzg=tkzg, tpp=tpp, tproof=tproof)


def test_setup_insecure_matches_jax(both):
    from uzkge_tpu.pcs.kzg import KZG as JaxKZG
    from uzkge_tpu_torch.pcs.kzg import KZG

    j = JaxKZG.setup_insecure(9, tau=TAU, domain_n=4)
    k = KZG.setup_insecure(9, tau=TAU, domain_n=4)
    assert k.g1_powers == j.g1_powers and k.g2_powers == j.g2_powers
    assert k._lagrange_points == j._lagrange_points
    assert k.lagrange_n == 4 and k.max_contig == 10
    assert both["tkzg"].g1_powers[:10] == j.g1_powers


_ARRAYS = ["q_coefs", "s_coefs", "qb_coefs", "q_prk_coefs", "q_coset", "s_coset", "qb_coset",
           "q_prk_coset", "l1_coset", "z_h_inv_coset", "coset_elems", "q_ecc_coefs",
           "q_gen_coefs", "q_pk_coefs", "q_ecc_coset", "q_gen_coset", "q_pk_coset"]


@pytest.mark.parametrize("name", _ARRAYS)
def test_indexer_array_matches_jax(both, name):
    got = getattr(both["tpp"], name)
    want = np.asarray(getattr(both["jpp"], name))
    assert got.shape[:-1] == want.shape[:-1]
    assert (tf.to_jax_limbs(got) == want).all()


def test_indexer_host_parts_match_jax(both):
    from dataclasses import asdict

    t, j = both["tpp"], both["jpp"]
    assert (t.n, t.m, t.with_shuffle) == (j.n, j.m, j.with_shuffle)
    assert t.permutation == j.permutation and t.group == j.group
    assert t.s_evals_host == j.s_evals_host
    assert asdict(t.verifier_params) == asdict(j.verifier_params)


def test_proof_bytes_match_jax(both):
    tb = proof_to_bytes_be(both["tproof"])
    jb = proof_to_bytes_be(both["jproof"])
    assert len(tb) == len(jb) and tb == jb


def test_verifiers_accept_and_reject(both):
    from uzkge_tpu.plonk.verifier import verifier as jax_verifier
    from uzkge_tpu_torch.plonk.verifier import verifier

    cs, w = both["cs"], both["witness"]
    online = [w[i] for i in cs.public_vars_witness_indices]
    vk = both["tpp"].verifier_params
    assert verifier(Transcript(b"Test"), both["tkzg"], vk, online, both["tproof"])
    assert jax_verifier(Transcript(b"Test"), both["jkzg"], both["jpp"].verifier_params,
                        online, both["tproof"])
    bad = [(online[0] + 1) % R_MOD] + online[1:]
    assert not verifier(Transcript(b"Test"), both["tkzg"], vk, bad, both["tproof"])


def test_prover_params_from_jax(both):
    from uzkge_tpu_torch.plonk.indexer import prover_params_from_jax

    pp = prover_params_from_jax(both["jpp"])
    for name in _ARRAYS:
        assert torch.equal(getattr(pp, name), getattr(both["tpp"], name)), name
    assert pp.verifier_params == both["tpp"].verifier_params
    assert pp.permutation == both["tpp"].permutation


def test_stagetimer_records_prover_stages(both):
    from uzkge_tpu_torch.utils import stagetimer

    snap = stagetimer.snapshot()
    for name in ("r1_commit", "r3_t_kernel", "r5_openings"):
        assert name in snap and snap[name] >= 0


def test_gen_params_match_jax():
    from uzkge_tpu import gen_params as jgp
    from dataclasses import asdict
    from uzkge_tpu_torch import gen_params as tgp

    assert asdict(tgp.load_shuffle_verifier_params(52)) == \
        asdict(jgp.load_shuffle_verifier_params(52))
    t, j = tgp.load_srs(4096), jgp.load_srs(4096)
    assert t.g1_powers == j.g1_powers and t.g2_powers == j.g2_powers
    assert t.lagrange_n == j.lagrange_n == 4096


def test_build_cs_matches_jax():
    from uzkge_tpu.shuffle import app as japp
    from uzkge_tpu_torch.shuffle import app as tapp

    joint, deck = tapp.seeded_game(random.Random(5), 1)
    tcs, tout = tapp.build_cs(random.Random(6), joint, deck)
    jcs, jout = japp.build_cs(random.Random(6), joint, deck)
    assert tcs.size == jcs.size
    assert tcs.get_and_clear_witness() == jcs.get_and_clear_witness()
    assert [o.as_list() for o in tout] == [o.as_list() for o in jout]


@pytest.mark.slow
def test_20_card_proof_matches_jax_digest():
    """The port's seeded 20-card shuffle proof on the CPU against the digest
    the JAX package made for the same seeds (tests/torch_golden.py)."""
    from uzkge_tpu_torch.plonk.indexer import refresh_prover_params_public_key
    from uzkge_tpu_torch.shuffle import app

    from .torch_golden import proof_digest

    golden = json.load(open(GOLDEN))["20"]
    assert proof_digest(app, refresh_prover_params_public_key, 20, golden["seed"]) == \
        golden["sha256"]
