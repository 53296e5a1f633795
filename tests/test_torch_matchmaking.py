"""The port's matchmaking app and generic TurboPLONK shape against the JAX
package, exactly.

At N = 5 players (n = 128, the size tests/test_gadgets.py proves the
matchmaking circuit at), each package builds the circuit with its own
TurboCS and its own Anemoi parameters, indexes it under the generic shape
(`with_shuffle=False`, the embedded vk refused as stale only at N = 50) over
its own `load_srs(128)` (the padding SRS, no Lagrange file at this size;
the port's Lagrange commits on the Pippenger, since the CPU's plain build of
the fixed-base table at n = 128 takes minutes: tests/test_torch_prover.py
holds that route at n = 64).  The port proves it from the seeded
`random.Random` with which the JAX package made the digest `mm5` of
tests/data/torch_golden.json (tests/torch_golden.py mm5; proving it here
again would double the module's time):
  * `build_cs`, the witness and the outputs are equal;
  * every indexer array is equal, `q_prk` (nonzero, the Anemoi round keys)
    and the quotient's coset arrays included, and so is the host part;
  * the proof bytes (1312, generic shape) hash to `mm5`, and both verifiers
    accept them and reject swapped outputs; the port's proof_io reads them
    back, where the JAX package's refuses them (it expects 1248 bytes);
  * a JAX ProverParams carried across by `prover_params_from_jax` proves
    the same bytes;
  * the embedded N = 50 vk is refused as stale by both packages.
The 50-player proof is held against the JAX package's digest `mm50` in
tests/data/torch_golden.json (slow).
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from uzkge_tpu_torch.ff import field as tf

torch.set_num_threads(1)

N = 5
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_golden.json")
SEED = json.load(open(GOLDEN))["mm5"]["seed"]

_ARRAYS = ["q_coefs", "s_coefs", "qb_coefs", "q_prk_coefs", "q_coset", "s_coset", "qb_coset",
           "q_prk_coset", "l1_coset", "z_h_inv_coset", "coset_elems"]


def _request(rng=None):
    from uzkge_tpu_torch.matchmaking.app import seeded_match

    return seeded_match(rng or random.Random(SEED), N)


def _prove(pp, kzg):
    """The port's seeded N = 5 proof, drawn as tests/torch_golden.py draws
    it: the request, then the proof, from one rng."""
    from uzkge_tpu_torch.matchmaking import app as tapp

    rng = random.Random(SEED)
    return tapp.prove_matchmaking(rng, *_request(rng), pp, kzg, N)


@pytest.fixture(scope="module")
def both():
    """The port's params and proof, and the JAX package's params for the same
    circuit (its gen_matchmaking_prover_params, but handed the port's
    verifying key: the JAX package's 19 coefficient-basis commits take ~80
    s on the CPU.  The commitments are held all the same: cm_q and cm_s
    enter the transcript, so the digest `mm5` holds them, and the JAX
    verifier, which reads cm_qb and cm_prk, accepts the proof)."""
    from dataclasses import asdict

    from uzkge_tpu.constants.bn254 import R_MOD
    from uzkge_tpu.gen_params import load_srs as jax_load_srs
    from uzkge_tpu.matchmaking import app as japp
    from uzkge_tpu.plonk.indexer import VerifierParams as JaxVerifierParams
    from uzkge_tpu.plonk.indexer import indexer as jax_indexer
    from uzkge_tpu_torch.matchmaking import app as tapp

    tpp, tcs, tkzg = tapp.gen_matchmaking_prover_params(N, device="cpu", fixed_base=False)
    rng = random.Random(0)
    inputs = [rng.randrange(R_MOD) for _ in range(N)]
    jcs, _ = japp.build_cs(inputs, rng.randrange(R_MOD), rng.randrange(R_MOD), N)
    jkzg = jax_load_srs(jcs.size)
    jvk = JaxVerifierParams(**asdict(tpp.verifier_params))
    jpp = jax_indexer(jcs, jkzg, verifier_params=jvk, with_shuffle=False)
    tproof, tout = _prove(tpp, tkzg)
    return dict(jpp=jpp, jcs=jcs, jkzg=jkzg, tpp=tpp, tcs=tcs, tkzg=tkzg, tproof=tproof,
                tout=tout)


def _bytes(proof):
    from uzkge_tpu_torch.plonk.proof_io import proof_to_bytes_be

    return proof_to_bytes_be(proof, with_shuffle=False)


def test_build_cs_matches_jax():
    from uzkge_tpu.matchmaking import app as japp
    from uzkge_tpu_torch.matchmaking import app as tapp

    inputs, seed, rn = _request()
    jcs, jout = japp.build_cs(inputs, seed, rn, N)
    tcs, tout = tapp.build_cs(inputs, seed, rn, N)
    assert tcs.size == jcs.size == 128
    assert tcs.wiring == jcs.wiring and tcs.selectors == jcs.selectors
    assert tcs.anemoi_constraints_indices == jcs.anemoi_constraints_indices
    assert tcs.boolean_constraint_indices == jcs.boolean_constraint_indices
    assert tcs.public_vars_constraint_indices == jcs.public_vars_constraint_indices
    assert tcs.compute_anemoi_jive_selectors() == jcs.compute_anemoi_jive_selectors()
    witness = tcs.get_and_clear_witness()
    assert witness == jcs.get_and_clear_witness() and tout == jout
    outputs = [witness[v] for v in tout]
    assert sorted(outputs) == sorted(inputs)


@pytest.mark.parametrize("name", _ARRAYS)
def test_indexer_array_matches_jax(both, name):
    got = getattr(both["tpp"], name)
    want = np.asarray(getattr(both["jpp"], name))
    assert got.shape[:-1] == want.shape[:-1]
    assert (tf.to_jax_limbs(got) == want).all()
    if name == "q_prk_coset":
        assert got.abs().sum() > 0  # the Anemoi round keys are loaded


def test_indexer_host_parts_match_jax(both):
    """The host part, and the verifying key's fields that are no
    commitment, worked out from the JAX package's circuit."""
    from uzkge_tpu.ntt.ntt import get_domain
    from uzkge_tpu.plonk.indexer import lagrange_constant
    from uzkge_tpu.utils.chacha import choose_ks

    t, j, jcs = both["tpp"], both["jpp"], both["jcs"]
    assert (t.n, t.m, t.with_shuffle) == (j.n, j.m, j.with_shuffle) == (128, 1024, False)
    assert t.q_ecc_coefs is None and t.q_gen_coefs is None and t.q_pk_coefs is None
    assert t.permutation == j.permutation and t.group == j.group
    assert t.s_evals_host == j.s_evals_host
    vk = t.verifier_params
    assert vk.k == choose_ks(tf.R_MOD, 5) and vk.cs_size == jcs.size
    assert vk.public_vars_constraint_indices == jcs.public_vars_constraint_indices
    omega = get_domain(jcs.size).omega
    assert vk.lagrange_constants == [lagrange_constant(omega, jcs.size, i)
                                     for i in jcs.public_vars_constraint_indices]
    assert (vk.anemoi_generator, vk.anemoi_generator_inv) == \
        (jcs.anemoi_generator, jcs.anemoi_generator_inv)
    assert not vk.with_shuffle and vk.cm_q_ecc is None and not vk.cm_shuffle_generator_vec
    assert len(vk.cm_q_vec) == 9 and len(vk.cm_s_vec) == 5 and len(vk.cm_prk_vec) == 4


def test_proof_bytes_match_jax(both):
    """The digest of the JAX package's proof for the same seeds, and its
    writer's bytes for the port's proof."""
    import hashlib

    from uzkge_tpu.plonk.proof_io import proof_to_bytes_be as jax_proof_to_bytes_be

    tb = _bytes(both["tproof"])
    assert len(tb) == 1312 and tb == jax_proof_to_bytes_be(both["tproof"], with_shuffle=False)
    assert hashlib.sha256(tb).hexdigest() == json.load(open(GOLDEN))["mm5"]["sha256"]
    inputs = _request()[0]
    assert sorted(both["tout"]) == sorted(inputs) and both["tout"] != inputs


def test_generic_proof_bytes_read_back(both):
    """The generic proof is 13 points and 15 scalars: the port reads its
    bytes back, the JAX package's reader (which expects 1248) refuses them."""
    from uzkge_tpu.errors import ProofError as JaxProofError
    from uzkge_tpu.plonk.proof_io import proof_from_bytes_be as jax_proof_from_bytes_be
    from uzkge_tpu_torch.errors import ProofError
    from uzkge_tpu_torch.plonk.proof_io import proof_from_bytes_be

    tb = _bytes(both["tproof"])
    assert proof_from_bytes_be(tb, with_shuffle=False) == both["tproof"]
    with pytest.raises(JaxProofError, match="1248"):
        jax_proof_from_bytes_be(tb, with_shuffle=False)
    with pytest.raises(ProofError, match="1312"):
        proof_from_bytes_be(tb[:1248], with_shuffle=False)


def test_verifiers_accept_and_reject(both):
    from uzkge_tpu.matchmaking import app as japp
    from uzkge_tpu_torch.hash.anemoi import eval_variable_length_hash
    from uzkge_tpu_torch.matchmaking import app as tapp
    from uzkge_tpu_torch.plonk.proof_io import proof_from_bytes_be

    inputs, seed, rn = _request()
    cm = eval_variable_length_hash([seed])
    out = both["tout"]
    vk, kzg = both["tpp"].verifier_params, both["tkzg"]
    proof = proof_from_bytes_be(_bytes(both["tproof"]), with_shuffle=False)
    assert tapp.verify_matchmaking(vk, kzg, inputs, out, cm, rn, proof, N)
    assert japp.verify_matchmaking(both["jpp"].verifier_params, both["jkzg"], inputs, out, cm,
                                   rn, proof, N)
    swapped = [out[1], out[0]] + out[2:]
    assert not tapp.verify_matchmaking(vk, kzg, inputs, swapped, cm, rn, proof, N)


def test_stale_vk_is_refused():
    from uzkge_tpu import gen_params as jgp
    from uzkge_tpu_torch import gen_params as tgp
    from uzkge_tpu_torch.errors import MissingVerifierParamsError
    from uzkge_tpu_torch.plonk.cs import N_SELECTORS

    with pytest.raises(MissingVerifierParamsError, match="stale"):
        tgp.load_matchmaking_verifier_params()
    parsed = tgp._parsed_matchmaking_vk()["vk"]
    assert len(parsed["cm_q_vec"]) == 8 != N_SELECTORS
    jparsed = jgp.ser.parse_verifier_params_specific(
        jgp._read("vk-specific-matchmaking.bin"), with_shuffle=False)["vk"]
    assert parsed == jparsed


def test_prover_params_from_jax_proves_same_bytes(both):
    from uzkge_tpu_torch.matchmaking import app as tapp
    from uzkge_tpu_torch.plonk.indexer import prover_params_from_jax

    pp = prover_params_from_jax(both["jpp"], "cpu")
    assert pp.with_shuffle is False and pp.q_ecc_coefs is None
    for name in _ARRAYS:
        assert torch.equal(getattr(pp, name), getattr(both["tpp"], name)), name
    proof, _ = _prove(pp, both["tkzg"])
    assert _bytes(proof) == _bytes(both["tproof"])


@pytest.mark.slow
def test_50_player_proof_matches_jax_digest():
    """The port's seeded 50-player proof on the CPU against the digest the
    JAX package made for the same seeds (tests/torch_golden.py mm50)."""
    from uzkge_tpu_torch import gen_params as tgp
    from uzkge_tpu_torch.matchmaking import app

    from .torch_golden import matchmaking_digest

    golden = json.load(open(GOLDEN))["mm50"]
    digest, pp = matchmaking_digest(app, 50, golden["seed"], device="cpu")
    assert digest == golden["sha256"]
    # the stale embedded vk's other fields are the re-indexed circuit's
    stale = tgp._parsed_matchmaking_vk()["vk"]
    vk = pp.verifier_params
    assert vk.cm_s_vec == stale["cm_s_vec"] and vk.cm_prk_vec == stale["cm_prk_vec"]
    assert vk.cm_qb == stale["cm_qb"] and vk.k == stale["k"]
    assert vk.lagrange_constants == stale["lagrange_constants"]
    assert vk.public_vars_constraint_indices == stale["public_vars_constraint_indices"]
