"""The torch port's prover slice against the JAX package, exactly.

On the add-gate circuit proven under the shuffle protocol shape
(tests/test_plonk_e2e.py:49-60, n = 64, KZG.setup_insecure), built by each
package with its own TurboCS:
  * the port's indexer against the JAX one, array by array;
  * `prover` on both packages with random.Random(99): byte-identical
    proof_io bytes, accepted by both verifiers; the port proves with its
    Lagrange commits on the variable-base Pippenger (`fixed_base=False`)
    and again through the fixed-base table (`fixed_base=True`), both equal
    to the JAX package's bytes;
  * KZG's commit route: `_fb_enabled` as in the JAX package, and the
    `fixed_base` argument that overrides it.
The 20-card shuffle proof is held against the JAX package's digest in
tests/data/torch_golden.json, made under UZKGE_FB=0 (slow).
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from uzkge_tpu.plonk.proof_io import proof_to_bytes_be as jax_proof_to_bytes_be
from uzkge_tpu.utils.transcript import Transcript as JaxTranscript
from uzkge_tpu_torch.constants.bn254 import R_MOD
from uzkge_tpu_torch.ff import field as tf
from uzkge_tpu_torch.plonk.proof_io import proof_to_bytes_be
from uzkge_tpu_torch.utils.transcript import Transcript

torch.set_num_threads(1)

TAU = 987654321987654321
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_golden.json")


def _add_gate_circuit(TurboCS):
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
    """The same circuit (each package's own TurboCS), SRS and rng through
    both packages.  The port commits in the Lagrange basis through its
    variable-base MSM (`fixed_base=False`); the JAX package, given the
    same SRS without Lagrange bases, commits in the coefficient basis with
    its host Pippenger.  A polynomial has one commitment whatever the basis,
    so equal proof bytes hold both commit paths to each other."""
    import uzkge_tpu.plonk.gadgets  # noqa: F401  (attaches gadget methods)
    import uzkge_tpu_torch.plonk.gadgets  # noqa: F401
    from uzkge_tpu.pcs.kzg import KZG as JaxKZG
    from uzkge_tpu.plonk.cs import TurboCS as JaxTurboCS
    from uzkge_tpu.plonk.indexer import indexer as jax_indexer
    from uzkge_tpu.plonk.prover import prover as jax_prover
    from uzkge_tpu_torch.pcs.kzg import KZG
    from uzkge_tpu_torch.plonk.cs import TurboCS
    from uzkge_tpu_torch.plonk.indexer import indexer
    from uzkge_tpu_torch.plonk.prover import prover

    jcs, jwitness = _add_gate_circuit(JaxTurboCS)
    cs, witness = _add_gate_circuit(TurboCS)
    assert witness == jwitness
    n = cs.size
    tkzg = KZG.setup_insecure(2 * n + 10, tau=TAU, domain_n=n, device="cpu", fixed_base=False)
    jkzg = JaxKZG(tkzg.g1_powers, tkzg.g2_powers)
    jpp = jax_indexer(jcs, jkzg, with_shuffle=True)
    jproof = jax_prover(random.Random(99), JaxTranscript(b"Test"), jkzg, jcs, jpp, jwitness)
    tpp = indexer(cs, tkzg, with_shuffle=True)
    tproof = prover(random.Random(99), Transcript(b"Test"), tkzg, cs, tpp, witness)
    return dict(cs=cs, witness=witness, jkzg=jkzg, jpp=jpp, jproof=jproof,
                tkzg=tkzg, tpp=tpp, tproof=tproof)


def test_setup_insecure_matches_jax(both):
    from uzkge_tpu.pcs.kzg import KZG as JaxKZG
    from uzkge_tpu_torch.pcs.kzg import KZG

    j = JaxKZG.setup_insecure(9, tau=TAU, domain_n=4)
    k = KZG.setup_insecure(9, tau=TAU, domain_n=4, device="cpu")
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
    """Also holds the golden digest "add64" (tests/data/torch_golden.json),
    against which tests/test_torch_sharded.py checks the group-routed proof,
    to the JAX package's bytes."""
    import hashlib

    tb = proof_to_bytes_be(both["tproof"])
    jb = jax_proof_to_bytes_be(both["jproof"])
    assert len(tb) == len(jb) and tb == jb
    assert hashlib.sha256(jb).hexdigest() == json.load(open(GOLDEN))["add64"]["sha256"]


def test_fixed_base_proof_bytes_match_jax(both):
    """The same proof with every Lagrange commit through the fixed-base table
    (n = 64, c = 8, on the CPU's plain versions), over the fixture's SRS."""
    from uzkge_tpu_torch.pcs.kzg import KZG
    from uzkge_tpu_torch.plonk.cs import TurboCS
    from uzkge_tpu_torch.plonk.indexer import indexer
    from uzkge_tpu_torch.plonk.prover import prover

    t = both["tkzg"]
    kzg = KZG(t.g1_powers, t.g2_powers, t._lagrange_points, device="cpu", fixed_base=True)
    cs, witness = _add_gate_circuit(TurboCS)
    pp = indexer(cs, kzg, with_shuffle=True)
    proof = prover(random.Random(99), Transcript(b"Test"), kzg, cs, pp, witness)
    assert kzg._lagrange_fb is not None and kzg._lagrange_vb is None
    assert (kzg.lagrange_fb_table().n, kzg.lagrange_fb_table().c) == (64, 8)
    assert proof_to_bytes_be(proof) == jax_proof_to_bytes_be(both["jproof"])


def test_blinding_one_native_call_a_blinded_commit(both, monkeypatch):
    """A proof calls the native `g1_blind` once for every
    `apply_blind_factors` call with a nonzero blind, and the proof's bytes
    stay the JAX package's."""
    from uzkge_tpu_torch import kernels
    from uzkge_tpu_torch.pcs.kzg import KZG
    from uzkge_tpu_torch.plonk.prover import prover

    blinded = []
    apply = KZG.apply_blind_factors

    def counted(self, cm, blinds, zeroing_degree):
        blinded.append(any(b % R_MOD for b in blinds))
        return apply(self, cm, blinds, zeroing_degree)

    monkeypatch.setattr(KZG, "apply_blind_factors", counted)
    before = kernels.CALLS.get("g1_blind", 0)
    proof = prover(random.Random(99), Transcript(b"Test"), both["tkzg"], both["cs"],
                   both["tpp"], both["witness"])
    assert sum(blinded) >= 16
    assert kernels.CALLS["g1_blind"] - before == sum(blinded)
    assert proof_to_bytes_be(proof) == jax_proof_to_bytes_be(both["jproof"])


def test_kzg_route_follows_fb_enabled(both, monkeypatch):
    """With no `fixed_base`, KZG routes Lagrange commits as the JAX package's
    _fb_enabled does with UZKGE_FB unset: on the CPU through the table up to
    n = 512, on the accelerator always; `fixed_base` overrides the rule."""
    from uzkge_tpu.ff import pallas_field
    from uzkge_tpu.pcs.kzg import _fb_enabled as jax_fb_enabled
    from uzkge_tpu_torch.pcs.kzg import KZG, _fb_enabled

    monkeypatch.delenv("UZKGE_FB", raising=False)
    g = both["tkzg"].g1_powers[:1]
    for n in (4, 512, 1024, 16384):
        lag = g * n
        assert KZG(g, [], lag, device="cpu").uses_fixed_base() == jax_fb_enabled(n) == (n <= 512)
        assert KZG(g, [], lag, device="cpu", fixed_base=True).uses_fixed_base()
        assert not KZG(g, [], lag, device="cpu", fixed_base=False).uses_fixed_base()
        assert _fb_enabled(n, torch.device("cuda"))
    monkeypatch.setattr(pallas_field, "use_pallas", lambda: True)
    assert jax_fb_enabled(16384)
    tkzg = both["tkzg"]
    assert not tkzg.uses_fixed_base() and tkzg._lagrange_fb is None
    assert tkzg._lagrange_vb is not None


def test_verifiers_accept_and_reject(both):
    from uzkge_tpu.plonk.verifier import verifier as jax_verifier
    from uzkge_tpu_torch.plonk.verifier import verifier

    cs, w = both["cs"], both["witness"]
    online = [w[i] for i in cs.public_vars_witness_indices]
    vk = both["tpp"].verifier_params
    assert verifier(Transcript(b"Test"), both["tkzg"], vk, online, both["tproof"])
    assert jax_verifier(JaxTranscript(b"Test"), both["jkzg"], both["jpp"].verifier_params,
                        online, both["tproof"])
    bad = [(online[0] + 1) % R_MOD] + online[1:]
    assert not verifier(Transcript(b"Test"), both["tkzg"], vk, bad, both["tproof"])


def test_prover_params_from_jax(both):
    from uzkge_tpu_torch.plonk.indexer import prover_params_from_jax

    pp = prover_params_from_jax(both["jpp"], "cpu")
    for name in _ARRAYS:
        assert torch.equal(getattr(pp, name), getattr(both["tpp"], name)), name
    assert pp.verifier_params == both["tpp"].verifier_params
    assert pp.permutation == both["tpp"].permutation


def test_stagetimer_records_prover_stages(both):
    from uzkge_tpu_torch.utils import stagetimer

    snap = stagetimer.snapshot()
    for name in ("r1_commit", "r3_t_kernel", "r5_openings", "kzg_msm", "kzg_blind",
                 "kzg_open_prepare"):
        assert name in snap and snap[name] >= 0


def test_gen_params_match_jax():
    from uzkge_tpu import gen_params as jgp
    from dataclasses import asdict
    from uzkge_tpu_torch import gen_params as tgp

    assert asdict(tgp.load_shuffle_verifier_params(52)) == \
        asdict(jgp.load_shuffle_verifier_params(52))
    t, j = tgp.load_srs(4096, "cpu"), jgp.load_srs(4096)
    assert t.g1_powers == j.g1_powers and t.g2_powers == j.g2_powers
    assert t.lagrange_n == j.lagrange_n == 4096
    assert tgp.load_srs(4096, "cpu") is t and t.fixed_base is None
    vb = tgp.load_srs(4096, "cpu", fixed_base=False)  # the route is part of the cache key
    assert vb is not t and vb.fixed_base is False and not vb.uses_fixed_base()


def test_build_cs_matches_jax():
    from uzkge_tpu.shuffle import app as japp
    from uzkge_tpu_torch.shuffle import app as tapp

    from uzkge_tpu.shuffle.primitives import Ciphertext as JaxCiphertext

    joint, deck = tapp.seeded_game(random.Random(5), 1)
    jdeck = [JaxCiphertext(c.e1, c.e2) for c in deck]
    tcs, tout = tapp.build_cs(random.Random(6), joint, deck)
    jcs, jout = japp.build_cs(random.Random(6), joint, jdeck)
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
    assert proof_digest(app, refresh_prover_params_public_key, 20, golden["seed"],
                        device="cpu") == golden["sha256"]
