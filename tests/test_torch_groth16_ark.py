"""The port's reference-interoperable Groth16 reveal (groth16/ark_*.py,
reveal.py, sdk.reveal_card_with_snark) against the JAX package's.

Exact comparisons: equal matrices and assignments, equal field values, equal
affine points.

  * synthesize_reveal: the same matrices and assignment;
  * qap_witness_map(device="cpu") (NTTDomain's plain passes) against the JAX
    package's host witness map on the real reveal synthesis, domain 8192;
  * groth16_prove_with_pk(device="cpu") against the JAX package's host
    prover with the same r and s, and its spans (the witness map's
    g16_rows_host and g16_qap_device inside g16_witness_map; g16_msm_bases,
    for the four G1 queries and the G2 one, on the first call only), on a
    stub ArkGroth16Pk that needs no key load: its G1 queries successive
    multiples of G (some identities among them), its G2 query successive
    multiples of the G2 generator, its
    matrices and assignment the 700-product chain's (domain 1024) laid out
    as ark_r1cs.Synth.matrices() lays them out, so that the a, b1, l and h
    MSMs (625, 636, 700 and 1023 points) exceed HOST_MSM_MAX = 512 and
    reach the Pippenger's plain versions, and the G2 MSM (703 query points
    and beta_g2, delta_g2, which the query also holds) runs msm_g2's;
  * without a card the entry points raise rather than fall back;
  * slow (the embedded key's load alone is 36-45 s): prove_reveal_onchain
    for the golden seed, its words' sha256 equal to the JAX package's
    (`reveal`, tests/torch_golden.py), accepted by verify_reveal_onchain and
    rejected with the reveal point changed by one; sdk.reveal_card_with_snark
    verifying;
  * on a card (marker on_cuda): the Pippenger at the reveal's MSM sizes n =
    2823 and 8191, P = 1, against its plain versions and the host Pippenger.
"""

import random

import numpy as np
import pytest
import torch

from uzkge_tpu_torch.constants.bn254 import R_MOD
from uzkge_tpu_torch.curve import babyjubjub as bjj
from uzkge_tpu_torch.curve.bn254 import G1_GEN, G2_GEN, g1_add, g1_mul, g2_add
from uzkge_tpu_torch.groth16 import ark_prove as pa
from uzkge_tpu_torch.groth16.ark_pk import ArkGroth16Pk, ArkGroth16Vk
from uzkge_tpu_torch.groth16.ark_r1cs import synthesize_reveal
from uzkge_tpu_torch.groth16.reveal import seeded_reveal
from uzkge_tpu_torch.utils import stagetimer

from .torch_golden import g16toy_circuit

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def reveal_cs():
    sk, e1 = seeded_reveal(random.Random(11))
    reveal_pt, pk_pt = bjj.mul(e1, sk), bjj.mul(bjj.GENERATOR, sk)
    return (sk, e1, reveal_pt, pk_pt), synthesize_reveal(sk, e1, reveal_pt, pk_pt)


def test_synthesis_matches_jax(reveal_cs):
    from uzkge_tpu.groth16.ark_r1cs import synthesize_reveal as jsynth

    args, cs = reveal_cs
    jcs = jsynth(*args)
    assert (cs.num_instance, cs.num_witness) == (jcs.num_instance, jcs.num_witness) == (7, 4862)
    assert cs.assignment() == jcs.assignment()
    assert cs.matrices() == jcs.matrices()


def test_witness_map_matches_jax_host(reveal_cs):
    from uzkge_tpu.groth16.ark_prove import qap_witness_map as jmap

    _, cs = reveal_cs
    args = (*cs.matrices(), cs.assignment(), cs.num_instance, 8192)
    h = pa.qap_witness_map(*args, device="cpu")
    assert len(h) == 8191 and any(h)
    assert h == jmap(*args)


def _multiples(gen, add, n):
    out = [gen]
    for _ in range(n - 1):
        out.append(add(out[-1], gen))
    return out


def _stub_pk(cls_pk, cls_vk, g1, g2, nv, ni, n):
    """An ArkGroth16Pk of `cls_pk` (either package's) over lists of multiples:
    nv variables, ni instance columns (ONE included), domain n; every 9th
    point of the a and b1 queries the identity."""
    holes = [None if i % 9 == 4 else p for i, p in enumerate(g1[:nv])]
    vk = cls_vk(alpha_g1=g1[1000], beta_g2=g2[0], gamma_g2=g2[1], delta_g2=g2[2],
                gamma_abc_g1=g1[:ni])
    return cls_pk(vk=vk, beta_g1=g1[1001], delta_g1=g1[1002], a_query=holes,
                  b_g1_query=holes[100:] + g1[:100], b_g2_query=g2[:nv],
                  h_query=g1[:n - 1], l_query=g1[300:300 + nv - ni])


def test_prove_with_stub_pk_matches_jax_host():
    from uzkge_tpu.groth16 import ark_pk as jpk
    from uzkge_tpu.groth16.ark_prove import groth16_prove_with_pk as jprove

    cs = g16toy_circuit().canonicalized()
    z, ni, n = cs.assignment, cs.num_instance + 1, 1024
    matrices = tuple([dict(row[k]) for row in cs.constraints] for k in range(3))
    g1 = _multiples(G1_GEN, g1_add, n)
    g2 = _multiples(G2_GEN, g2_add, len(z))
    pk = _stub_pk(ArkGroth16Pk, ArkGroth16Vk, g1, g2, len(z), ni, n)
    want_pk = _stub_pk(jpk.ArkGroth16Pk, jpk.ArkGroth16Vk, g1, g2, len(z), ni, n)
    assert (pk.domain_size, pk.num_instance, pk.num_witness) == (1024, 3, 700)
    sizes = [sum(p is not None for p in q)
             for q in (pk.a_query, pk.b_g1_query, pk.l_query, pk.h_query)]
    assert sizes == [625, 636, 700, 1023]
    rng = random.Random(5)
    r, s = rng.randrange(1, R_MOD), rng.randrange(1, R_MOD)
    got = pa.groth16_prove_with_pk(pk, matrices, z, ni, r, s, device="cpu")
    assert got == jprove(want_pk, matrices, z, ni, r, s)
    assert set(pk._msm_cache) == {(k, "cpu") for k in ("a", "b1", "l", "h")} | {"b2"}


def test_prove_with_stub_pk_spans():
    """A recording of a stub-key proof (the 40-product chain, domain 64):
    the witness map's host sums and device quotient nest inside
    g16_witness_map; the MSM bases are built on the first call only."""
    cs = g16toy_circuit(products=40).canonicalized()
    z, ni, n = cs.assignment, cs.num_instance + 1, 64
    matrices = tuple([dict(row[k]) for row in cs.constraints] for k in range(3))
    pk = _stub_pk(ArkGroth16Pk, ArkGroth16Vk, _multiples(G1_GEN, g1_add, 1003),
                  _multiples(G2_GEN, g2_add, len(z)), len(z), ni, n)
    pk.b_g1_query = pk.a_query[1:] + pk.a_query[:1]  # the stub's is longer than z here
    for first in (True, False):
        with stagetimer.recording() as spans:
            pa.groth16_prove_with_pk(pk, matrices, z, ni, 3, 5, device="cpu")
        (wm,) = [s for s in spans if s[0] == "g16_witness_map"]
        for name in ("g16_rows_host", "g16_qap_device"):
            (inner,) = [s for s in spans if s[0] == name]
            assert wm[1] <= inner[1] <= inner[2] <= wm[2] and inner[4] == wm[4] + 1
        bases = [s for s in spans if s[0] == "g16_msm_bases"]
        assert len(bases) == (5 if first else 0)
        msms = [s for s in spans if s[0].startswith("g16_msm_") and s[0] != "g16_msm_bases"]
        assert all(any(m[1] <= b[1] <= b[2] <= m[2] for m in msms) for b in bases)


def test_entry_points_default_to_the_card():
    """groth16.prove, groth16_prove_with_pk, prove_reveal_onchain and the
    SDK's reveal_card_with_snark run on the card unless asked for the CPU,
    and raise without one (before any work)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is tested on it")
    from uzkge_tpu_torch.groth16.groth16 import prove
    from uzkge_tpu_torch.groth16.reveal import prove_reveal_onchain
    from uzkge_tpu_torch.shuffle import sdk
    from uzkge_tpu_torch.shuffle.primitives import Ciphertext

    e1 = bjj.mul(bjj.GENERATOR, 3)
    card = sdk.masked_card_serialize(Ciphertext(e1, bjj.mul(bjj.GENERATOR, 4)))
    for call in (lambda: prove(None, None),
                 lambda: pa.groth16_prove_with_pk(None, ([], [], []), [1], 1, 1, 1),
                 lambda: prove_reveal_onchain(5, e1),
                 lambda: sdk.reveal_card_with_snark(sdk.scalar_to_hex(5), card)):
        with pytest.raises(RuntimeError, match="CUDA card"):
            call()


@pytest.mark.slow
def test_reveal_onchain_matches_golden_and_verifies():
    import json
    import os

    from uzkge_tpu_torch.groth16 import reveal

    from .torch_golden import reveal_digest

    golden = json.load(open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                                         "torch_golden.json")))["reveal"]
    digest, (sk, e1, reveal_pt, proof) = reveal_digest(reveal, golden["seed"], device="cpu")
    assert digest == golden["sha256"]
    pk_pt = bjj.mul(bjj.GENERATOR, sk)
    assert reveal.verify_reveal_onchain(e1, reveal_pt, pk_pt, proof)
    bad = (reveal_pt[0], (reveal_pt[1] + 1) % R_MOD)
    assert not reveal.verify_reveal_onchain(e1, bad, pk_pt, proof)


@pytest.mark.slow
def test_sdk_reveal_card_with_snark_verifies():
    from uzkge_tpu_torch.groth16.reveal import verify_reveal_onchain
    from uzkge_tpu_torch.shuffle import app, sdk

    rng = random.Random(23)
    kp = app.Keypair.generate(rng)
    joint = app.aggregate_keys([kp.public])
    masked, _ = app.mask(rng, joint, bjj.mul(bjj.GENERATOR, 17), rng.randrange(1, bjj.ORDER))
    out = sdk.reveal_card_with_snark(sdk.scalar_to_hex(kp.secret),
                                     sdk.masked_card_serialize(masked), device="cpu")
    w = [sdk.hex_to_scalar(x) for x in out["snark_proof"]]
    proof = ((w[0], w[1]), ((w[3], w[2]), (w[5], w[4])), (w[6], w[7]))
    reveal_pt = sdk.hex_to_point(out["card"])
    assert reveal_pt == bjj.mul(masked.e1, kp.secret)
    assert verify_reveal_onchain(masked.e1, reveal_pt, kp.public, proof)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")


@pytest.mark.on_cuda
@pytest.mark.parametrize("n", [2823, 8191])
def test_pippenger_at_reveal_sizes(cuda_device, n):
    """The reveal's MSM sizes (a_query 2823 points, h_query 8191), P = 1:
    the accumulate's buckets limb for limb, the reduce as affine window sums,
    and the host Pippenger's point."""
    from uzkge_tpu_torch import kernels
    from uzkge_tpu_torch.ff.field import fr
    from uzkge_tpu_torch.msm import msm as tm

    rs = np.random.default_rng(n)
    base = _multiples(G1_GEN, g1_add, 97)
    points = [g1_mul(base[i % 97], i // 97 + 1) for i in range(n)]
    row = [int.from_bytes(rs.bytes(32), "little") % R_MOD for _ in range(n)]
    row[:3] = [0, 1, R_MOD - 1]
    bases = tm.MSMBases(points, cuda_device)
    std = fr.from_mont(fr.to_mont_limbs(row, cuda_device)[None])
    L = tm.pick_piece(n, 1, cuda_device)
    before = dict(kernels.LAUNCHES)
    kb = tm.msm_bucket_accumulate(bases.x, bases.y, std, L)
    ks = tm.msm_bucket_reduce(kb)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["msm_bucket_accumulate"] == before["msm_bucket_accumulate"] + 1
    assert kernels.LAUNCHES["msm_bucket_reduce"] == before["msm_bucket_reduce"] + 1
    assert torch.equal(kb, tm.msm_bucket_accumulate_plain(bases.x, bases.y, std, L))
    want = tm._window_sums_to_points(tm.msm_bucket_reduce_plain(kb).cpu())
    assert tm._window_sums_to_points(ks.cpu()) == want
    assert want == [pa.g1_msm_host(points, row)]
