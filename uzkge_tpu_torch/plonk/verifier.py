"""TurboPLONK verifier on the host: a handful of group operations and one
multi-pairing.

A copy of `uzkge_tpu/plonk/verifier.py` (reference verifier.rs:17-222) that
takes `transcript_init_plonk` from this package's prover, so that verifying
pulls in no JAX.
"""

from typing import List

from uzkge_tpu.constants.bn254 import R_MOD as P
from uzkge_tpu.curve.bn254 import g1_add, g1_mul
from uzkge_tpu.ff.field import Fr
from uzkge_tpu.plonk.cs import N_WIRES_PER_GATE
from uzkge_tpu.plonk.helpers import eval_pi, first_lagrange_eval, r_eval_zeta, r_scalars
from uzkge_tpu.utils.transcript import Transcript

from .prover import transcript_init_plonk


def compute_challenges(transcript: Transcript, proof: dict, with_shuffle: bool) -> dict:
    """(verifier.rs:166-222)"""
    challenges = {}
    for cm in proof["cm_w_vec"]:
        transcript.append_commitment(cm)
    if with_shuffle:
        for cm in proof["cm_w_sel_vec"]:
            transcript.append_commitment(cm)
    challenges["beta"] = transcript.get_challenge(P)
    transcript.append_single_byte(0x01)
    challenges["gamma"] = transcript.get_challenge(P)
    transcript.append_commitment(proof["cm_z"])
    challenges["alpha"] = transcript.get_challenge(P)
    for cm in proof["cm_t_vec"]:
        transcript.append_commitment(cm)
    challenges["zeta"] = transcript.get_challenge(P)
    for ev in proof["w_polys_eval_zeta"] + proof["s_polys_eval_zeta"]:
        transcript.append_field_elem(ev)
    if with_shuffle:
        for ev in proof["w_sel_polys_eval_zeta"]:
            transcript.append_field_elem(ev)
    transcript.append_field_elem(proof["prk_3_poly_eval_zeta"])
    transcript.append_field_elem(proof["prk_4_poly_eval_zeta"])
    transcript.append_field_elem(proof["z_eval_zeta_omega"])
    if with_shuffle:
        transcript.append_field_elem(proof["q_ecc_poly_eval_zeta"])
    for ev in proof["w_polys_eval_zeta_omega"]:
        transcript.append_field_elem(ev)
    challenges["u"] = transcript.get_challenge(P)
    return challenges


def verifier(transcript: Transcript, kzg, vk, public_inputs: List[int], proof: dict) -> bool:
    with_shuffle = vk.with_shuffle
    n = vk.cs_size
    root = Fr.root_of_unity(n)

    transcript_init_plonk(transcript, vk, public_inputs, root)
    challenges = compute_challenges(transcript, proof, with_shuffle)
    zeta = challenges["zeta"]

    z_h_eval_zeta, l1_eval_zeta = first_lagrange_eval(zeta, n)
    pi_eval_zeta = eval_pi(vk, public_inputs, z_h_eval_zeta, zeta, root)
    r_zeta = r_eval_zeta(vk, proof, challenges, pi_eval_zeta, l1_eval_zeta)

    # linearization commitment from the shared scalar computation
    scalars = r_scalars(
        vk,
        proof["w_polys_eval_zeta"],
        proof["s_polys_eval_zeta"],
        proof["prk_3_poly_eval_zeta"],
        proof["z_eval_zeta_omega"],
        challenges,
        l1_eval_zeta,
        z_h_eval_zeta,
        n + 2,
        N_WIRES_PER_GATE,
        w_sel_evals_zeta=proof.get("w_sel_polys_eval_zeta"),
        q_ecc_eval_zeta=proof.get("q_ecc_poly_eval_zeta"),
        w_evals_zeta_omega=proof.get("w_polys_eval_zeta_omega"),
    )
    points = list(vk.cm_q_vec) + [vk.cm_qb, vk.cm_prk_vec[0], vk.cm_prk_vec[1]]
    if with_shuffle:
        points += list(vk.cm_shuffle_public_key_vec) + list(vk.cm_shuffle_generator_vec)
    points += [vk.cm_s_vec[4], proof["cm_z"]]
    points += list(proof["cm_t_vec"])
    cm_r = None
    for sc, pt in zip(scalars, points):
        if sc % P == 0 or pt is None:
            continue
        cm_r = g1_add(cm_r, g1_mul(pt, sc))

    # batched opening checks
    commitments = list(proof["cm_w_vec"]) + vk.cm_s_vec[: N_WIRES_PER_GATE - 1]
    commitments.append(vk.cm_prk_vec[2])
    commitments.append(vk.cm_prk_vec[3])
    if with_shuffle:
        commitments.append(vk.cm_q_ecc)
        commitments += list(proof["cm_w_sel_vec"])
    commitments.append(cm_r)

    values = list(proof["w_polys_eval_zeta"]) + list(proof["s_polys_eval_zeta"])
    values.append(proof["prk_3_poly_eval_zeta"])
    values.append(proof["prk_4_poly_eval_zeta"])
    if with_shuffle:
        values.append(proof["q_ecc_poly_eval_zeta"])
        values += list(proof["w_sel_polys_eval_zeta"])
    values.append(r_zeta)

    zeta_omega = zeta * root % P
    comm, val = kzg.batch_combine(transcript, commitments, n + 2, zeta, values)
    comm_omega, val_omega = kzg.batch_combine(
        transcript,
        [proof["cm_z"], proof["cm_w_vec"][0], proof["cm_w_vec"][1], proof["cm_w_vec"][2]],
        n + 2,
        zeta_omega,
        [
            proof["z_eval_zeta_omega"],
            proof["w_polys_eval_zeta_omega"][0],
            proof["w_polys_eval_zeta_omega"][1],
            proof["w_polys_eval_zeta_omega"][2],
        ],
    )
    return kzg.batch_verify_diff_points(
        [comm, comm_omega],
        [zeta, zeta_omega],
        [val, val_omega],
        [proof["opening_witness_zeta"], proof["opening_witness_zeta_omega"]],
        challenges["u"],
    )
