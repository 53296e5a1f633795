"""A TurboPLONK verifier for uzkge's proofs, in plain Python integers.

It follows uzkge's src/plonk/verifier.rs, helpers.rs (the linearisation's
scalars, PI(zeta), L1(zeta)), transcript.rs and the KZG batch opening of
poly_commit/kzg_poly_commitment.rs, on the Keccak transcript of
utils/transcript.rs.  A proof is the dict the program returns: affine
points as (x, y) ints, evaluations as ints.  `pairing_inputs` does all of
the verifier's work but the final pairing check and returns its two G1
points, so that many proofs share one multi-pairing (`verify_batch`).
"""

import random
from typing import List

from .bn254 import (G2_GEN, R_MOD as P, fr_root_of_unity, g1_add, g1_msm, g1_mul, g1_neg,
                    multi_pairing_is_one)
from .keccak import keccak256

N_WIRES = 5


class Transcript:
    """uzkge's Keccak transcript: 32-byte slots, a challenge resets the state."""

    def __init__(self, label: bytes):
        self.state = bytearray()
        self.message(label)

    def message(self, msg: bytes):
        if len(msg) < 32:
            self.state += b"\x00" * (32 - len(msg)) + msg
        else:
            if len(msg) % 32:
                raise ValueError("a long transcript message is whole 32-byte slots")
            self.state += msg

    def u64(self, v: int):
        self.message(int(v).to_bytes(8, "big"))

    def byte(self, b: int):
        self.state.append(b)

    def field(self, v: int):
        self.message(int(v).to_bytes(32, "big"))

    def point(self, p):
        x, y = (0, 0) if p is None else p
        self.message(int(x).to_bytes(32, "big") + int(y).to_bytes(32, "big"))

    def challenge(self) -> int:
        c = int.from_bytes(keccak256(bytes(self.state)), "big") % P
        self.state = bytearray(c.to_bytes(32, "big"))
        return c


def _inv(x: int) -> int:
    return pow(x % P, P - 2, P)


def _challenges(t: Transcript, proof: dict, shuffle: bool) -> dict:
    ch = {}
    for cm in proof["cm_w_vec"]:
        t.point(cm)
    if shuffle:
        for cm in proof["cm_w_sel_vec"]:
            t.point(cm)
    ch["beta"] = t.challenge()
    t.byte(0x01)
    ch["gamma"] = t.challenge()
    t.point(proof["cm_z"])
    ch["alpha"] = t.challenge()
    for cm in proof["cm_t_vec"]:
        t.point(cm)
    ch["zeta"] = t.challenge()
    for ev in proof["w_polys_eval_zeta"] + proof["s_polys_eval_zeta"]:
        t.field(ev)
    if shuffle:
        for ev in proof["w_sel_polys_eval_zeta"]:
            t.field(ev)
    t.field(proof["prk_3_poly_eval_zeta"])
    t.field(proof["prk_4_poly_eval_zeta"])
    t.field(proof["z_eval_zeta_omega"])
    if shuffle:
        t.field(proof["q_ecc_poly_eval_zeta"])
    for ev in proof["w_polys_eval_zeta_omega"]:
        t.field(ev)
    ch["u"] = t.challenge()
    return ch


def _alpha_powers(alpha: int, upto: int = 16) -> List[int]:
    out = [1]
    for _ in range(upto):
        out.append(out[-1] * alpha % P)
    return out


def _r_scalars(vk, proof, ch, l1, z_h, n):
    """The linearisation commitment's scalars, in the order of its points:
    [q0..q8, qb, prk1, prk2] (+ [pk x, y, dxy] and [gen x, y, dxy], 4 each,
    with the shuffle), then [s_last, z] and [t0..t4] (helpers.rs:681-999)."""
    beta, gamma, alpha, zeta = ch["beta"], ch["gamma"], ch["alpha"], ch["zeta"]
    ap = _alpha_powers(alpha)
    w = proof["w_polys_eval_zeta"]
    s = proof["s_polys_eval_zeta"]
    k = vk.k
    prod = w[0] * w[1] % P * w[2] % P * w[3] % P * w[4] % P
    sc = [w[0], w[1], w[2], w[3], w[0] * w[1] % P, w[2] * w[3] % P, 1, prod, (P - w[4]) % P]

    beta_zeta = beta * zeta % P
    z_scalar = alpha
    for i in range(N_WIRES):
        z_scalar = z_scalar * ((w[i] + k[i] * beta_zeta + gamma) % P) % P
    z_scalar = (z_scalar + l1 * ap[2]) % P
    s_last = alpha * proof["z_eval_zeta_omega"] % P * beta % P
    for i in range(N_WIRES - 1):
        s_last = s_last * ((w[i] + beta * s[i] + gamma) % P) % P

    qb = (w[1] * (w[1] - 1) % P * ap[3] + w[2] * (w[2] - 1) % P * ap[4]
          + w[3] * (w[3] - 1) % P * ap[5]) % P
    prk3 = proof["prk_3_poly_eval_zeta"]
    sc += [qb, prk3 * ap[6] % P, prk3 * ap[7] % P]

    if vk.with_shuffle:
        ws = proof["w_sel_polys_eval_zeta"]
        wn = proof["w_polys_eval_zeta_omega"]
        qe = proof["q_ecc_poly_eval_zeta"]
        a = vk.edwards_a
        sel = [((1 - ws[0]) * (1 - ws[1]) + qe - 1) % P, ws[0] * (1 - ws[1]) % P,
               (1 - ws[0]) * ws[1] % P, ws[0] * ws[1] % P]
        pk_x, pk_y, pk_dxy, g_x, g_y, g_dxy = ([0] * 4 for _ in range(6))
        for t in range(4):
            pk_dxy[t] = sel[t] * (w[0] * w[1] % P * wn[0] % P * ap[10]
                                  - w[0] * w[1] % P * wn[1] % P * ap[11]) % P
            pk_y[t] = -sel[t] * (ws[2] * w[0] % P * ap[10] + ws[2] * w[1] % P * ap[11]) % P
            pk_x[t] = sel[t] * (-w[1] * ap[10] + a * w[0] % P * ap[11]) % P
            g_dxy[t] = sel[t] * (w[2] * w[3] % P * wn[2] % P * ap[12]
                                 - w[2] * w[3] % P * w[4] % P * ap[13]) % P
            g_y[t] = -sel[t] * (ws[2] * w[2] % P * ap[12] + ws[2] * w[3] % P * ap[13]) % P
            g_x[t] = sel[t] * (-w[3] * ap[12] + a * w[2] % P * ap[13]) % P
        sc += pk_x + pk_y + pk_dxy + g_x + g_y + g_dxy

    sc += [(-s_last) % P, z_scalar]
    factor = pow(zeta, n + 2, P)
    e = z_h
    for _ in range(N_WIRES):
        sc.append((-e) % P)
        e = e * factor % P
    return sc


def _r_eval(vk, proof, ch, pi_zeta, l1) -> int:
    """The linearisation's value at zeta as the verifier sees it
    (helpers.rs:1182-1320)."""
    alpha, beta, gamma = ch["alpha"], ch["beta"], ch["gamma"]
    ap = _alpha_powers(alpha)
    w = proof["w_polys_eval_zeta"]
    s = proof["s_polys_eval_zeta"]
    wn = proof["w_polys_eval_zeta_omega"]
    g, g_inv = vk.anemoi_generator, vk.anemoi_generator_inv

    term1 = alpha * proof["z_eval_zeta_omega"] % P
    for i in range(len(w) - 1):
        term1 = term1 * ((w[i] + beta * s[i] + gamma) % P) % P
    term1 = term1 * ((w[-1] + gamma) % P) % P
    term2 = l1 * ap[2] % P

    w3_w0, w2_w1 = (w[3] + w[0]) % P, (w[2] + w[1]) % P
    w3_2w0, w2_2w1 = (w3_w0 + w[0]) % P, (w2_w1 + w[1]) % P
    prk3, prk4 = proof["prk_3_poly_eval_zeta"], proof["prk_4_poly_eval_zeta"]
    tmp = (w3_w0 + g * w2_w1 + prk3) % P
    term3 = ap[6] * prk3 % P * ((pow((tmp - wn[2]) % P, 5, P) + g * tmp % P * tmp
                                 - (w3_2w0 + g * w2_2w1)) % P) % P
    term5 = ap[8] * prk3 % P * ((pow((tmp - wn[2]) % P, 5, P) + g * wn[2] % P * wn[2]
                                 + g_inv - wn[0]) % P) % P
    g2p1 = (g * g + 1) % P
    tmp2 = (g * w3_w0 + g2p1 * w2_w1 + prk4) % P
    term4 = ap[7] * prk3 % P * ((pow((tmp2 - w[4]) % P, 5, P) + g * tmp2 % P * tmp2
                                 - (g * w3_2w0 + g2p1 * w2_2w1)) % P) % P
    term6 = ap[9] * prk3 % P * ((pow((tmp2 - w[4]) % P, 5, P) + g * w[4] % P * w[4]
                                 + g_inv - wn[1]) % P) % P
    res = (term1 + term2 - pi_zeta + term3 + term4 + term5 + term6) % P

    if vk.with_shuffle:
        ws = proof["w_sel_polys_eval_zeta"]
        qe = proof["q_ecc_poly_eval_zeta"]
        sel_sum = (((1 - ws[0]) * (1 - ws[1]) + qe - 1) + ws[0] * (1 - ws[1])
                   + (1 - ws[0]) * ws[1] + ws[0] * ws[1]) % P
        term7 = ws[2] * ((ap[10] * wn[0] + ap[11] * wn[1] + ap[12] * wn[2] + ap[13] * w[4]) % P) \
            % P * sel_sum % P
        term8 = ap[14] * ((qe * ws[0] % P * (1 - ws[0]) + (1 - qe) * ws[0]) % P) % P
        term9 = ap[15] * ((qe * ws[1] % P * (1 - ws[1]) + (1 - qe) * ws[1]) % P) % P
        term10 = ap[16] * qe % P * (1 - ws[2]) % P * (1 + ws[2]) % P
        res = (res - term7 - term8 - term9 - term10) % P
    return res


def _batch_combine(t: Transcript, cms, max_degree: int, point: int, evals):
    """The verifier's alpha-combination of one opening (pcs.rs:171-191)."""
    t.message(b"New PCS-Batch-Eval Protocol")
    t.message(P.to_bytes(32, "big"))
    t.u64(max_degree)
    t.field(point)
    alpha = t.challenge()
    mults, mult = [], 1
    for _ in cms:
        mults.append(mult)
        mult = mult * alpha % P
    return g1_msm(cms, mults), sum(e * m for e, m in zip(evals, mults)) % P


def pairing_inputs(label: bytes, n_items: int, vk, public_inputs: List[int], proof: dict):
    """The two G1 points (A, B) of the proof's KZG check e(A, [x]_2) *
    e(-B, [1]_2) == 1, after every other step of the verifier.  `label` and
    `n_items` open the transcript as the application does."""
    shuffle = vk.with_shuffle
    n = vk.cs_size
    root = fr_root_of_unity(n)
    if len(public_inputs) != len(vk.public_vars_constraint_indices):
        raise ValueError("public inputs do not match the key")
    t = Transcript(label)
    t.u64(n_items)
    t.message(b"PLONK")
    t.u64(n)
    t.message(P.to_bytes(32, "big"))
    for q in vk.cm_q_vec:
        t.point(q)
    for s in vk.cm_s_vec:
        t.point(s)
    t.field(root)
    for k in vk.k:
        t.field(k)
    for v in public_inputs:
        t.field(v)
    ch = _challenges(t, proof, shuffle)
    zeta = ch["zeta"]

    z_h = (pow(zeta, n, P) - 1) % P
    l1 = z_h * _inv(zeta - 1) % P
    pi = 0
    for v, lc, ci in zip(public_inputs, vk.lagrange_constants, vk.public_vars_constraint_indices):
        pi = (pi + lc * _inv(zeta - pow(root, ci, P)) % P * v) % P
    pi = pi * z_h % P
    r_zeta = _r_eval(vk, proof, ch, pi, l1)

    points = list(vk.cm_q_vec) + [vk.cm_qb, vk.cm_prk_vec[0], vk.cm_prk_vec[1]]
    if shuffle:
        points += list(vk.cm_shuffle_public_key_vec) + list(vk.cm_shuffle_generator_vec)
    points += [vk.cm_s_vec[4], proof["cm_z"]] + list(proof["cm_t_vec"])
    cm_r = g1_msm(points, _r_scalars(vk, proof, ch, l1, z_h, n))

    cms = list(proof["cm_w_vec"]) + list(vk.cm_s_vec[:N_WIRES - 1])
    cms += [vk.cm_prk_vec[2], vk.cm_prk_vec[3]]
    vals = list(proof["w_polys_eval_zeta"]) + list(proof["s_polys_eval_zeta"])
    vals += [proof["prk_3_poly_eval_zeta"], proof["prk_4_poly_eval_zeta"]]
    if shuffle:
        cms += [vk.cm_q_ecc] + list(proof["cm_w_sel_vec"])
        vals += [proof["q_ecc_poly_eval_zeta"]] + list(proof["w_sel_polys_eval_zeta"])
    cms.append(cm_r)
    vals.append(r_zeta)

    zeta_w = zeta * root % P
    wn = proof["w_polys_eval_zeta_omega"]
    c0, v0 = _batch_combine(t, cms, n + 2, zeta, vals)
    c1, v1 = _batch_combine(t, [proof["cm_z"]] + list(proof["cm_w_vec"][:3]), n + 2, zeta_w,
                            [proof["z_eval_zeta_omega"]] + list(wn[:3]))
    u = ch["u"]
    w0, w1 = proof["opening_witness_zeta"], proof["opening_witness_zeta_omega"]
    a = g1_add(w0, g1_mul(w1, u))
    b = g1_msm([w0, w1, c0, c1, vk.g1], [zeta, u * zeta_w % P, 1, u, -(v0 + u * v1) % P])
    return a, b


def verify_batch(items, g2_x, rng: random.Random) -> List[bool]:
    """Judge many proofs: `items` are (A, B) pairs from `pairing_inputs` (or
    None for a proof refused before the pairing).  One multi-pairing checks
    a random combination of all of them; only where it fails is each proof
    checked alone.  Returns one verdict per item."""
    live = [i for i, it in enumerate(items) if it is not None]
    out = [False] * len(items)
    if not live:
        return out
    rhos = [rng.randrange(1, P) for _ in live]
    a = g1_msm([items[i][0] for i in live], rhos)
    b = g1_msm([items[i][1] for i in live], rhos)
    if multi_pairing_is_one([(a, g2_x), (g1_neg(b), G2_GEN)]):
        for i in live:
            out[i] = True
        return out
    for i in live:
        a, b = items[i]
        out[i] = multi_pairing_is_one([(a, g2_x), (g1_neg(b), G2_GEN)])
    return out
