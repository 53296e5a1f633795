"""Prover/verifier shared helpers: linearization scalars, PI evaluation,
first-Lagrange evaluation.

The r polynomial/commitment share one scalar computation (reference
`r_poly_or_comm`, helpers.rs:681-999): the prover applies the scalars to
polynomial rows on device, the verifier to commitment points on host.
Contributor order here is the canonical one used by both.
"""

from typing import List, Optional

from ..constants.bn254 import R_MOD as P
from .cs import TurboCS


def alpha_powers(alpha: int, upto: int) -> List[int]:
    out = [1]
    for _ in range(upto):
        out.append(out[-1] * alpha % P)
    return out


def first_lagrange_eval(zeta: int, n: int):
    """(Z_H(zeta), L1(zeta)) (helpers.rs:1412-1423)."""
    zeta_n = pow(zeta, n, P)
    z_h = (zeta_n - 1) % P
    l1 = z_h * pow((zeta - 1) % P, P - 2, P) % P
    return z_h, l1


def eval_pi(verifier_params, public_inputs: List[int], z_h_eval_zeta: int, zeta: int, root: int) -> int:
    """PI(zeta) via Lagrange constants (helpers.rs:1135-1165)."""
    acc = 0
    for pi_val, lconst, cidx in zip(
        public_inputs, verifier_params.lagrange_constants, verifier_params.public_vars_constraint_indices
    ):
        denom = (zeta - pow(root, cidx, P)) % P
        li = lconst * pow(denom, P - 2, P) % P
        acc = (acc + li * pi_val) % P
    return acc * z_h_eval_zeta % P


def r_scalars(
    vk,
    w_evals_zeta: List[int],
    s_evals_zeta: List[int],
    q_prk3_eval_zeta: int,
    z_eval_zeta_omega: int,
    challenges: dict,
    first_lagrange_eval_zeta: int,
    z_h_eval_zeta: int,
    n_t_polys: int,
    n_t_chunks: int,
    w_sel_evals_zeta: Optional[List[int]] = None,
    q_ecc_eval_zeta: Optional[int] = None,
    w_evals_zeta_omega: Optional[List[int]] = None,
):
    """Scalars for every contributor to the linearization commitment/poly, in
    canonical order:
        [q0..q8, qb, prk1, prk2] + ([pk x4,y4,dxy4] + [gen x4,y4,dxy4] if
        shuffle) + [s_last, z] + [t0..t4]
    Mirrors r_poly_or_comm (helpers.rs:681-999)."""
    beta, gamma, alpha, zeta = (challenges[k] for k in ("beta", "gamma", "alpha", "zeta"))
    ap = alpha_powers(alpha, 16)
    w = w_evals_zeta
    k = vk.k

    sel_mults = TurboCS.eval_selector_multipliers(w)  # 9 scalars

    # z scalar (helpers.rs:1004-1027)
    beta_zeta = beta * zeta % P
    z_scalar = alpha
    for i in range(5):
        z_scalar = z_scalar * ((w[i] + k[i] * beta_zeta + gamma) % P) % P
    z_scalar = (z_scalar + first_lagrange_eval_zeta * ap[2]) % P

    # s_last scalar (negated contributor)
    s_last = alpha * z_eval_zeta_omega % P * beta % P
    for i in range(4):
        s_last = s_last * ((w[i] + beta * s_evals_zeta[i] + gamma) % P) % P
    s_last_scalar = (-s_last) % P

    qb_scalar = (
        w[1] * (w[1] - 1) % P * ap[3] + w[2] * (w[2] - 1) % P * ap[4] + w[3] * (w[3] - 1) % P * ap[5]
    ) % P
    prk1_scalar = q_prk3_eval_zeta * ap[6] % P
    prk2_scalar = q_prk3_eval_zeta * ap[7] % P

    scalars = list(sel_mults) + [qb_scalar, prk1_scalar, prk2_scalar]

    if vk.with_shuffle:
        ws = w_sel_evals_zeta
        wn = w_evals_zeta_omega
        a = vk.edwards_a
        sel = [
            ((1 - ws[0]) * (1 - ws[1]) + q_ecc_eval_zeta - 1) % P,
            ws[0] * (1 - ws[1]) % P,
            (1 - ws[0]) * ws[1] % P,
            ws[0] * ws[1] % P,
        ]
        pk_x = [0] * 4
        pk_y = [0] * 4
        pk_dxy = [0] * 4
        g_x = [0] * 4
        g_y = [0] * 4
        g_dxy = [0] * 4
        for t in range(4):
            # alpha^10 / alpha^11 terms (public key selectors)
            pk_dxy[t] = (
                sel[t] * (w[0] * w[1] % P * wn[0] % P * ap[10] - w[0] * w[1] % P * wn[1] % P * ap[11])
            ) % P
            pk_y[t] = (-sel[t] * (ws[2] * w[0] % P * ap[10] + ws[2] * w[1] % P * ap[11])) % P
            pk_x[t] = (sel[t] * (-w[1] * ap[10] + a * w[0] % P * ap[11])) % P
            # alpha^12 / alpha^13 terms (generator selectors)
            g_dxy[t] = (
                sel[t] * (w[2] * w[3] % P * wn[2] % P * ap[12] - w[2] * w[3] % P * w[4] % P * ap[13])
            ) % P
            g_y[t] = (-sel[t] * (ws[2] * w[2] % P * ap[12] + ws[2] * w[3] % P * ap[13])) % P
            g_x[t] = (sel[t] * (-w[3] * ap[12] + a * w[2] % P * ap[13])) % P
        scalars += pk_x + pk_y + pk_dxy + g_x + g_y + g_dxy

    scalars += [s_last_scalar, z_scalar]

    # t chunks: -Z_H(zeta) * zeta^{n_t_polys * i}
    factor = pow(zeta, n_t_polys, P)
    exp = z_h_eval_zeta % P
    for i in range(n_t_chunks):
        scalars.append((-exp) % P)
        exp = exp * factor % P
    return scalars


def r_eval_zeta(vk, proof: dict, challenges: dict, pi_eval_zeta: int,
                first_lagrange_eval_zeta: int) -> int:
    """Verifier-side linearization scalar (helpers.rs:1182-1320)."""
    alpha = challenges["alpha"]
    beta, gamma = challenges["beta"], challenges["gamma"]
    ap = alpha_powers(alpha, 16)
    w = proof["w_polys_eval_zeta"]
    s = proof["s_polys_eval_zeta"]
    wn = proof["w_polys_eval_zeta_omega"]
    g = vk.anemoi_generator
    g_inv = vk.anemoi_generator_inv

    term1 = alpha * proof["z_eval_zeta_omega"] % P
    for i in range(len(w) - 1):
        term1 = term1 * ((w[i] + beta * s[i] + gamma) % P) % P
    term1 = term1 * ((w[-1] + gamma) % P) % P
    term2 = first_lagrange_eval_zeta * ap[2] % P

    w3_w0 = (w[3] + w[0]) % P
    w2_w1 = (w[2] + w[1]) % P
    w3_2w0 = (w3_w0 + w[0]) % P
    w2_2w1 = (w2_w1 + w[1]) % P
    prk3 = proof["prk_3_poly_eval_zeta"]
    prk4 = proof["prk_4_poly_eval_zeta"]

    tmp = (w3_w0 + g * w2_w1 + prk3) % P
    term3 = ap[6] * prk3 % P * (
        (pow((tmp - wn[2]) % P, 5, P) + g * tmp % P * tmp - (w3_2w0 + g * w2_2w1)) % P
    ) % P
    term5 = ap[8] * prk3 % P * (
        (pow((tmp - wn[2]) % P, 5, P) + g * wn[2] % P * wn[2] + g_inv - wn[0]) % P
    ) % P

    g2p1 = (g * g + 1) % P
    tmp2 = (g * w3_w0 + g2p1 * w2_w1 + prk4) % P
    term4 = ap[7] * prk3 % P * (
        (pow((tmp2 - w[4]) % P, 5, P) + g * tmp2 % P * tmp2 - (g * w3_2w0 + g2p1 * w2_2w1)) % P
    ) % P
    term6 = ap[9] * prk3 % P * (
        (pow((tmp2 - w[4]) % P, 5, P) + g * w[4] % P * w[4] + g_inv - wn[1]) % P
    ) % P

    res = (term1 + term2 - pi_eval_zeta + term3 + term4 + term5 + term6) % P

    if vk.with_shuffle:
        ws = proof["w_sel_polys_eval_zeta"]
        qe = proof["q_ecc_poly_eval_zeta"]
        sel_sum = (
            ((1 - ws[0]) * (1 - ws[1]) + qe - 1)
            + ws[0] * (1 - ws[1])
            + (1 - ws[0]) * ws[1]
            + ws[0] * ws[1]
        ) % P
        term7 = ws[2] * (
            (ap[10] * wn[0] + ap[11] * wn[1] + ap[12] * wn[2] + ap[13] * w[4]) % P
        ) % P * sel_sum % P
        term8 = ap[14] * ((qe * ws[0] % P * (1 - ws[0]) + (1 - qe) * ws[0]) % P) % P
        term9 = ap[15] * ((qe * ws[1] % P * (1 - ws[1]) + (1 - qe) * ws[1]) % P) % P
        term10 = ap[16] * qe % P * (1 - ws[2]) % P * (1 + ws[2]) % P
        res = (res - term7 - term8 - term9 - term10) % P
    return res
