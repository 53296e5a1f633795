"""Gadget library for TurboCS: Anemoi hash, twisted-Edwards ECC, and the
shuffle permutation/remark gadgets.

Gate ordering and wiring must reproduce the reference's circuit layout
byte-exactly (the verifier key commits to selector polynomials):
  - Anemoi:   plonk/constraint_system/anemoi/mod.rs
  - ECC:      plonk/constraint_system/ecc/{mod,const_base_ecc,nonconst_base_ecc}.rs
  - shuffle:  plonk/constraint_system/shuffle/{mod,remark,permutation}.rs

Methods are attached to TurboCS at import (mirroring the reference's
`impl TurboCS` blocks split across modules).
"""

from typing import List, NamedTuple, Optional

from ..constants.bn254 import R_MOD as P, EDWARDS_A, EDWARDS_D
from ..constants.anemoi_constants import N_ANEMOI_ROUNDS, MDS_MATRIX
from ..curve import babyjubjub as bjj
from ..shuffle.primitives import Ciphertext, RemarkTrace, Permutation, N_WIRE_SELECTORS
from .cs import TurboCS

# --------------------------------------------------------------------- anemoi


def anemoi_permutation_round(cs, input_var, output_var, intermediate_val, checksum=None, salt=None):
    """One 14-gate Anemoi permutation chunk (anemoi/mod.rs:10-196).
    input_var: ([a0, b0], [c0, d0]) variable indices;
    output_var: ([ox0, ox1], [oy0, oy1]) of Optional[int];
    intermediate_val: (inter_x[14][2], inter_y[14][2]) field values."""
    zero_var = cs.zero_var()
    inter_x_val, inter_y_val = intermediate_val

    ivar_x = [[zero_var] * 2 for _ in range(N_ANEMOI_ROUNDS)]
    ivar_y = [[zero_var] * 2 for _ in range(N_ANEMOI_ROUNDS)]
    for r in range(N_ANEMOI_ROUNDS):
        ivar_x[r][0] = cs.new_variable(inter_x_val[r][0])
        ivar_x[r][1] = cs.new_variable(inter_x_val[r][1])
        ivar_y[r][0] = cs.new_variable(inter_y_val[r][0])
        ivar_y[r][1] = cs.new_variable(inter_y_val[r][1])

    # first gate (holds the input state; output wire = d_1)
    if salt is not None:
        cs.push_add_selectors(0, 0, 0, 1)
        cs.push_constant_selector((-salt) % P)
    else:
        cs.push_add_selectors(0, 0, 0, 0)
        cs.push_constant_selector(0)
    cs.push_mul_selectors(0, 0)
    cs.push_ecc_selector(0)
    cs.push_out_selector(0)
    cs.wiring[0].append(input_var[0][0])
    cs.wiring[1].append(input_var[0][1])
    cs.wiring[2].append(input_var[1][0])
    cs.wiring[3].append(input_var[1][1])
    cs.wiring[4].append(ivar_y[0][1])
    cs.finish_new_gate()
    cs.attach_anemoi_jive_constraints_to_gate()

    # remaining 13 round gates
    for r in range(1, N_ANEMOI_ROUNDS):
        cs.push_add_selectors(0, 0, 0, 0)
        cs.push_mul_selectors(0, 0)
        cs.push_constant_selector(0)
        cs.push_ecc_selector(0)
        cs.push_out_selector(0)
        cs.wiring[0].append(ivar_x[r - 1][0])
        cs.wiring[1].append(ivar_x[r - 1][1])
        cs.wiring[2].append(ivar_y[r - 1][0])
        cs.wiring[3].append(ivar_y[r - 1][1])
        cs.wiring[4].append(ivar_y[r][1])
        cs.finish_new_gate()

    m = MDS_MATRIX
    last = N_ANEMOI_ROUNDS - 1

    def final_gate(q1, q2, q3, q4, qc, var):
        cs.push_add_selectors(q1, q2, q3, q4)
        cs.push_mul_selectors(0, 0)
        cs.push_constant_selector(qc)
        cs.push_ecc_selector(0)
        cs.push_out_selector(1)
        cs.wiring[0].append(ivar_x[last][0])
        cs.wiring[1].append(ivar_x[last][1])
        cs.wiring[2].append(ivar_y[last][0])
        cs.wiring[3].append(ivar_y[last][1])
        cs.wiring[4].append(var)
        cs.finish_new_gate()

    # final linear layer output gates: x rows use doubled MDS rows
    if output_var[0][0] is not None:
        final_gate(2 * m[0][0], 2 * m[0][1], m[0][1], m[0][0], 0, output_var[0][0])
    if output_var[0][1] is not None:
        final_gate(2 * m[1][0], 2 * m[1][1], m[1][1], m[1][0], 0, output_var[0][1])
    if output_var[1][0] is not None:
        final_gate(m[0][0], m[0][1], m[0][1], m[0][0], 0, output_var[1][0])
    if output_var[1][1] is not None:
        final_gate(m[1][0], m[1][1], m[1][1], m[1][0], 0, output_var[1][1])

    if checksum is not None:
        var = cs.new_variable(checksum)
        s0 = (m[0][0] + m[1][0]) % P
        s1 = (m[0][1] + m[1][1]) % P
        final_gate(3 * s0, 3 * s1, 2 * s1, 2 * s0, 0, var)
        return var
    return None


def anemoi_variable_length_hash(cs, trace, input_var, output_var):
    """(anemoi/mod.rs:199-313)"""
    assert len(input_var) == len(trace.input)
    input_var = list(input_var)
    one_var, zero_var = cs.one_var(), cs.zero_var()

    if len(input_var) % 3 != 0 or not input_var:
        input_var.append(one_var)
        if len(input_var) % 3 != 0:
            input_var.extend([zero_var] * (3 - len(input_var) % 3))
    assert len(input_var) == len(trace.before_permutation) * 3

    chunks = [input_var[i : i + 3] for i in range(0, len(input_var), 3)]
    num_chunks = len(chunks)
    x_var = [chunks[0][0], chunks[0][1]]
    y_var = [chunks[0][2], zero_var]

    if num_chunks == 1:
        anemoi_permutation_round(
            cs, (x_var, y_var), ([output_var, None], [None, None]),
            trace.intermediate_values[0],
        )
        return

    new_x = [cs.new_variable(trace.after_permutation[0][0][i]) for i in range(2)]
    new_y = [cs.new_variable(trace.after_permutation[0][1][i]) for i in range(2)]
    anemoi_permutation_round(
        cs, (x_var, y_var),
        ([new_x[0], new_x[1]], [new_y[0], new_y[1]]),
        trace.intermediate_values[0],
    )
    for rr in range(1, num_chunks - 1):
        x_var, y_var = new_x, new_y
        x_var = [cs.add(x_var[0], chunks[rr][0]), cs.add(x_var[1], chunks[rr][1])]
        y_var = [cs.add(y_var[0], chunks[rr][2]), y_var[1]]
        new_x = [cs.new_variable(trace.after_permutation[rr][0][i]) for i in range(2)]
        new_y = [cs.new_variable(trace.after_permutation[rr][1][i]) for i in range(2)]
        anemoi_permutation_round(
            cs, (x_var, y_var),
            ([new_x[0], new_x[1]], [new_y[0], new_y[1]]),
            trace.intermediate_values[rr],
        )
    x_var, y_var = new_x, new_y
    x_var = [cs.add(x_var[0], chunks[-1][0]), cs.add(x_var[1], chunks[-1][1])]
    y_var = [cs.add(y_var[0], chunks[-1][2]), y_var[1]]
    anemoi_permutation_round(
        cs, (x_var, y_var), ([output_var, None], [None, None]),
        trace.intermediate_values[num_chunks - 1],
    )


def anemoi_stream_cipher(cs, trace, input_var, output_var):
    """(anemoi/mod.rs:316-553)"""
    assert len(input_var) == len(trace.input)
    assert len(output_var) == len(trace.output)
    input_var = list(input_var)
    output_var = [v for v in output_var]
    one_var, zero_var = cs.one_var(), cs.zero_var()

    if len(output_var) % 3 != 0:
        output_var.extend([None] * (3 - len(output_var) % 3))
    output_chunks = [output_var[i : i + 3] for i in range(0, len(output_var), 3)]
    num_out = len(output_chunks)

    if len(input_var) % 3 == 0 and input_var:
        sigma_var = one_var
    else:
        input_var.append(one_var)
        if len(input_var) % 3 != 0:
            input_var.extend([zero_var] * (3 - len(input_var) % 3))
        sigma_var = zero_var

    assert len(input_var) + len(output_var) - 3 == len(trace.before_permutation) * 3
    input_chunks = [input_var[i : i + 3] for i in range(0, len(input_var), 3)]
    num_in = len(input_chunks)

    x_var = [input_chunks[0][0], input_chunks[0][1]]
    y_var = [input_chunks[0][2], zero_var]

    if num_in == 1 and num_out == 1:
        anemoi_permutation_round(
            cs, (x_var, y_var),
            ([output_chunks[0][0], output_chunks[0][1]], [output_chunks[0][2], None]),
            trace.intermediate_values[0],
        )
        return

    if num_in == 1:
        anemoi_permutation_round(
            cs, (x_var, y_var),
            ([output_chunks[0][0], output_chunks[0][1]], [output_chunks[0][2], None]),
            trace.intermediate_values[0],
        )
        new_x = [cs.new_variable(trace.after_permutation[0][0][i]) for i in range(2)]
        new_y = [cs.new_variable(trace.after_permutation[0][1][i]) for i in range(2)]
        new_y[1] = cs.add(new_y[1], sigma_var)
        for rr in range(1, num_out):
            x_var, y_var = new_x, new_y
            if rr != num_out - 1:
                new_x = [cs.new_variable(trace.after_permutation[rr][0][i]) for i in range(2)]
                new_y = [cs.new_variable(trace.after_permutation[rr][1][i]) for i in range(2)]
            oc = output_chunks[rr]
            anemoi_permutation_round(
                cs, (x_var, y_var), ([oc[0], oc[1]], [oc[2], None]),
                trace.intermediate_values[rr],
            )
        return

    # num_in > 1
    new_x = [cs.new_variable(trace.after_permutation[0][0][i]) for i in range(2)]
    new_y = [cs.new_variable(trace.after_permutation[0][1][i]) for i in range(2)]
    anemoi_permutation_round(
        cs, (x_var, y_var), ([new_x[0], new_x[1]], [new_y[0], new_y[1]]),
        trace.intermediate_values[0],
    )
    for rr in range(1, num_in - 1):
        x_var, y_var = new_x, new_y
        x_var = [cs.add(x_var[0], input_chunks[rr][0]), cs.add(x_var[1], input_chunks[rr][1])]
        y_var = [cs.add(y_var[0], input_chunks[rr][2]), y_var[1]]
        new_x = [cs.new_variable(trace.after_permutation[rr][0][i]) for i in range(2)]
        new_y = [cs.new_variable(trace.after_permutation[rr][1][i]) for i in range(2)]
        anemoi_permutation_round(
            cs, (x_var, y_var), ([new_x[0], new_x[1]], [new_y[0], new_y[1]]),
            trace.intermediate_values[rr],
        )
    # last absorption round
    x_var, y_var = new_x, new_y
    x_var = [cs.add(x_var[0], input_chunks[-1][0]), cs.add(x_var[1], input_chunks[-1][1])]
    y_var = [cs.add(y_var[0], input_chunks[-1][2]), y_var[1]]
    if num_out > 1:
        new_x = [cs.new_variable(trace.after_permutation[num_in - 1][0][i]) for i in range(2)]
        new_y = [cs.new_variable(trace.after_permutation[num_in - 1][1][i]) for i in range(2)]
        new_y[1] = cs.add(new_y[1], sigma_var)
    anemoi_permutation_round(
        cs, (x_var, y_var),
        ([output_chunks[0][0], output_chunks[0][1]], [output_chunks[0][2], None]),
        trace.intermediate_values[num_in - 1],
    )
    # squeezing rounds
    for rr in range(1, num_out):
        x_var, y_var = new_x, new_y
        if rr != num_out - 1:
            new_x = [cs.new_variable(trace.after_permutation[rr - 1 + num_in][0][i]) for i in range(2)]
            new_y = [cs.new_variable(trace.after_permutation[rr - 1 + num_in][1][i]) for i in range(2)]
        oc = output_chunks[rr]
        anemoi_permutation_round(
            cs, (x_var, y_var), ([oc[0], oc[1]], [oc[2], None]),
            trace.intermediate_values[rr - 1 + num_in],
        )


# ----------------------------------------------------------------------- ecc


class PointVar(NamedTuple):
    x: int
    y: int


def new_point_variable(cs, point) -> PointVar:
    return PointVar(cs.new_variable(point[0]), cs.new_variable(point[1]))


def prepare_pi_point_variable(cs, point_var: PointVar):
    cs.prepare_pi_variable(point_var.x)
    cs.prepare_pi_variable(point_var.y)


def insert_ecc_add_gate(cs, p1_var, p2_var, p_out_var):
    """Twisted Edwards addition, two gates (ecc/mod.rs:72-131)."""
    # x-coordinate: x3 = x1*y2 + y1*x2 - d*x1*y1*x2*y2*x3
    cs.push_add_selectors(0, 0, 0, 0)
    cs.push_mul_selectors(1, 1)
    cs.push_constant_selector(0)
    cs.push_ecc_selector((-EDWARDS_D) % P)
    cs.push_out_selector(1)
    cs.wiring[0].append(p1_var.x)
    cs.wiring[1].append(p2_var.y)
    cs.wiring[2].append(p2_var.x)
    cs.wiring[3].append(p1_var.y)
    cs.wiring[4].append(p_out_var.x)
    cs.size += 1
    # y-coordinate: y3 = -a*x1*x2 + y1*y2 + d*x1*y1*x2*y2*y3
    cs.push_add_selectors(0, 0, 0, 0)
    cs.push_mul_selectors((-EDWARDS_A) % P, 1)
    cs.push_constant_selector(0)
    cs.push_ecc_selector(EDWARDS_D)
    cs.push_out_selector(1)
    cs.wiring[0].append(p1_var.x)
    cs.wiring[1].append(p2_var.x)
    cs.wiring[2].append(p1_var.y)
    cs.wiring[3].append(p2_var.y)
    cs.wiring[4].append(p_out_var.y)
    cs.finish_new_gate()


def ecc_add(cs, p1_var, p2_var, p1_pt, p2_pt):
    p_out = bjj.add(p1_pt, p2_pt)
    p_out_var = new_point_variable(cs, p_out)
    insert_ecc_add_gate(cs, p1_var, p2_var, p_out_var)
    return p_out_var, p_out


def select_constant_points(cs, g1, g2, g3, b0_var, b1_var):
    """(const_base_ecc.rs:44-98)"""
    w0, w1 = cs.witness[b0_var], cs.witness[b1_var]
    pt = {(0, 0): bjj.IDENTITY, (1, 0): g1, (0, 1): g2, (1, 1): g3}[(w0, w1)]
    p_out_var = new_point_variable(cs, pt)

    cs.push_mul_selectors((g3[0] - (g1[0] + g2[0])) % P, 0)
    cs.push_add_selectors(g1[0], g2[0], 0, 0)
    cs.push_constant_selector(0)
    cs.push_ecc_selector(0)
    cs.push_out_selector(1)
    cs.wiring[0].append(b0_var)
    cs.wiring[1].append(b1_var)
    cs.wiring[2].append(0)
    cs.wiring[3].append(0)
    cs.wiring[4].append(p_out_var.x)
    cs.finish_new_gate()

    cs.push_add_selectors((g1[1] - 1) % P, (g2[1] - 1) % P, 0, 0)
    cs.push_mul_selectors((g3[1] + 1 - (g1[1] + g2[1])) % P, 0)
    cs.push_constant_selector(1)
    cs.push_ecc_selector(0)
    cs.push_out_selector(1)
    cs.wiring[0].append(b0_var)
    cs.wiring[1].append(b1_var)
    cs.wiring[2].append(0)
    cs.wiring[3].append(0)
    cs.wiring[4].append(p_out_var.y)
    cs.finish_new_gate()
    return p_out_var, pt


def scalar_mul_with_const_bases(cs, bases1, bases2, bases3, b_scalar_var):
    """(const_base_ecc.rs:131-164)"""
    n_bits = len(b_scalar_var)
    assert n_bits % 2 == 0 and n_bits > 0
    half = n_bits // 2
    p_var, p_pt = select_constant_points(cs, bases1[0], bases2[0], bases3[0], b_scalar_var[0], b_scalar_var[1])
    for i in range(1, half):
        t_var, t_pt = select_constant_points(
            cs, bases1[i], bases2[i], bases3[i], b_scalar_var[2 * i], b_scalar_var[2 * i + 1]
        )
        p_var, p_pt = ecc_add(cs, p_var, t_var, p_pt, t_pt)
    return p_var


def compute_base_multiples(base, n):
    """{4^i G}, {2*4^i G}, {3*4^i G} (const_base_ecc.rs:12-29)."""
    bases = [[], [], []]
    point = base
    for i in range(n):
        p2 = bjj.add(point, point)
        p3 = bjj.add(p2, point)
        bases[0].append(point)
        bases[2].append(p3)
        if i < n - 1:
            point = bjj.add(p2, p2)
        bases[1].append(p2)
    return bases


def const_base_scalar_mul(cs, base, scalar_var, n_bits):
    assert n_bits % 2 == 0 and n_bits > 0
    b = cs.range_check(scalar_var, n_bits)
    bases = compute_base_multiples(base, n_bits // 2)
    return scalar_mul_with_const_bases(cs, bases[0], bases[1], bases[2], b)


def nonconst_base_scalar_mul(cs, base_var, base, scalar_var, n_bits):
    """(nonconst_base_ecc.rs:39-62)"""
    b = cs.range_check(scalar_var, n_bits)
    res_var = PointVar(cs.zero_var(), cs.one_var())
    res_pt = bjj.IDENTITY
    for bit in reversed(b):
        res_var, res_pt = ecc_add(cs, res_var, res_var, res_pt, res_pt)
        x = cs.select(cs.zero_var(), base_var.x, bit)
        y = cs.select(cs.one_var(), base_var.y, bit)
        tmp_var = PointVar(x, y)
        tmp_pt = base if cs.witness[bit] else bjj.IDENTITY
        res_var, res_pt = ecc_add(cs, res_var, tmp_var, res_pt, tmp_pt)
    return res_var


# -------------------------------------------------------------------- shuffle


class CardVar(NamedTuple):
    """[e2.x, e2.y, e1.x, e1.y] variable indices (shuffle/mod.rs:13-48)."""

    v0: int
    v1: int
    v2: int
    v3: int

    def as_list(self):
        return [self.v0, self.v1, self.v2, self.v3]


def new_card_variable(cs, card: Ciphertext) -> CardVar:
    first_x = cs.new_variable(card.e1[0])
    first_y = cs.new_variable(card.e1[1])
    second_x = cs.new_variable(card.e2[0])
    second_y = cs.new_variable(card.e2[1])
    return CardVar(second_x, second_y, first_x, first_y)


def prepare_pi_card_variable(cs, card_var: CardVar):
    for v in card_var.as_list():
        cs.prepare_pi_variable(v)


def eval_card_remark(cs, trace: RemarkTrace, input_var: CardVar) -> CardVar:
    """86-gate remark chain (shuffle/remark.rs gadget:13-93)."""
    assert len(trace.bits) == trace.n_round
    assert len(trace.intermediate_values) == trace.n_round
    assert cs.n_iteration_shuffle_scalar_mul == trace.n_round

    bits = [[trace.bits[r][i] for r in range(trace.n_round)] for i in range(N_WIRE_SELECTORS)]
    cs.attach_shuffle_remark_constraints_to_gate(bits)

    ivars = []
    for values in trace.intermediate_values:
        ivars.append([cs.new_variable(x) for x in values])

    def blank_gate(w0, w1, w2, w3, w4):
        cs.push_add_selectors(0, 0, 0, 0)
        cs.push_mul_selectors(0, 0)
        cs.push_constant_selector(0)
        cs.push_ecc_selector(0)
        cs.push_out_selector(0)
        cs.wiring[0].append(w0)
        cs.wiring[1].append(w1)
        cs.wiring[2].append(w2)
        cs.wiring[3].append(w3)
        cs.wiring[4].append(w4)
        cs.finish_new_gate()

    blank_gate(input_var.v0, input_var.v1, input_var.v2, input_var.v3, ivars[0][3])
    for r in range(trace.n_round - 1):
        blank_gate(ivars[r][0], ivars[r][1], ivars[r][2], ivars[r][3], ivars[r + 1][3])
    blank_gate(ivars[-1][0], ivars[-1][1], ivars[-1][2], ivars[-1][3], cs.zero_var())

    return CardVar(*ivars[-1])


def _sum_in_chunks(cs, vars_list, attach_boolean=False):
    """Accumulate a list of variables 3 per gate (permutation.rs/matchmaking
    pattern); returns the sum variable."""
    zero_var = cs.zero_var()
    sum_var = zero_var
    for c in range(0, len(vars_list), 3):
        chunk = vars_list[c : c + 3]
        if len(chunk) == 3:
            sum_var = cs.linear_combine([sum_var, chunk[0], chunk[1], chunk[2]], 1, 1, 1, 1)
        elif len(chunk) == 2:
            sum_var = cs.linear_combine([sum_var, chunk[0], chunk[1], zero_var], 1, 1, 1, 0)
        else:
            sum_var = cs.linear_combine([sum_var, chunk[0], zero_var, zero_var], 1, 1, 0, 0)
        if attach_boolean:
            cs.attach_boolean_constraint_to_gate()
    return sum_var


def shuffle_card(cs, card_vars: List[CardVar], permutation: Permutation) -> List[CardVar]:
    """Permutation-matrix application (shuffle/permutation.rs gadget:10-215)."""
    n = len(permutation)
    assert len(card_vars) == n
    zero_var, one_var = cs.zero_var(), cs.one_var()

    matrix_vars = []
    for row in permutation.matrix:
        matrix_vars.append([cs.new_variable(v) for v in row])

    # rows: booleans + sum = 1
    for row in matrix_vars:
        s = _sum_in_chunks(cs, row, attach_boolean=True)
        cs.equal(s, one_var)
    # columns: sum = 1
    for j in range(n):
        col = [matrix_vars[i][j] for i in range(n)]
        s = _sum_in_chunks(cs, col, attach_boolean=False)
        cs.equal(s, one_var)

    card_split = [[cv.as_list()[i] for cv in card_vars] for i in range(4)]

    out_cards = []
    for row in matrix_vars:
        coords = []
        for i in range(4):
            col_vars = card_split[i]
            r_vars = []
            for c in range(0, n, 2):
                mv = row[c : c + 2]
                cv = col_vars[c : c + 2]
                if len(mv) == 2:
                    a, b = cs.witness[mv[0]], cs.witness[mv[1]]
                    cc, d = cs.witness[cv[0]], cs.witness[cv[1]]
                    r_var = cs.new_variable((a * cc + b * d) % P)
                    cs.push_add_selectors(0, 0, 0, 0)
                    cs.push_mul_selectors(1, 1)
                    cs.push_constant_selector(0)
                    cs.push_ecc_selector(0)
                    cs.push_out_selector(1)
                    cs.wiring[0].append(mv[0])
                    cs.wiring[1].append(cv[0])
                    cs.wiring[2].append(mv[1])
                    cs.wiring[3].append(cv[1])
                    cs.wiring[4].append(r_var)
                    cs.finish_new_gate()
                else:
                    a, b = cs.witness[mv[0]], cs.witness[cv[0]]
                    r_var = cs.new_variable(a * b % P)
                    cs.push_add_selectors(0, 0, 0, 0)
                    cs.push_mul_selectors(1, 1)
                    cs.push_constant_selector(0)
                    cs.push_ecc_selector(0)
                    cs.push_out_selector(1)
                    cs.wiring[0].append(mv[0])
                    cs.wiring[1].append(cv[0])
                    cs.wiring[2].append(zero_var)
                    cs.wiring[3].append(zero_var)
                    cs.wiring[4].append(r_var)
                    cs.finish_new_gate()
                r_vars.append(r_var)
            coords.append(_sum_in_chunks(cs, r_vars, attach_boolean=False))
        out_cards.append(CardVar(*coords))
    return out_cards


# ------------------------------------------------- attach methods to TurboCS

TurboCS.anemoi_permutation_round = anemoi_permutation_round
TurboCS.anemoi_variable_length_hash = anemoi_variable_length_hash
TurboCS.anemoi_stream_cipher = anemoi_stream_cipher
TurboCS.new_point_variable = new_point_variable
TurboCS.prepare_pi_point_variable = prepare_pi_point_variable
TurboCS.insert_ecc_add_gate = insert_ecc_add_gate
TurboCS.ecc_add = ecc_add
TurboCS.select_constant_points = select_constant_points
TurboCS.scalar_mul_with_const_bases = scalar_mul_with_const_bases
TurboCS.const_base_scalar_mul = const_base_scalar_mul
TurboCS.nonconst_base_scalar_mul = nonconst_base_scalar_mul
TurboCS.new_card_variable = new_card_variable
TurboCS.prepare_pi_card_variable = prepare_pi_card_variable
TurboCS.eval_card_remark = eval_card_remark
TurboCS.shuffle_card = shuffle_card
