"""TurboPLONK constraint system (circuit layer).

Host-side circuit builder producing selector/wiring/witness arrays consumed by
the TPU indexer/prover.  Circuit construction is trace-driven and inherently
sequential, so it stays in python (SURVEY.md section 7 design stance); the
arrays it emits go straight to device.

Semantics follow the reference TurboCS exactly — 5 wires, 9 selectors, gate
equation
    q1*w1 + q2*w2 + q3*w3 + q4*w4 + qm1*w1*w2 + qm2*w3*w4 + qc + PI
    + q_ecc*(w1*w2*w3*w4*wo) - qo*wo = 0
(reference uzkge/src/plonk/constraint_system/turbo/mod.rs:187-222), with the
extra per-gate constraint classes (public-input gates, boolean gates, Anemoi
gates, shuffle-remark gates) tracked by index lists.  Byte-exact circuit
layout is required for the generated verifier keys to match the reference's.
"""

import os
import traceback
from typing import List, Tuple

from ..constants.bn254 import R_MOD as P, EDWARDS_A
from ..errors import DanglingWitnessError
from ..constants.anemoi_constants import N_ANEMOI_ROUNDS

N_WIRES_PER_GATE = 5
N_SELECTORS = 9
N_WIRE_SELECTORS = 3
N_SHUFFLE_RELATED_SELECTORS = 24


class TurboCS:
    """Turbo PLONK constraint system (reference turbo/mod.rs:30-97,401-439)."""

    def __init__(self, debug: bool = None):
        # dangling-witness detector: mirrors the reference `debug` cargo
        # feature (turbo/mod.rs:94-96,529-629,979-1001) which records a
        # backtrace per witness variable and panics at pad() if any variable
        # was allocated but never wired into a gate.
        if debug is None:
            debug = bool(os.environ.get("UZKGE_DEBUG"))
        self.debug = debug
        self._witness_origin = {}
        self.selectors: List[List[int]] = [[] for _ in range(N_SELECTORS)]
        self.wiring: List[List[int]] = [[] for _ in range(N_WIRES_PER_GATE)]
        self.edwards_a = 0
        self.shuffle_pk_x: List[List[int]] = []
        self.shuffle_pk_y: List[List[int]] = []
        self.shuffle_pk_dxy: List[List[int]] = []
        self.shuffle_gen_x: List[List[int]] = []
        self.shuffle_gen_y: List[List[int]] = []
        self.shuffle_gen_dxy: List[List[int]] = []
        self.anemoi_prk_x = [[0, 0] for _ in range(N_ANEMOI_ROUNDS)]
        self.anemoi_prk_y = [[0, 0] for _ in range(N_ANEMOI_ROUNDS)]
        self.anemoi_generator = 0
        self.anemoi_generator_inv = 0
        self.anemoi_constraints_indices: List[int] = []
        self.n_iteration_shuffle_scalar_mul = 0
        self.num_vars = 2
        self.size = 0
        self.public_vars_constraint_indices: List[int] = []
        self.public_vars_witness_indices: List[int] = []
        self.boolean_constraint_indices: List[int] = []
        # list of (cs_index, [s1_vals, s2_vals, s3_vals])
        self.shuffle_remark_constraint_indices: List[Tuple[int, List[List[int]]]] = []
        self.verifier_only = False
        self.witness: List[int] = [0, 1]

        self.insert_constant_gate(self.zero_var(), 0)
        self.insert_constant_gate(self.one_var(), 1)

    # ------------------------------------------------------------------ core

    def zero_var(self) -> int:
        return 0

    def one_var(self) -> int:
        return 1

    def new_variable(self, value: int) -> int:
        self.num_vars += 1
        self.witness.append(value % P)
        if self.debug:
            self._witness_origin[self.num_vars - 1] = "".join(
                traceback.format_stack(limit=6)[:-1]
            )
        return self.num_vars - 1

    def push_add_selectors(self, q1, q2, q3, q4):
        self.selectors[0].append(q1 % P)
        self.selectors[1].append(q2 % P)
        self.selectors[2].append(q3 % P)
        self.selectors[3].append(q4 % P)

    def push_mul_selectors(self, qm12, qm34):
        self.selectors[4].append(qm12 % P)
        self.selectors[5].append(qm34 % P)

    def push_constant_selector(self, qc):
        self.selectors[6].append(qc % P)

    def push_ecc_selector(self, qecc):
        self.selectors[7].append(qecc % P)

    def push_out_selector(self, qo):
        self.selectors[8].append(qo % P)

    def finish_new_gate(self):
        self.size += 1

    # ------------------------------------------------------------- base gates

    def insert_lc_gate(self, wires_in, wire_out, q1, q2, q3, q4):
        """wo = q1*w1 + q2*w2 + q3*w3 + q4*w4 (turbo/mod.rs:452-478)."""
        self.push_add_selectors(q1, q2, q3, q4)
        self.push_mul_selectors(0, 0)
        self.push_constant_selector(0)
        self.push_ecc_selector(0)
        self.push_out_selector(1)
        for i, w in enumerate(wires_in):
            self.wiring[i].append(w)
        self.wiring[4].append(wire_out)
        self.finish_new_gate()

    def insert_add_gate(self, left, right, out):
        self.insert_lc_gate([left, right, 0, 0], out, 1, 1, 0, 0)

    def insert_sub_gate(self, left, right, out):
        self.insert_lc_gate([left, right, 0, 0], out, 1, P - 1, 0, 0)

    def insert_mul_gate(self, left, right, out):
        self.push_add_selectors(0, 0, 0, 0)
        self.push_mul_selectors(1, 0)
        self.push_constant_selector(0)
        self.push_ecc_selector(0)
        self.push_out_selector(1)
        self.wiring[0].append(left)
        self.wiring[1].append(right)
        self.wiring[2].append(0)
        self.wiring[3].append(0)
        self.wiring[4].append(out)
        self.finish_new_gate()

    def linear_combine(self, wires_in, q1, q2, q3, q4) -> int:
        w = self.witness
        lc = (w[wires_in[0]] * q1 + w[wires_in[1]] * q2 + w[wires_in[2]] * q3 + w[wires_in[3]] * q4) % P
        out = self.new_variable(lc)
        self.insert_lc_gate(wires_in, out, q1, q2, q3, q4)
        return out

    def add(self, left, right) -> int:
        out = self.new_variable((self.witness[left] + self.witness[right]) % P)
        self.insert_add_gate(left, right, out)
        return out

    def equal(self, left, right):
        self.insert_sub_gate(left, right, self.zero_var())

    def mul(self, left, right) -> int:
        out = self.new_variable(self.witness[left] * self.witness[right] % P)
        self.insert_mul_gate(left, right, out)
        return out

    def insert_boolean_gate(self, var):
        self.insert_mul_gate(var, var, var)

    def insert_constant_gate(self, var, constant):
        self.push_add_selectors(0, 0, 0, 0)
        self.push_mul_selectors(0, 0)
        self.push_constant_selector(constant)
        self.push_ecc_selector(0)
        self.push_out_selector(1)
        for i in range(N_WIRES_PER_GATE):
            self.wiring[i].append(var)
        self.finish_new_gate()

    def insert_constant_gate_for_input(self, var, constant):
        self.push_add_selectors(0, 0, 0, 0)
        self.push_mul_selectors(0, 0)
        self.push_constant_selector(constant)
        self.push_ecc_selector(0)
        self.push_out_selector(1)
        for i in range(N_WIRES_PER_GATE):
            self.wiring[i].append(var)
        self.size += 1

    def prepare_pi_variable(self, var):
        self.public_vars_witness_indices.append(var)
        self.public_vars_constraint_indices.append(self.size)
        self.insert_constant_gate_for_input(var, 0)

    def attach_boolean_constraint_to_gate(self):
        self.boolean_constraint_indices.append(self.size - 1)

    def attach_anemoi_jive_constraints_to_gate(self):
        assert self.anemoi_generator != 0
        self.anemoi_constraints_indices.append(self.size - 1)

    def attach_shuffle_remark_constraints_to_gate(self, wiring_selectors):
        for x in wiring_selectors:
            assert len(x) == self.n_iteration_shuffle_scalar_mul
        self.shuffle_remark_constraint_indices.append((self.size, wiring_selectors))

    # ---------------------------------------------------------- select / util

    def select(self, var0, var1, bit) -> int:
        """(1-bit)*var0 + bit*var1 (turbo/mod.rs:771-796):
        wires (bit, var0, bit, var1), qm1 = -1, q2 = qm2 = qo = 1."""
        self.push_add_selectors(0, 1, 0, 0)
        self.push_mul_selectors(P - 1, 1)
        self.push_constant_selector(0)
        self.push_ecc_selector(0)
        self.push_out_selector(1)
        out = self.new_variable(self.witness[var1] if self.witness[bit] else self.witness[var0])
        self.wiring[0].append(bit)
        self.wiring[1].append(var0)
        self.wiring[2].append(bit)
        self.wiring[3].append(var1)
        self.wiring[4].append(out)
        self.finish_new_gate()
        return out

    def range_check(self, var, n_bits) -> List[int]:
        """0 <= witness[var] < 2^n_bits via booleans + 3-bit-per-gate
        accumulation (turbo/mod.rs:711-765)."""
        assert n_bits >= 2
        val = self.witness[var]
        bits = [(val >> i) & 1 for i in range(n_bits)]
        b = [self.new_variable(x) for x in bits]
        bin_c = [1, 2, 4, 8]
        acc = b[n_bits - 1]
        self.insert_boolean_gate(b[n_bits - 1])
        m = (n_bits - 2) // 3
        for i in range(m):
            acc = self.linear_combine(
                [acc, b[n_bits - 1 - i * 3 - 1], b[n_bits - 1 - i * 3 - 2], b[n_bits - 1 - i * 3 - 3]],
                bin_c[3], bin_c[2], bin_c[1], bin_c[0],
            )
            self.attach_boolean_constraint_to_gate()
        rem = (n_bits - 1) - 3 * m
        if rem == 1:
            self.insert_lc_gate([acc, b[0], 0, 0], var, bin_c[1], bin_c[0], 0, 0)
        elif rem == 2:
            self.insert_lc_gate([acc, b[1], b[0], 0], var, bin_c[2], bin_c[1], bin_c[0], 0)
        else:
            self.insert_lc_gate([acc, b[2], b[1], b[0]], var, bin_c[3], bin_c[2], bin_c[1], bin_c[0])
        self.attach_boolean_constraint_to_gate()
        return b

    # --------------------------------------------------------------- loaders

    def load_shuffle_remark_parameters(self, shuffle_pk):
        """(turbo/mod.rs:926-965)"""
        from ..shuffle.primitives import (
            GENERATOR_WINDOWS,
            create_windows,
            windows_xydxy,
            NUM_ITERATIONS,
        )

        gx, gy, gdxy = windows_xydxy(GENERATOR_WINDOWS)
        pkx, pky, pkdxy = windows_xydxy(create_windows(shuffle_pk))
        self.edwards_a = EDWARDS_A
        self.n_iteration_shuffle_scalar_mul = NUM_ITERATIONS
        self.shuffle_pk_x, self.shuffle_pk_y, self.shuffle_pk_dxy = pkx, pky, pkdxy
        self.shuffle_gen_x, self.shuffle_gen_y, self.shuffle_gen_dxy = gx, gy, gdxy

    # ------------------------------------------------------------------- pad

    def check_dangling_witness(self):
        """Raise DanglingWitnessError for variables never wired into a gate
        (the reference panics here under the `debug` feature)."""
        used = {0, 1}
        for wire in self.wiring:
            used.update(wire)
        dangling = [v for v in range(self.num_vars) if v not in used]
        if dangling:
            raise DanglingWitnessError(dangling, self._witness_origin)

    def pad(self, min_size: int = 1):
        """Pad gate count to the next power of two (turbo/mod.rs:968-977);
        `min_size` lets tests force a common size to share compiled kernels."""
        if self.debug:
            self.check_dangling_witness()
        n = 1 << (self.size - 1).bit_length() if self.size > 1 else 1
        n = max(n, min_size)
        diff = n - self.size
        for sel in self.selectors:
            sel.extend([0] * diff)
        for wire in self.wiring:
            wire.extend([0] * diff)
        self.size = n

    # -------------------------------------------------- derived prover inputs

    def quot_eval_dom_size(self) -> int:
        """Radix-2 quotient evaluation domain: 8n (vs the reference's
        mixed-radix 6n — same interpolated quotient, see ntt.py docstring);
        16n for tiny circuits so deg t = 5n+10 < m."""
        return self.size * 8 if self.size > 4 else self.size * 16

    def compute_permutation(self) -> List[int]:
        """Copy-constraint permutation: one cycle per variable over its
        occurrence positions in the flattened wiring (semantics of
        constraint_system/mod.rs:64-92, built in O(wires) via per-variable
        position lists rather than the reference's quadratic rescan)."""
        n = self.size
        positions: dict = {}
        flat_idx = 0
        for wire in self.wiring:
            assert len(wire) == n
            for v in wire:
                positions.setdefault(v, []).append(flat_idx)
                flat_idx += 1
        perm = [0] * (N_WIRES_PER_GATE * n)
        for v, pos in positions.items():
            for i in range(len(pos)):
                perm[pos[i]] = pos[(i + 1) % len(pos)]
        return perm

    def extend_witness(self, witness) -> List[int]:
        out = []
        for wire in self.wiring:
            for idx in wire:
                out.append(witness[idx])
        return out

    def compute_witness_selectors(self):
        """The three wire-selector columns from remark traces
        (turbo/mod.rs:171-185)."""
        polys = [[0] * self.size for _ in range(N_WIRE_SELECTORS)]
        for i, wire_sel in self.shuffle_remark_constraint_indices:
            for j in range(self.n_iteration_shuffle_scalar_mul):
                for s in range(N_WIRE_SELECTORS):
                    polys[s][i + j] = wire_sel[s][j]
        return polys

    def compute_anemoi_jive_selectors(self):
        """(turbo/mod.rs:285-304)"""
        polys = [[0] * self.size for _ in range(4)]
        for i in self.anemoi_constraints_indices:
            for j in range(N_ANEMOI_ROUNDS):
                polys[0][i + j] = self.anemoi_prk_x[j][0]
                polys[1][i + j] = self.anemoi_prk_x[j][1]
                polys[2][i + j] = self.anemoi_prk_y[j][0]
                polys[3][i + j] = self.anemoi_prk_y[j][1]
        return polys

    def _shuffle_selectors(self, xs, ys, dxys):
        polys = [[0] * self.size for _ in range(N_SHUFFLE_RELATED_SELECTORS // 2)]
        for i, _ in self.shuffle_remark_constraint_indices:
            for j in range(self.n_iteration_shuffle_scalar_mul):
                for c in range(4):
                    polys[c][i + j] = xs[j][c]
                    polys[4 + c][i + j] = ys[j][c]
                    polys[8 + c][i + j] = dxys[j][c]
        return polys

    def compute_shuffle_generator_selectors(self):
        return self._shuffle_selectors(self.shuffle_gen_x, self.shuffle_gen_y, self.shuffle_gen_dxy)

    def compute_shuffle_public_key_selectors(self):
        return self._shuffle_selectors(self.shuffle_pk_x, self.shuffle_pk_y, self.shuffle_pk_dxy)

    def get_and_clear_witness(self):
        w = self.witness
        self.witness = []
        return w

    # -------------------------------------------------------- witness checker

    @staticmethod
    def eval_selector_multipliers(w):
        """Coefficients (w1, w2, w3, w4, w1w2, w3w4, 1, w1w2w3w4wo, -w4o)
        (turbo/mod.rs:226-248)."""
        prod = w[0] * w[1] % P * w[2] % P * w[3] % P * w[4] % P
        return [w[0], w[1], w[2], w[3], w[0] * w[1] % P, w[2] * w[3] % P, 1, prod, (P - w[4]) % P]

    def shuffle_remark_indices_only(self):
        return [i for i, _ in self.shuffle_remark_constraint_indices]
