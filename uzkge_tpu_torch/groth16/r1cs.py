"""Sparse R1CS constraint system over BN254 Fr.

Matches the shape consumed by Groth16 (ark-relations' `ConstraintSystem`,
used by shuffle/src/reveal_with_snark.rs:116-133): variables
are [one, instance..., witness...]; each constraint is <A,z>*<B,z> = <C,z>
with sparse linear combinations.

`chain_circuit` builds the seeded test circuit of the port's tests and
chip_smoke.py.  Otherwise a copy of `uzkge_tpu/groth16/r1cs.py`.

This is a host-side builder — reveal-style circuits are a few thousand
constraints, so synthesis stays in python ints; the prover's heavy work
(MSMs, NTTs) runs on device in groth16.py.
"""

from ..constants.bn254 import R_MOD

P = R_MOD


class LC(dict):
    """Sparse linear combination {var_index: coeff}."""

    def plus(self, other):
        out = LC(self)
        for k, v in other.items():
            nv = (out.get(k, 0) + v) % P
            if nv:
                out[k] = nv
            else:
                out.pop(k, None)
        return out

    def scaled(self, c):
        c %= P
        return LC({k: (v * c) % P for k, v in self.items()}) if c else LC()

    def minus(self, other):
        return self.plus(other.scaled(P - 1))


class R1CS:
    """Constraint builder.  Variable 0 is the constant ONE."""

    def __init__(self):
        self.num_instance = 0  # not counting ONE
        self.assignment = [1]  # full assignment, index-aligned with variables
        self.instance_ids = []
        self.witness_ids = []
        self.constraints = []  # list of (LC, LC, LC)

    # -- variables ---------------------------------------------------------
    def new_instance(self, value):
        idx = len(self.assignment)
        self.assignment.append(value % P)
        self.instance_ids.append(idx)
        self.num_instance += 1
        return idx

    def new_witness(self, value):
        idx = len(self.assignment)
        self.assignment.append(value % P)
        self.witness_ids.append(idx)
        return idx

    def one(self):
        return 0

    def lc(self, *terms):
        """lc((coeff, var), ...) -> LC.  Use var=0 for constants."""
        out = LC()
        for c, v in terms:
            c %= P
            if c:
                out[v] = (out.get(v, 0) + c) % P
                if not out[v]:
                    del out[v]
        return out

    # -- constraints -------------------------------------------------------
    def enforce(self, a: LC, b: LC, c: LC):
        self.constraints.append((a, b, c))

    def enforce_equal(self, a: LC, b: LC):
        self.enforce(a.minus(b), self.lc((1, 0)), LC())

    def enforce_boolean(self, v):
        # v * (1 - v) = 0
        self.enforce(self.lc((1, v)), self.lc((1, 0), (P - 1, v)), LC())

    # -- gadget helpers (value + constraint together) -----------------------
    def eval_lc(self, lc: LC):
        return sum(c * self.assignment[v] for v, c in lc.items()) % P

    def mul(self, a: LC, b: LC):
        """Allocate out = <a,z> * <b,z> as a witness, with one constraint."""
        out = self.new_witness(self.eval_lc(a) * self.eval_lc(b) % P)
        self.enforce(a, b, self.lc((1, out)))
        return out

    def select(self, bit, then_lc: LC, else_lc: LC):
        """out = bit ? then : else  (bit must already be boolean-constrained):
        bit * (then - else) = out - else."""
        bval = self.assignment[bit]
        out_val = self.eval_lc(then_lc) if bval else self.eval_lc(else_lc)
        out = self.new_witness(out_val)
        self.enforce(
            self.lc((1, bit)), then_lc.minus(else_lc), self.lc((1, out)).minus(else_lc)
        )
        return out

    # -- canonical variable order -------------------------------------------
    def canonicalized(self):
        """Return an equivalent R1CS with variables in the canonical Groth16
        order [one, instances..., witnesses...] (ark-relations keeps separate
        instance/witness namespaces, so its matrices are always in this order;
        our single index space allows interleaved allocation and must be
        remapped before the QAP instance split)."""
        ninst = self.num_instance
        if self.instance_ids == list(range(1, ninst + 1)):
            return self
        order = [0] + self.instance_ids + self.witness_ids
        pos = [0] * len(self.assignment)
        for new, old in enumerate(order):
            pos[old] = new
        out = R1CS()
        out.num_instance = ninst
        out.assignment = [self.assignment[old] for old in order]
        out.instance_ids = list(range(1, ninst + 1))
        out.witness_ids = list(range(ninst + 1, len(order)))
        out.constraints = [
            (
                LC({pos[v]: c for v, c in A.items()}),
                LC({pos[v]: c for v, c in B.items()}),
                LC({pos[v]: c for v, c in C.items()}),
            )
            for A, B, C in self.constraints
        ]
        return out

    # -- checks --------------------------------------------------------------
    def is_satisfied(self):
        for a, b, c in self.constraints:
            if self.eval_lc(a) * self.eval_lc(b) % P != self.eval_lc(c):
                return False
        return True

    @property
    def num_constraints(self):
        return len(self.constraints)

    @property
    def num_vars(self):
        return len(self.assignment)

    def public_inputs(self):
        return [self.assignment[i] for i in self.instance_ids]


def chain_circuit(n_products: int, x: int) -> R1CS:
    """A satisfied R1CS of `n_products` chained products: public x, w_0 = x,
    w_{i+1} = w_i * (w_i + i + 1), and public y = w_n, allocated last (so
    that canonicalized() has to move it before the witnesses) and tied to
    w_n by enforce_equal.  n_products + 1 constraints, 2 instances: a domain
    of 64 up to 60 products, of 1024 up to 1020."""
    cs = R1CS()
    xi = cs.new_instance(x)
    w = xi
    for i in range(n_products):
        w = cs.mul(cs.lc((1, w)), cs.lc((1, w), (i + 1, 0)))
    yi = cs.new_instance(cs.assignment[w])
    cs.enforce_equal(cs.lc((1, w)), cs.lc((1, yi)))
    return cs
