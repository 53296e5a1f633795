"""ark-r1cs-std-compatible constraint synthesis for the reveal circuit.

The reference proves `RevealCircuit` (shuffle/src/reveal_with_snark.rs:85-133)
with ark-groth16 against the embedded `groth16_pk.bin`.  A Groth16 proving
key fixes the QAP — i.e. the exact R1CS matrices and variable order produced
by ark-r1cs-std 0.4's gadget synthesis.  To produce proofs the deployed
`Groth16Verifier.sol` accepts, this module replays that synthesis
*bit-for-bit*: same allocation order, same intermediate witnesses, same
constraint rows (A/B/C sides and coefficient signs).

Gadget semantics reproduced (ark-r1cs-std 0.4, twisted Edwards `AffineVar`
over `FpVar`, a = 1 for ed_on_bn254):

  * allocation of an Input point: x, y as instance columns, then the
    on-curve check  (d*x^2 - 1) * y^2 = (a*x^2 - 1)  with x^2, y^2 as
    `square()` witnesses;
  * `Vec<Boolean>` witness bits: one witness + booleanity row
    (1 - b) * b = 0 per bit, LSB-first over the 256-bit scalar bigint;
  * `scalar_mul_le`: double-and-add,
        res = zero; multiple = base
        for bit: tmp = res + multiple; res = select(bit, tmp, res);
                 multiple.double_in_place()
    with FpVar type-driven constant folding (constant*LC = LC, no witness);
  * TE addition (this + other):
        u  = ((-a)*x1 + y1) * (x2 + y2)
        v0 = y2 * x1;  v1 = x2 * y1;  w = v0 * v1;  v2 = d*w
        x3 witness;  (1 + v2) * x3 = v0 + v1
        y3 witness;  (1 - v2) * y3 = u + a*v0 - v1
  * TE doubling: xy = x*y; x2 = x^2; y2 = y^2;
        x3 witness;  (a*x2 + y2) * x3 = 2*xy
        y3 witness;  (2 - a*x2 - y2) * y3 = y2 - a*x2
  * select: r witness;  bit * (t - f) = r - f   (per coordinate; the
    both-constant case folds to the linear form bit*t + (1-bit)*f);
  * enforce_equal: (self - other) * 1 = 0 per coordinate.

Instance columns (gamma_abc order): [ONE, h.x, h.y, reveal.x, reveal.y,
pk.x, pk.y].  The synthesis is validated structurally against the embedded
pk (4869 QAP variables, 4862 witnesses, domain 8192) and end-to-end by
pairing-verifying proofs under the deployed contract's vk.
"""

from typing import Dict, List, Tuple

from ..constants.bn254 import R_MOD, EDWARDS_D

P = R_MOD
A_COEFF = 1
D_COEFF = EDWARDS_D

# LC keys: ("one", 0) | ("i", k) instance | ("w", j) witness
ONE = ("one", 0)


def _lc_add(a: Dict, b: Dict) -> Dict:
    out = dict(a)
    for k, v in b.items():
        nv = (out.get(k, 0) + v) % P
        if nv:
            out[k] = nv
        else:
            out.pop(k, None)
    return out


def _lc_scale(a: Dict, s: int) -> Dict:
    s %= P
    if not s:
        return {}
    return {k: (v * s) % P for k, v in a.items()}


class Synth:
    """Mirror of ark-relations' ConstraintSystem in Prove+construct_matrices
    mode with the Constraints optimization goal (LCs inlined eagerly)."""

    def __init__(self):
        self.instance: List[int] = []  # values, excluding ONE
        self.witness: List[int] = []
        self.rows: List[Tuple[Dict, Dict, Dict]] = []

    # -- allocation ---------------------------------------------------------
    def new_input(self, val: int) -> "FpVar":
        val %= P
        self.instance.append(val)
        return FpVar.var(self, {("i", len(self.instance) - 1): 1}, val)

    def new_witness(self, val: int) -> "FpVar":
        val %= P
        self.witness.append(val)
        return FpVar.var(self, {("w", len(self.witness) - 1): 1}, val)

    def enforce(self, a: "FpVar", b: "FpVar", c: "FpVar"):
        self.rows.append((a.as_lc(), b.as_lc(), c.as_lc()))

    # -- export -------------------------------------------------------------
    @property
    def num_instance(self) -> int:
        return len(self.instance) + 1

    @property
    def num_witness(self) -> int:
        return len(self.witness)

    def assignment(self) -> List[int]:
        return [1] + list(self.instance) + list(self.witness)

    def matrices(self):
        """Rows with columns remapped to ark's flat order:
        ONE=0, instance 1.., witness num_instance..  Returns (a, b, c) as
        lists of {col: coeff}."""
        ni = self.num_instance

        def remap(lc):
            out = {}
            for (kind, idx), coeff in lc.items():
                if kind == "one":
                    out[0] = coeff
                elif kind == "i":
                    out[1 + idx] = coeff
                else:
                    out[ni + idx] = coeff
            return out

        a = [remap(r[0]) for r in self.rows]
        b = [remap(r[1]) for r in self.rows]
        c = [remap(r[2]) for r in self.rows]
        return a, b, c


class FpVar:
    """('c', value) or ('v', lc, value) — mirrors FpVar::Constant /
    FpVar::Var with eager symbolic-LC inlining."""

    __slots__ = ("cs", "const", "lc", "val")

    def __init__(self, cs, const, lc, val):
        self.cs = cs
        self.const = const
        self.lc = lc
        self.val = val % P

    @staticmethod
    def constant(v: int) -> "FpVar":
        return FpVar(None, True, None, v)

    @staticmethod
    def var(cs, lc, val) -> "FpVar":
        return FpVar(cs, False, lc, val)

    def as_lc(self) -> Dict:
        if self.const:
            return {ONE: self.val} if self.val else {}
        return self.lc

    # -- linear ops (no constraints) ---------------------------------------
    def add(self, other: "FpVar") -> "FpVar":
        if self.const and other.const:
            return FpVar.constant(self.val + other.val)
        cs = self.cs or other.cs
        return FpVar.var(cs, _lc_add(self.as_lc(), other.as_lc()), self.val + other.val)

    def sub(self, other: "FpVar") -> "FpVar":
        return self.add(other.scale(P - 1))

    def add_const(self, k: int) -> "FpVar":
        return self.add(FpVar.constant(k))

    def scale(self, k: int) -> "FpVar":
        """Multiplication by a field constant — type-preserving (a Var scaled
        by 0 stays a Var, as in ark's AllocatedFp::mul_constant)."""
        if self.const:
            return FpVar.constant(self.val * k)
        return FpVar.var(self.cs, _lc_scale(self.lc, k), self.val * k)

    def double(self) -> "FpVar":
        return self.scale(2)

    # -- multiplicative ops -------------------------------------------------
    def mul(self, other: "FpVar") -> "FpVar":
        """FpVar Mul: Var*Var allocates the product witness + one row;
        any Constant side folds to a linear op."""
        if self.const:
            return other.scale(self.val)
        if other.const:
            return self.scale(other.val)
        cs = self.cs
        prod = cs.new_witness(self.val * other.val % P)
        cs.enforce(self, other, prod)
        return prod

    def square(self) -> "FpVar":
        return self.mul(self)

    def mul_equals(self, other: "FpVar", result: "FpVar"):
        """FieldVar::mul_equals — one row, no new witness (constant cases
        degrade to enforce_equal on the scaled LC, as in ark)."""
        cs = self.cs or other.cs or result.cs
        if self.const:
            other.scale(self.val).enforce_equal(result)
        elif other.const:
            self.scale(other.val).enforce_equal(result)
        else:
            cs.enforce(self, other, result)

    def enforce_equal(self, other: "FpVar"):
        cs = self.cs or other.cs
        assert cs is not None, "constant == constant needs no constraint"
        diff = self.sub(other)
        assert diff.val == 0, "enforce_equal: witness values differ"
        cs.enforce(diff, FpVar.constant(1), FpVar.constant(0))


class Boolean:
    """AllocatedBool (witness bit with booleanity row (1 - b) * b = 0)."""

    __slots__ = ("cs", "var", "val")

    def __init__(self, cs, var: FpVar, val: int):
        self.cs = cs
        self.var = var
        self.val = val

    @staticmethod
    def new_witness(cs: Synth, bit: int) -> "Boolean":
        v = cs.new_witness(bit)
        one_minus = FpVar.constant(1).sub(v)
        cs.enforce(one_minus, v, FpVar.constant(0))
        return Boolean(cs, v, bit)

    def select_fp(self, t: FpVar, f: FpVar) -> FpVar:
        """FpVar::conditionally_select with a variable condition."""
        if t.const and f.const:
            # is*t + not*f — linear, no allocation
            return self.var.scale(t.val).add(
                FpVar.constant(1).sub(self.var).scale(f.val)
            )
        cs = self.cs
        r = cs.new_witness(t.val if self.val else f.val)
        # bit * (t - f) = r - f
        cs.enforce(self.var, t.sub(f), r.sub(f))
        return r


class PointVar:
    """twisted Edwards AffineVar (a = 1 for ed_on_bn254)."""

    __slots__ = ("x", "y")

    def __init__(self, x: FpVar, y: FpVar):
        self.x = x
        self.y = y

    @property
    def is_constant(self) -> bool:
        return self.x.const and self.y.const

    @staticmethod
    def constant(pt) -> "PointVar":
        return PointVar(FpVar.constant(pt[0]), FpVar.constant(pt[1]))

    @staticmethod
    def zero() -> "PointVar":
        return PointVar(FpVar.constant(0), FpVar.constant(1))

    @staticmethod
    def new_input(cs: Synth, pt) -> "PointVar":
        """AllocVar for AffineVar, mode=Input: allocate x, y then enforce
        (d*x^2 - 1) * y^2 = a*x^2 - 1."""
        x = cs.new_input(pt[0])
        y = cs.new_input(pt[1])
        x2 = x.square()
        y2 = y.square()
        d_x2_minus_one = x2.scale(D_COEFF).add_const(P - 1)
        a_x2_minus_one = x2.scale(A_COEFF).add_const(P - 1)
        d_x2_minus_one.mul_equals(y2, a_x2_minus_one)
        return PointVar(x, y)

    def value(self):
        return (self.x.val, self.y.val)

    def add(self, other: "PointVar") -> "PointVar":
        """this + other (self is `this`/P1, matching res + multiple)."""
        if self.is_constant and other.is_constant:
            from ..curve.babyjubjub import add as te_add

            return PointVar.constant(te_add(self.value(), other.value()))
        cs = self.x.cs or self.y.cs or other.x.cs or other.y.cs
        a, d = A_COEFF, D_COEFF
        u1 = self.x.scale(P - a).add(self.y)
        u2 = other.x.add(other.y)
        u = u1.mul(u2)
        v0 = other.y.mul(self.x)
        v1 = other.x.mul(self.y)
        w = v0.mul(v1)
        v2 = w.scale(d)

        # x3 = (v0 + v1).mul_by_inverse_unchecked(1 + v2):
        #   witness x3, then x3.mul_equals(denom, numerator)
        inv_x = pow(1 + v2.val, P - 2, P)
        x3 = cs.new_witness((v0.val + v1.val) * inv_x % P)
        x3.mul_equals(v2.add_const(1), v0.add(v1))

        inv_y = pow((1 - v2.val) % P, P - 2, P)
        y3 = cs.new_witness((u.val + a * v0.val - v1.val) * inv_y % P)
        one_minus_v2 = v2.scale(P - 1).add_const(1)
        y3.mul_equals(one_minus_v2, u.add(v0.scale(a)).sub(v1))
        return PointVar(x3, y3)

    def double(self) -> "PointVar":
        if self.is_constant:
            from ..curve.babyjubjub import double as te_double

            return PointVar.constant(te_double(self.value()))
        cs = self.x.cs or self.y.cs
        a = A_COEFF
        xy = self.x.mul(self.y)
        x2 = self.x.square()
        y2 = self.y.square()
        a_x2 = x2.scale(a)

        denom_x = a_x2.add(y2)
        inv_x = pow(denom_x.val, P - 2, P)
        x3 = cs.new_witness(2 * xy.val * inv_x % P)
        x3.mul_equals(denom_x, xy.double())

        denom_y = a_x2.add(y2).scale(P - 1).add_const(2)
        inv_y = pow(denom_y.val, P - 2, P)
        y3 = cs.new_witness((y2.val - a_x2.val) * inv_y % P)
        y3.mul_equals(denom_y, y2.sub(a_x2))
        return PointVar(x3, y3)

    def select(self, bit: Boolean, other: "PointVar") -> "PointVar":
        """bit ? self : other — coordinate-wise (x then y)."""
        return PointVar(bit.select_fp(self.x, other.x), bit.select_fp(self.y, other.y))

    def scalar_mul_le(self, bits: List[Boolean]) -> "PointVar":
        res = PointVar.zero()
        multiple = self
        for bit in bits:
            tmp = res.add(multiple)
            res = tmp.select(bit, res)
            multiple = multiple.double()
        return res

    def enforce_equal(self, other: "PointVar"):
        self.x.enforce_equal(other.x)
        self.y.enforce_equal(other.y)


def synthesize_reveal(sk: int, masked_e1, reveal_pt, pk_pt) -> Synth:
    """Replay RevealCircuit::generate_constraints (reveal_with_snark.rs:113-133).

    Allocation order: g (constant), h = masked.e1 (input), reveal (input),
    pk (input), sk bits (256 witnesses, LSB first); then
    g^sk == pk and h^sk == reveal."""
    from ..constants.bn254 import BJJ_GENERATOR  # ark EdwardsProjective::generator()

    cs = Synth()
    g = PointVar.constant(BJJ_GENERATOR)
    h = PointVar.new_input(cs, masked_e1)
    reveal = PointVar.new_input(cs, reveal_pt)
    pk = PointVar.new_input(cs, pk_pt)
    bits = [Boolean.new_witness(cs, (sk >> i) & 1) for i in range(256)]

    tmp1 = g.scalar_mul_le(bits)
    tmp1.enforce_equal(pk)
    tmp2 = h.scalar_mul_le(bits)
    tmp2.enforce_equal(reveal)
    return cs
