"""BN254 (alt_bn128) optimal-ate pairing in pure python.

Used by the KZG verifier (host side — pairing checks are two tiny operations
per proof, not a TPU workload).  Matches the semantics of EVM precompile 0x08
and ark-bn254's `Bn254::multi_pairing` as called in
uzkge/src/poly_commit/kzg_poly_commitment.rs:344-423.

Construction: Fq12 = Fq[w]/(w^12 - 18 w^6 + 82), with Fq2 embedded via
u = w^6 - 9; G2 points are mapped through the cubic/sextic twist
(x, y) -> (x' w^2, y' w^3).  Miller loop over ate_loop_count = 6x+2 with the
two Frobenius correction lines, then the full final exponentiation
(q^12 - 1)/r done as a plain modular exponentiation.
"""

from ..constants.bn254 import Q_MOD, R_MOD, ATE_LOOP_COUNT

Q = Q_MOD

# Fq12 modulus polynomial: w^12 - 18 w^6 + 82
_MOD_COEFFS = [82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0]

_FINAL_EXP = (Q**12 - 1) // R_MOD


def _poly_rounded_div(a, b):
    dega = _deg(a)
    degb = _deg(b)
    temp = [x for x in a]
    o = [0] * len(a)
    for i in range(dega - degb, -1, -1):
        c = temp[degb + i] * pow(b[degb], Q - 2, Q) % Q
        o[i] = (o[i] + c) % Q
        for cc in range(degb + 1):
            temp[cc + i] = (temp[cc + i] - c * b[cc]) % Q
    return o[: _deg(o) + 1]


def _deg(p):
    d = len(p) - 1
    while d and p[d] == 0:
        d -= 1
    return d


class FQ12:
    __slots__ = ("c",)

    def __init__(self, coeffs):
        assert len(coeffs) == 12
        self.c = [x % Q for x in coeffs]

    @staticmethod
    def one():
        return FQ12([1] + [0] * 11)

    @staticmethod
    def from_fq(x):
        return FQ12([x % Q] + [0] * 11)

    @staticmethod
    def from_fq2(x):
        """Embed Fq2 element (c0, c1) with u = w^6 - 9."""
        c0, c1 = x
        coeffs = [0] * 12
        coeffs[0] = (c0 - 9 * c1) % Q
        coeffs[6] = c1 % Q
        return FQ12(coeffs)

    def __add__(self, other):
        return FQ12([(a + b) % Q for a, b in zip(self.c, other.c)])

    def __sub__(self, other):
        return FQ12([(a - b) % Q for a, b in zip(self.c, other.c)])

    def __neg__(self):
        return FQ12([(-a) % Q for a in self.c])

    def __mul__(self, other):
        b = [0] * 23
        sc, oc = self.c, other.c
        for i in range(12):
            si = sc[i]
            if si:
                for j in range(12):
                    b[i + j] += si * oc[j]
        for i in range(22, 11, -1):
            top = b[i] % Q
            if top:
                b[i - 6] += top * 18
                b[i - 12] -= top * 82
        return FQ12([x % Q for x in b[:12]])

    def __eq__(self, other):
        return self.c == other.c

    def inv(self):
        # Extended Euclid over Fq[w] modulo the field polynomial.
        lm, hm = [1] + [0] * 12, [0] * 13
        low = self.c + [0]
        high = [m % Q for m in _MOD_COEFFS] + [1]
        while _deg(low):
            r = _poly_rounded_div(high, low)
            r += [0] * (13 - len(r))
            nm = [x for x in hm]
            new = [x for x in high]
            for i in range(13):
                for j in range(13 - i):
                    nm[i + j] = (nm[i + j] - lm[i] * r[j]) % Q
                    new[i + j] = (new[i + j] - low[i] * r[j]) % Q
            lm, low, hm, high = nm, new, lm, low
        c0inv = pow(low[0], Q - 2, Q)
        return FQ12([x * c0inv % Q for x in lm[:12]])

    def pow(self, e):
        res = FQ12.one()
        base = self
        while e:
            if e & 1:
                res = res * base
            base = base * base
            e >>= 1
        return res


def _twist(pt):
    """Map an affine G2 point (Fq2 coords) onto E(Fq12)."""
    if pt is None:
        return None
    x, y = pt
    nx = FQ12.from_fq2(x)
    ny = FQ12.from_fq2(y)
    w2 = FQ12([0, 0, 1] + [0] * 9)
    w3 = FQ12([0, 0, 0, 1] + [0] * 8)
    return (nx * w2, ny * w3)


def _cast_g1(pt):
    if pt is None:
        return None
    return (FQ12.from_fq(pt[0]), FQ12.from_fq(pt[1]))


def _double(pt):
    x, y = pt
    lam = (x * x * FQ12.from_fq(3)) * (y * FQ12.from_fq(2)).inv()
    nx = lam * lam - x - x
    ny = lam * (x - nx) - y
    return (nx, ny)


def _add(p1, p2):
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2 and y1 == y2:
        return _double(p1)
    lam = (y2 - y1) * (x2 - x1).inv()
    nx = lam * lam - x1 - x2
    ny = lam * (x1 - nx) - y1
    return (nx, ny)


def _linefunc(p1, p2, t):
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = (y2 - y1) * (x2 - x1).inv()
        return m * (xt - x1) - (yt - y1)
    elif y1 == y2:
        m = (x1 * x1 * FQ12.from_fq(3)) * (y1 * FQ12.from_fq(2)).inv()
        return m * (xt - x1) - (yt - y1)
    else:
        return xt - x1


def _frob_fq12(x):
    """x -> x^q on an FQ12-represented coordinate."""
    return x.pow(Q)


def miller_loop(q_pt, p_pt):
    """Miller loop (no final exponentiation) for one (G2, G1) pair given in
    affine python-int coordinates; returns an FQ12 element."""
    if q_pt is None or p_pt is None:
        return FQ12.one()
    Qp = _twist(q_pt)
    Pp = _cast_g1(p_pt)
    R = Qp
    f = FQ12.one()
    for i in range(ATE_LOOP_COUNT.bit_length() - 2, -1, -1):
        f = f * f * _linefunc(R, R, Pp)
        R = _double(R)
        if ATE_LOOP_COUNT & (1 << i):
            f = f * _linefunc(R, Qp, Pp)
            R = _add(R, Qp)
    Q1 = (_frob_fq12(Qp[0]), _frob_fq12(Qp[1]))
    nQ2 = (_frob_fq12(Q1[0]), -_frob_fq12(Q1[1]))
    f = f * _linefunc(R, Q1, Pp)
    R = _add(R, Q1)
    f = f * _linefunc(R, nQ2, Pp)
    return f


def final_exponentiation(f):
    return f.pow(_FINAL_EXP)


def pairing(q_pt, p_pt):
    """Full pairing e(P, Q) with P in G1, Q in G2 (note the arg order:
    (g2_point, g1_point) like py-style Miller loops)."""
    return final_exponentiation(miller_loop(q_pt, p_pt))


def multi_pairing_is_one(pairs):
    """Check prod e(P_i, Q_i) == 1 for pairs [(g1_pt, g2_pt), ...] — the shape
    of ark's `Bn254::multi_pairing(...) == Fp12::one()` and precompile 0x08."""
    f = FQ12.one()
    for g1_pt, g2_pt in pairs:
        f = f * miller_loop(g2_pt, g1_pt)
    return final_exponentiation(f) == FQ12.one()
