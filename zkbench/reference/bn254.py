"""BN254 (alt_bn128): the two fields, G1 in Jacobian coordinates, and the
optimal-ate pairing check of EIP-197 in pure Python.

G1 points cross this module's interface as affine (x, y) int pairs, None
for the identity; G2 points as ((x.c0, x.c1), (y.c0, y.c1)).  The pairing
is a copy of the program's `pcs/pairing.py` (Fq12 = Fq[w]/(w^12 - 18 w^6 +
82), the Miller loop over 6x + 2 with its two Frobenius lines, the final
exponentiation as one power), kept here so that the yardstick does not move
with the program.
"""

R_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617
Q_MOD = 21888242871839275222246405745257275088696311157297823662689037894645226208583
BN_X = 4965661367192848881
ATE_LOOP_COUNT = 6 * BN_X + 2
G1_GEN = (1, 2)
G2_GEN = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)


def fr_root_of_unity(n: int) -> int:
    """The generator of the order-n subgroup of Fr* that ark's
    Radix2EvaluationDomain takes: 5^((r - 1) / 2^28) raised to 2^28 / n."""
    root = pow(5, (R_MOD - 1) >> 28, R_MOD)
    return pow(root, (1 << 28) // n, R_MOD)


# ------------------------------------------------------------- G1, Jacobian

def _jac(p):
    return (0, 1, 0) if p is None else (p[0], p[1], 1)


def _jdbl(P):
    X, Y, Z = P
    if Z == 0 or Y == 0:
        return (0, 1, 0)
    q = Q_MOD
    A = X * X % q
    B = Y * Y % q
    C = B * B % q
    D = 2 * ((X + B) * (X + B) - A - C) % q
    E = 3 * A % q
    X3 = (E * E - 2 * D) % q
    Y3 = (E * (D - X3) - 8 * C) % q
    Z3 = 2 * Y * Z % q
    return (X3, Y3, Z3)


def _jadd(P, R):
    X1, Y1, Z1 = P
    X2, Y2, Z2 = R
    if Z1 == 0:
        return R
    if Z2 == 0:
        return P
    q = Q_MOD
    Z1Z1 = Z1 * Z1 % q
    Z2Z2 = Z2 * Z2 % q
    U1 = X1 * Z2Z2 % q
    U2 = X2 * Z1Z1 % q
    S1 = Y1 * Z2 % q * Z2Z2 % q
    S2 = Y2 * Z1 % q * Z1Z1 % q
    if U1 == U2:
        return _jdbl(P) if S1 == S2 else (0, 1, 0)
    H = (U2 - U1) % q
    Rr = (S2 - S1) % q
    HH = H * H % q
    HHH = H * HH % q
    V = U1 * HH % q
    X3 = (Rr * Rr - HHH - 2 * V) % q
    Y3 = (Rr * (V - X3) - S1 * HHH) % q
    Z3 = Z1 * Z2 % q * H % q
    return (X3, Y3, Z3)


def _affine(P):
    X, Y, Z = P
    if Z == 0:
        return None
    q = Q_MOD
    zi = pow(Z, q - 2, q)
    zi2 = zi * zi % q
    return (X * zi2 % q, Y * zi2 % q * zi % q)


def g1_on_curve(p) -> bool:
    return p is None or (p[1] * p[1] - p[0] ** 3 - 3) % Q_MOD == 0


def g1_neg(p):
    return None if p is None else (p[0], (-p[1]) % Q_MOD)


def g1_add(p, r):
    return _affine(_jadd(_jac(p), _jac(r)))


def _jmul(P, k: int):
    acc = (0, 1, 0)
    for bit in bin(k)[2:]:
        acc = _jdbl(acc)
        if bit == "1":
            acc = _jadd(acc, P)
    return acc


def g1_mul(p, k: int):
    k %= R_MOD
    if p is None or k == 0:
        return None
    return _affine(_jmul(_jac(p), k))


def g1_msm(points, scalars, c: int = 5):
    """sum_i s_i * P_i by buckets of c-bit digits (Pippenger)."""
    pairs = [(_jac(p), s % R_MOD) for p, s in zip(points, scalars)
             if p is not None and s % R_MOD]
    if not pairs:
        return None
    acc = (0, 1, 0)
    mask = (1 << c) - 1
    for w in range((254 + c - 1) // c - 1, -1, -1):
        for _ in range(c):
            acc = _jdbl(acc)
        buckets = [None] * (mask + 1)
        for P, s in pairs:
            d = (s >> (w * c)) & mask
            if d:
                buckets[d] = P if buckets[d] is None else _jadd(buckets[d], P)
        run, tot = (0, 1, 0), (0, 1, 0)
        for d in range(mask, 0, -1):
            if buckets[d] is not None:
                run = _jadd(run, buckets[d])
            tot = _jadd(tot, run)
        acc = _jadd(acc, tot)
    return _affine(acc)


# ------------------------------------------------------------ the pairing

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
