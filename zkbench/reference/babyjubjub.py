"""BabyJubjub, the twisted Edwards curve a x^2 + y^2 = 1 + d x^2 y^2 over
BN254's Fr with ark-ed-on-bn254's a = 1, d = 168696 / 168700, in extended
coordinates.  Points cross the interface as affine (x, y); (0, 1) is the
identity."""

from .bn254 import R_MOD as P

A = 1
D = 168696 * pow(168700, P - 2, P) % P
ORDER = 2736030358979909402780800718157159386076813972158567259200215660948447373041
GENERATOR = (19698561148652590122159747500897617769866003486955115824547446575314762165298,
             19298250018296453272277890825869354524455968081175474282777126169995084727839)
IDENTITY = (0, 1)


def _ext(p):
    x, y = p
    return (x, y, 1, x * y % P)


def _add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = x1 * x2 % P
    b = y1 * y2 % P
    c = D * t1 % P * t2 % P
    d = z1 * z2 % P
    e = ((x1 + y1) * (x2 + y2) - a - b) % P
    f = (d - c) % P
    g = (d + c) % P
    h = (b - A * a) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _affine(p):
    x, y, z, _ = p
    zi = pow(z, P - 2, P)
    return (x * zi % P, y * zi % P)


def add(p, q):
    return _affine(_add(_ext(p), _ext(q)))


def neg(p):
    return ((-p[0]) % P, p[1])


def mul(p, k: int):
    acc = (0, 1, 1, 0)
    base = _ext(p)
    for bit in bin(k % ORDER)[2:]:
        acc = _add(acc, acc)
        if bit == "1":
            acc = _add(acc, base)
    return _affine(acc)


def on_curve(p) -> bool:
    x, y = p
    return (A * x * x + y * y - 1 - D * x * x % P * y % P * y) % P == 0


def windows(base, iterations: int, width: int = 4):
    """[[m * 16^i * base for m in 1..width] for i < iterations]: the window
    tables of the remark walk (uzkge shuffle/remark.rs:39-84)."""
    out = []
    g = _ext(base)
    for _ in range(iterations):
        seg, cur = [], g
        for _ in range(width):
            seg.append(cur)
            cur = _add(cur, g)
        out.append([_affine(s) for s in seg])
        for _ in range(width):
            g = _add(g, g)
    return out
