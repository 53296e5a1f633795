"""Groth16 proving against the reference's embedded ark proving key.

Implements ark-groth16 0.4's prover pipeline (LibsnarkReduction QAP) for the
reveal circuit synthesized by `ark_r1cs`:

  witness_map (r1cs_to_qap.rs):
      a[i<nc] = <A_i, z>, a[nc+j] = z_j (instance rows); b[i<nc] = <B_i, z>
      ifft -> coset_fft -> ab = a.b pointwise; c likewise;
      h_evals = (ab - c) / (g^n - 1); h = coset_ifft(h_evals)[: n-1]

  prove (prover.rs):
      A  = alpha + <z, a_query>  + r*delta              (G1)
      B  = beta  + <z, b_g2_query> + s*delta            (G2)
      B1 = beta1 + <z, b_g1_query> + s*delta1           (G1)
      C  = <witness, l_query> + <h, h_query> + s*A + r*B1 - r*s*delta1

The verifier check (deployed Groth16Verifier.sol semantics):
      e(A, B) = e(alpha, beta) * e(sum z_i IC_i, gamma) * e(C, delta)

Domain: ark Radix2EvaluationDomain(8192) — omega from the 2-adic root with
GENERATOR = 5; coset generator g = 5.

Counterpart of `uzkge_tpu/groth16/ark_prove.py`, whose prover is host Python
throughout.  Here the witness map's NTTs run through `ntt/ntt.py::NTTDomain`
(the ntt_pass kernel), the four G1 MSMs (a, b1, l, h) through
`msm/msm.py::msm` (msm_bucket_accumulate, msm_bucket_reduce) and the G2
MSM, B with its beta_g2 and s delta_g2 terms, through
`msm/msm_g2.py` (g2_bucket_accumulate, g2_bucket_reduce) on `device`: the
card unless the caller asks for the CPU, where the same code runs the
kernels' plain versions.  The G2 MSM's 32 window sums are combined on the
host, and the pairing stays there.  `prove_tail` (the MSMs and the combine)
serves this prover and the own-shape one (groth16.py::prove) alike.
`HostDomain`, `_pippenger` and `g1_msm_host` are the JAX package's host
code, kept as the oracle.
"""

from typing import Dict, List, Sequence

from ..constants.bn254 import R_MOD, FR_GENERATOR, FR_TWO_ADIC_ROOT_OF_UNITY, FR_TWO_ADICITY
from ..curve.bn254 import g1_add, g1_neg, g1_mul
from ..device import resolve
from ..ff.field import fr
from ..msm.msm import MSMBases, msm
from ..msm.msm_g2 import g2_bases, g2_msm_windows
from ..ntt.ntt import get_domain
from ..pcs.pairing import multi_pairing_is_one
from ..utils.stagetimer import stage
from .ark_pk import ArkGroth16Pk

R = R_MOD


# ----------------------------------------------------------------- host NTT
def _root_of_unity(n: int) -> int:
    assert n & (n - 1) == 0 and n <= (1 << FR_TWO_ADICITY)
    return pow(FR_TWO_ADIC_ROOT_OF_UNITY, (1 << FR_TWO_ADICITY) // n, R)


def _ntt(vals: List[int], omega: int) -> List[int]:
    """Iterative radix-2 DIT NTT, natural order in and out."""
    n = len(vals)
    a = list(vals)
    # bit-reverse permute
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    length = 2
    while length <= n:
        wlen = pow(omega, n // length, R)
        half = length // 2
        for start in range(0, n, length):
            w = 1
            for k in range(start, start + half):
                u, v = a[k], a[k + half] * w % R
                a[k] = (u + v) % R
                a[k + half] = (u - v) % R
                w = w * wlen % R
        length <<= 1
    return a


class HostDomain:
    def __init__(self, n: int):
        self.n = n
        self.omega = _root_of_unity(n)
        self.omega_inv = pow(self.omega, R - 2, R)
        self.n_inv = pow(n, R - 2, R)
        self.g = FR_GENERATOR
        self.g_inv = pow(self.g, R - 2, R)

    def fft(self, coeffs):
        return _ntt(coeffs, self.omega)

    def ifft(self, evals):
        out = _ntt(evals, self.omega_inv)
        return [v * self.n_inv % R for v in out]

    def coset_fft(self, coeffs):
        gk = 1
        scaled = []
        for c in coeffs:
            scaled.append(c * gk % R)
            gk = gk * self.g % R
        return self.fft(scaled)

    def coset_ifft(self, evals):
        coeffs = self.ifft(evals)
        gk = 1
        out = []
        for c in coeffs:
            out.append(c * gk % R)
            gk = gk * self.g_inv % R
        return out


# ------------------------------------------------------------- host Pippenger
#
# Generic jacobian-coordinate Pippenger parameterized by base-field ops, so
# one implementation serves G1 (ints mod q) and G2 (Fq2 pairs).  Jacobian
# avoids the per-addition modular inversion of the affine helpers in
# curve/bn254.py — one inversion per MSM instead of one per add.


class _FieldOps:
    __slots__ = ("mul", "add", "sub", "inv", "zero", "one", "is_zero")

    def __init__(self, mul, add, sub, inv, zero, one, is_zero):
        self.mul, self.add, self.sub, self.inv = mul, add, sub, inv
        self.zero, self.one, self.is_zero = zero, one, is_zero


def _jac_double(F, p):
    x, y, z = p
    if F.is_zero(z):
        return p
    # a = 0 doubling: 2M + 5S
    a = F.mul(x, x)
    b = F.mul(y, y)
    c = F.mul(b, b)
    t = F.add(x, b)
    d = F.sub(F.sub(F.mul(t, t), a), c)
    d = F.add(d, d)
    e = F.add(F.add(a, a), a)
    f = F.mul(e, e)
    x3 = F.sub(f, F.add(d, d))
    c8 = F.add(F.add(F.add(c, c), F.add(c, c)), F.add(F.add(c, c), F.add(c, c)))
    y3 = F.sub(F.mul(e, F.sub(d, x3)), c8)
    z3 = F.mul(F.add(y, y), z)
    return (x3, y3, z3)


def _jac_add(F, p, q):
    x1, y1, z1 = p
    x2, y2, z2 = q
    if F.is_zero(z1):
        return q
    if F.is_zero(z2):
        return p
    z1z1 = F.mul(z1, z1)
    z2z2 = F.mul(z2, z2)
    u1 = F.mul(x1, z2z2)
    u2 = F.mul(x2, z1z1)
    s1 = F.mul(F.mul(y1, z2), z2z2)
    s2 = F.mul(F.mul(y2, z1), z1z1)
    h = F.sub(u2, u1)
    r = F.sub(s2, s1)
    if F.is_zero(h):
        if F.is_zero(r):
            return _jac_double(F, p)
        return (F.one, F.one, F.zero)
    i = F.add(h, h)
    i = F.mul(i, i)
    j = F.mul(h, i)
    r2 = F.add(r, r)
    v = F.mul(u1, i)
    x3 = F.sub(F.sub(F.mul(r2, r2), j), F.add(v, v))
    s1j = F.mul(s1, j)
    y3 = F.sub(F.mul(r2, F.sub(v, x3)), F.add(s1j, s1j))
    z3 = F.sub(F.mul(F.add(z1, z2), F.add(z1, z2)), F.add(z1z1, z2z2))
    z3 = F.mul(z3, h)
    return (x3, y3, z3)


def _jac_mixed_add(F, p, q_affine):
    """p (jacobian) + q (affine, z=1)."""
    x1, y1, z1 = p
    x2, y2 = q_affine
    if F.is_zero(z1):
        return (x2, y2, F.one)
    z1z1 = F.mul(z1, z1)
    u2 = F.mul(x2, z1z1)
    s2 = F.mul(F.mul(y2, z1), z1z1)
    h = F.sub(u2, x1)
    r = F.sub(s2, y1)
    if F.is_zero(h):
        if F.is_zero(r):
            return _jac_double(F, p)
        return (F.one, F.one, F.zero)
    hh = F.mul(h, h)
    i = F.add(F.add(hh, hh), F.add(hh, hh))
    j = F.mul(h, i)
    r2 = F.add(r, r)
    v = F.mul(x1, i)
    x3 = F.sub(F.sub(F.mul(r2, r2), j), F.add(v, v))
    y1j = F.mul(y1, j)
    y3 = F.sub(F.mul(r2, F.sub(v, x3)), F.add(y1j, y1j))
    z3 = F.sub(F.sub(F.mul(F.add(z1, h), F.add(z1, h)), z1z1), hh)
    return (x3, y3, z3)


def _jac_to_affine(F, p):
    x, y, z = p
    if F.is_zero(z):
        return None
    zi = F.inv(z)
    zi2 = F.mul(zi, zi)
    return (F.mul(x, zi2), F.mul(y, F.mul(zi2, zi)))


def _pippenger(points: Sequence, scalars: Sequence[int], F: _FieldOps, c: int = 8):
    """Windowed bucket MSM over affine host points (None = identity)."""
    pairs = [(p, s % R) for p, s in zip(points, scalars) if p is not None and s % R]
    if not pairs:
        return None
    windows = (256 + c - 1) // c
    mask = (1 << c) - 1
    inf = (F.one, F.one, F.zero)
    acc = inf
    for w in range(windows - 1, -1, -1):
        if not F.is_zero(acc[2]):
            for _ in range(c):
                acc = _jac_double(F, acc)
        buckets: Dict[int, tuple] = {}
        shift = w * c
        for p, s in pairs:
            d = (s >> shift) & mask
            if d:
                cur = buckets.get(d)
                buckets[d] = (p[0], p[1], F.one) if cur is None else _jac_mixed_add(F, cur, p)
        if not buckets:
            continue
        running = inf
        win_sum = inf
        for d in range(max(buckets.keys()), 0, -1):
            b = buckets.get(d)
            if b is not None:
                running = _jac_add(F, running, b)
            win_sum = _jac_add(F, win_sum, running)
        acc = _jac_add(F, acc, win_sum)
    return _jac_to_affine(F, acc)


def _g1_ops() -> _FieldOps:
    from ..constants.bn254 import Q_MOD

    q = Q_MOD
    return _FieldOps(
        mul=lambda a, b: a * b % q,
        add=lambda a, b: (a + b) % q,
        sub=lambda a, b: (a - b) % q,
        inv=lambda a: pow(a, q - 2, q),
        zero=0,
        one=1,
        is_zero=lambda a: a == 0,
    )


def _g2_ops() -> _FieldOps:
    from ..curve.bn254 import fq2_add, fq2_sub, fq2_mul, fq2_inv

    return _FieldOps(
        mul=fq2_mul,
        add=fq2_add,
        sub=fq2_sub,
        inv=fq2_inv,
        zero=(0, 0),
        one=(1, 0),
        is_zero=lambda a: a == (0, 0),
    )


_G1F = None


def g1_msm_host(points, scalars):
    global _G1F
    if _G1F is None:
        _G1F = _g1_ops()
    return _pippenger(points, scalars, _G1F)


# ------------------------------------------------------------- device MSMs
def device_g1_msm(cache: dict, name: str, points, scalars, device):
    """<scalars, points> over G1 on `device` by the port's Pippenger, over the
    non-identity points of the query `points` (MSMBases takes no identity);
    their bases are made once (span `g16_msm_bases`) and kept in `cache`
    under (name, device).
    Returns an affine host point, None for the identity."""
    key = (name, str(device))
    cached = cache.get(key)
    if cached is None:
        with stage("g16_msm_bases"):
            idx = [i for i, p in enumerate(points) if p is not None]
            cached = (idx, MSMBases([points[i] for i in idx], device) if idx else None)
        cache[key] = cached
    idx, bases = cached
    if bases is None:
        return None
    return msm(bases, [scalars[i] for i in idx])


def device_g2_msm(cache: dict, name: str, points, scalars, device):
    """<scalars, points> over G2 on `device` by the port's G2 Pippenger
    (msm/msm_g2.py), over the non-identity points of `points`.  Their limbs
    are made once (span `g16_msm_bases`) and kept in `cache` under `name` on
    the host, whatever the device, and copied to the device for each call,
    so that no G2 tensor outlives the call there.  The 32 window sums are combined on
    the host in Jacobian coordinates, sum_w 2^(8w) S_w by Horner's rule, with
    one Fq2 inversion.  Returns an affine host point, None for the identity."""
    cached = cache.get(name)
    if cached is None:
        with stage("g16_msm_bases"):
            idx = [i for i, p in enumerate(points) if p is not None]
            cached = (idx, g2_bases([points[i] for i in idx]) if idx else None)
        cache[name] = cached
    idx, bases = cached
    if bases is None:
        return None
    F = _g2_ops()
    acc = (F.one, F.one, F.zero)
    for x, y, z in reversed(g2_msm_windows(bases, [scalars[i] for i in idx], device)):
        for _ in range(8):
            acc = _jac_double(F, acc)
        # projective (X : Y : Z) is Jacobian (X Z, Y Z^2, Z)
        acc = _jac_add(F, acc, (F.mul(x, z), F.mul(y, F.mul(z, z)), z))
    return _jac_to_affine(F, acc)


# ----------------------------------------------------------------- witness map
def _row_evals(rows, assignment, domain_n):
    out = [0] * domain_n
    for i, row in enumerate(rows):
        acc = 0
        for col, coeff in row.items():
            acc += coeff * assignment[col]
        out[i] = acc % R
    return out


def coset_quotient(evals: List[List[int]], domain_n: int, device) -> List[int]:
    """h = coset_ifft((A·B − C) / Z) on the coset g·H, g = FR_GENERATOR, of the
    three rows of evaluations over H (A, B, C), through NTTDomain on
    `device`: ifft_batch, coset_fft_batch, the pointwise step with the port's
    fr ops (Z = g^n − 1 is constant on the coset), coset_ifft.  Returns the
    n coefficients as python ints."""
    dom = get_domain(domain_n, device)
    rows = fr.to_mont_limbs([v for row in evals for v in row], dom.device).reshape(3, domain_n, 8)
    coset = dom.coset_fft_batch(dom.ifft_batch(rows), FR_GENERATOR)
    z_inv = pow((pow(FR_GENERATOR, domain_n, R) - 1) % R, R - 2, R)
    h_evals = fr.mul(fr.sub(fr.mul(coset[0], coset[1]), coset[2]),
                     fr.to_mont_limbs(z_inv, dom.device))
    return fr.from_mont_limbs(dom.coset_ifft(h_evals, FR_GENERATOR).cpu())


def qap_witness_map(
    a_rows: List[Dict[int, int]],
    b_rows: List[Dict[int, int]],
    c_rows: List[Dict[int, int]],
    assignment: List[int],
    num_instance: int,
    domain_n: int,
    device=None,
) -> List[int]:
    """h coefficients (len n-1) per LibsnarkReduction::witness_map, the NTTs
    on `device` (the card by default, see device.py::resolve).  Spans:
    `g16_rows_host` (the rows' sums on the host), `g16_qap_device`
    (coset_quotient, from the upload of the rows to h on the host)."""
    dev = resolve(device)
    nc = len(a_rows)
    with stage("g16_rows_host"):
        a = _row_evals(a_rows, assignment, domain_n)
        for j in range(num_instance):
            a[nc + j] = assignment[j]
        b = _row_evals(b_rows, assignment, domain_n)
        c = _row_evals(c_rows, assignment, domain_n)
    with stage("g16_qap_device"):
        h = coset_quotient([a, b, c], domain_n, dev)
    assert h[domain_n - 1] == 0, "QAP division remainder: matrices do not match"
    return h[: domain_n - 1]


# ----------------------------------------------------------------------- prove
def groth16_prove_with_pk(
    pk: ArkGroth16Pk,
    matrices,
    assignment: List[int],
    num_instance: int,
    r: int,
    s: int,
    device=None,
):
    """Produce (A_g1, B_g2, C_g1) for the assignment under the parsed ark pk,
    the witness map and the MSMs on `device` (the card by default)."""
    dev = resolve(device)
    a_rows, b_rows, c_rows = matrices
    with stage("g16_witness_map"):
        h = qap_witness_map(a_rows, b_rows, c_rows, assignment, num_instance, pk.domain_size,
                            dev)
    return prove_tail(pk, assignment, assignment[num_instance:], h, r, s, dev)


def prove_tail(pk, z: List[int], wit: List[int], h: List[int], r: int, s: int, device):
    """(A_g1, B_g2, C_g1) of a Groth16 proof from the assignment z, its
    witness slice `wit` (the l_query's scalars), the quotient's coefficients
    h and the blinders r, s, under a key `pk` of either shape: it reads
    vk.alpha_g1, vk.beta_g2, vk.delta_g2, beta_g1, delta_g1, the five
    queries and the MSM cache _msm_cache.  The four G1 MSMs and the G2 MSM
    run on `device`, each in its span; the combine runs on the host."""

    def g1_msm(name, points, scalars):
        with stage(f"g16_msm_{name}"):
            return device_g1_msm(pk._msm_cache, name, points, scalars, device)

    a_acc = g1_msm("a", pk.a_query, z)
    b1_acc = g1_msm("b1", pk.b_g1_query, z)
    l_acc = g1_msm("l", pk.l_query, wit)
    h_acc = g1_msm("h", pk.h_query, h)
    # the span keeps its name (the benchmark reads it) though the MSM runs on
    # `device`: from the scalars' upload to the affine B
    with stage("g16_msm_b2_host"):
        B = device_g2_msm(pk._msm_cache, "b2", pk.b_g2_query + [pk.vk.beta_g2, pk.vk.delta_g2],
                          z + [1, s], device)

    with stage("g16_combine_host"):
        A = g1_add(pk.vk.alpha_g1, a_acc)
        A = g1_add(A, g1_mul(pk.delta_g1, r))

        B1 = g1_add(pk.beta_g1, b1_acc)
        B1 = g1_add(B1, g1_mul(pk.delta_g1, s))

        C = g1_add(l_acc, h_acc)
        C = g1_add(C, g1_mul(A, s))
        C = g1_add(C, g1_mul(B1, r))
        C = g1_add(C, g1_neg(g1_mul(pk.delta_g1, r * s % R)))
    return A, B, C


def groth16_verify_with_vk(vk, proof, public_inputs: List[int]) -> bool:
    """e(A,B) e(-alpha,beta) e(-IC,gamma) e(-C,delta) == 1."""
    A, B, C = proof
    ic = vk.gamma_abc_g1[0]
    for base, val in zip(vk.gamma_abc_g1[1:], public_inputs):
        ic = g1_add(ic, g1_mul(base, val))
    return multi_pairing_is_one(
        [
            (A, B),
            (g1_neg(vk.alpha_g1), vk.beta_g2),
            (g1_neg(ic), vk.gamma_g2),
            (g1_neg(C), vk.delta_g2),
        ]
    )
