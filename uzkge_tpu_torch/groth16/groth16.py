"""Groth16 over BN254 with device-side proving MSMs.

Protocol parity target: ark-groth16 as used by the reference's reveal path
(shuffle/src/sdk.rs:287-326, reveal_with_snark.rs) and the
deployed `Groth16Verifier.sol` (contracts/solidity/contracts/verifier/
Groth16Verifier.sol:50).  The QAP instance map is the standard libsnark/ark
one: domain size >= num_constraints + num_instance + 1, with one extra row
`<A_i, z> = z_i` per instance variable (including ONE) so instance A-polys
are linearly independent.

Counterpart of `uzkge_tpu/groth16/groth16.py`.  On the card (the default,
see device.py::resolve) the prover's G1 MSMs (a/b/h/l queries) run on the
port's Pippenger (msm/msm.py: msm_bucket_accumulate, msm_bucket_reduce); the
quotient h(X) is produced by NTTDomain's ntt_pass (iNTT -> coset NTT ->
pointwise -> coset iNTT, ark_prove.py::coset_quotient), exactly the round-3
shape of the PLONK prover.  G2 work (one small MSM per proof), the setup and
the verifier stay on host.  With device="cpu" the same code runs the
kernels' plain versions.
"""

from dataclasses import dataclass, field
from typing import List, Optional

from ..constants.bn254 import (
    R_MOD,
    G1_GENERATOR,
    G2_GENERATOR_X,
    G2_GENERATOR_Y,
)
from ..curve.bn254 import g1_add, g1_neg, g2_add
from ..device import resolve
from ..ff.host_field import Fr
from ..pcs.pairing import multi_pairing_is_one
from ..utils.chacha import ChaCha20Rng
from ..utils.stagetimer import stage
from .ark_prove import coset_quotient, device_g1_msm
from .r1cs import R1CS

P = R_MOD
G2_GENERATOR = (G2_GENERATOR_X, G2_GENERATOR_Y)


# --------------------------------------------------------------------------
# host fixed-base scalar multiplication (setup-time; shared window tables)
# --------------------------------------------------------------------------


class FixedBaseTable:
    """Windowed fixed-base multiplier: one table, many scalars.

    table[k][d-1] = d * 2^(w*k) * base for d in 1..2^w-1.  A 254-bit scalar
    costs <= ceil(254/w) curve additions.
    """

    def __init__(self, base, add_fn, w: int = 8, bits: int = 254):
        self.add = add_fn
        self.w = w
        self.windows = (bits + w - 1) // w
        self.table = []
        cur = base
        for _ in range(self.windows):
            row = [cur]
            for _ in range(2**w - 2):
                row.append(add_fn(row[-1], cur))
            self.table.append(row)
            # cur <<= w
            for _ in range(w):
                cur = add_fn(cur, cur)

    def mul(self, scalar: int):
        scalar %= P
        acc = None
        k = 0
        while scalar:
            d = scalar & ((1 << self.w) - 1)
            if d:
                acc = self.add(acc, self.table[k][d - 1])
            scalar >>= self.w
            k += 1
        return acc


def g2_msm(points, scalars):
    """Host Pippenger over G2 (c=8) — one small MSM per proof."""
    pairs = [(p, s % P) for p, s in zip(points, scalars) if p is not None and s % P]
    if not pairs:
        return None
    c = 8
    nwin = (254 + c - 1) // c
    acc = None
    for win in reversed(range(nwin)):
        if acc is not None:
            for _ in range(c):
                acc = g2_add(acc, acc)
        buckets = {}
        shift = win * c
        for p, s in pairs:
            d = (s >> shift) & ((1 << c) - 1)
            if d:
                buckets[d] = g2_add(buckets.get(d), p)
        # descending bucket sweep: sum_d d * bucket[d]
        running = None
        wsum = None
        top = max(buckets.keys(), default=0)
        for d in range(top, 0, -1):
            if d in buckets:
                running = g2_add(running, buckets[d])
            if running is not None:
                wsum = g2_add(wsum, running)
        acc = g2_add(acc, wsum)
    return acc


# --------------------------------------------------------------------------
# keys and proof
# --------------------------------------------------------------------------


@dataclass
class Groth16Vk:
    alpha_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g2: tuple
    gamma_abc_g1: List[Optional[tuple]]  # len = num_instance + 1


@dataclass
class Groth16Pk:
    vk: Groth16Vk
    beta_g1: tuple
    delta_g1: tuple
    a_query: List[Optional[tuple]]  # len = num_vars
    b_g1_query: List[Optional[tuple]]
    b_g2_query: List[Optional[tuple]]
    h_query: List[Optional[tuple]]  # len = domain - 1
    l_query: List[Optional[tuple]]  # len = num_witness
    domain_size: int = 0
    num_instance: int = 0
    _msm_cache: dict = field(default_factory=dict, repr=False)

    def msm(self, name, points, scalars, device=None):
        """<scalars, points> by the port's Pippenger on `device` (the card by
        default) over the non-identity points, the bases cached per (name,
        device)."""
        return device_g1_msm(self._msm_cache, name, points, scalars, resolve(device))


@dataclass
class Groth16Proof:
    a: tuple  # G1
    b: tuple  # G2
    c: tuple  # G1

    def to_solidity_words(self):
        """[a.x, a.y, b.x.c1, b.x.c0, b.y.c1, b.y.c0, c.x, c.y] — the
        uint256[8] layout of `verifyProof` (sdk.rs:306-317)."""
        ax, ay = self.a
        (bx0, bx1), (by0, by1) = self.b
        cx, cy = self.c
        return [ax, ay, bx1, bx0, by1, by0, cx, cy]

    @classmethod
    def from_solidity_words(cls, w):
        assert len(w) == 8
        return cls(
            a=(w[0], w[1]), b=((w[3], w[2]), (w[5], w[4])), c=(w[6], w[7])
        )


# --------------------------------------------------------------------------
# QAP evaluation shared by setup and prove
# --------------------------------------------------------------------------


def _domain_size(cs: R1CS) -> int:
    need = cs.num_constraints + cs.num_instance + 1
    m = 1
    while m < need:
        m <<= 1
    return m


def _constraint_evals(cs: R1CS, assignment):
    """Per-row <A,z>, <B,z>, <C,z> including the instance-map extra rows."""
    def ev(lc):
        return sum(c * assignment[v] for v, c in lc.items()) % P

    a = [ev(A) for A, _, _ in cs.constraints]
    b = [ev(B) for _, B, _ in cs.constraints]
    c = [ev(C) for _, _, C in cs.constraints]
    # instance map rows: A picks out the instance variable, B = C = 0
    for i in range(cs.num_instance + 1):
        a.append(assignment[i])
        b.append(0)
        c.append(0)
    return a, b, c


# --------------------------------------------------------------------------
# setup
# --------------------------------------------------------------------------


def setup(cs: R1CS, seed: bytes = b"uzkge-tpu groth16 setup") -> Groth16Pk:
    """Deterministic trusted setup for the circuit shape of `cs`.

    NOTE: a production deployment replaces this with an MPC ceremony; the key
    format matches ark-groth16's ProvingKey so artifacts interoperate.
    """
    cs = cs.canonicalized()
    rng = ChaCha20Rng(seed.ljust(32, b"\0")[:32])

    def fr_rand():
        while True:
            v = int.from_bytes(rng.fill_bytes(32), "little") % P
            if v:
                return v

    m = _domain_size(cs)
    omega = Fr.root_of_unity(m)
    tau = fr_rand()
    while pow(tau, m, P) == 1:  # Z(tau) must not vanish
        tau = fr_rand()
    alpha, beta, gamma, delta = fr_rand(), fr_rand(), fr_rand(), fr_rand()
    gamma_inv = pow(gamma, P - 2, P)
    delta_inv = pow(delta, P - 2, P)
    z_tau = (pow(tau, m, P) - 1) % P

    # lagrange basis at tau: l_j(tau) = (Z(tau)/m) * w^j / (tau - w^j)
    pows = [1] * m
    for j in range(1, m):
        pows[j] = pows[j - 1] * omega % P
    denoms = Fr.batch_inv([(tau - wj) % P for wj in pows])
    zm = z_tau * pow(m, P - 2, P) % P
    ell = [zm * pows[j] % P * denoms[j] % P for j in range(m)]

    # u_i(tau), v_i(tau), w_i(tau) by sparse column accumulation
    nv = cs.num_vars
    u = [0] * nv
    v = [0] * nv
    w = [0] * nv
    for j, (A, B, C) in enumerate(cs.constraints):
        lj = ell[j]
        for var, coeff in A.items():
            u[var] = (u[var] + coeff * lj) % P
        for var, coeff in B.items():
            v[var] = (v[var] + coeff * lj) % P
        for var, coeff in C.items():
            w[var] = (w[var] + coeff * lj) % P
    nc = cs.num_constraints
    for i in range(cs.num_instance + 1):  # instance map rows
        u[i] = (u[i] + ell[nc + i]) % P

    t_g1 = FixedBaseTable(G1_GENERATOR, g1_add)
    t_g2 = FixedBaseTable(G2_GENERATOR, g2_add)

    def g1s(scalars):
        return [t_g1.mul(s) if s % P else None for s in scalars]

    ninst = cs.num_instance
    abc = [
        (beta * u[i] + alpha * v[i] + w[i]) % P * gamma_inv % P
        for i in range(ninst + 1)
    ]
    lq = [
        (beta * u[i] + alpha * v[i] + w[i]) % P * delta_inv % P
        for i in range(ninst + 1, nv)
    ]
    hq = []
    tp = z_tau * delta_inv % P
    for _ in range(m - 1):
        hq.append(tp)
        tp = tp * tau % P

    vk = Groth16Vk(
        alpha_g1=t_g1.mul(alpha),
        beta_g2=t_g2.mul(beta),
        gamma_g2=t_g2.mul(gamma),
        delta_g2=t_g2.mul(delta),
        gamma_abc_g1=g1s(abc),
    )
    return Groth16Pk(
        vk=vk,
        beta_g1=t_g1.mul(beta),
        delta_g1=t_g1.mul(delta),
        a_query=g1s(u),
        b_g1_query=g1s(v),
        b_g2_query=[t_g2.mul(s) if s % P else None for s in v],
        h_query=g1s(hq),
        l_query=g1s(lq),
        domain_size=m,
        num_instance=ninst,
    )


# --------------------------------------------------------------------------
# prove / verify
# --------------------------------------------------------------------------


def _h_coefficients(cs: R1CS, assignment, m: int, device):
    """h(X) = (A(X)B(X) - C(X)) / Z(X) via NTTs on `device` on the coset k*H."""
    a, b, c = _constraint_evals(cs, assignment)
    pad = [0] * (m - len(a))
    return coset_quotient([a + pad, b + pad, c + pad], m, device)[: m - 1]


def prove(pk: Groth16Pk, cs: R1CS, rng: Optional[ChaCha20Rng] = None,
          device=None) -> Groth16Proof:
    """Prove a satisfied R1CS.  cs must carry the full assignment and have the
    same circuit shape the pk was set up for.  The NTTs and G1 MSMs run on
    `device` (the card by default)."""
    dev = resolve(device)
    assert cs.is_satisfied(), "witness does not satisfy the constraint system"
    cs = cs.canonicalized()
    z = cs.assignment
    assert len(z) == len(pk.a_query), "circuit shape differs from proving key"
    if rng is None:
        rng = ChaCha20Rng(b"\x42" * 32)
    r = int.from_bytes(rng.fill_bytes(32), "little") % P
    s = int.from_bytes(rng.fill_bytes(32), "little") % P

    m = pk.domain_size
    with stage("g16_witness_map"):
        h = _h_coefficients(cs, z, m, dev)

    def g1_msm(name, points, scalars):
        with stage(f"g16_msm_{name}"):
            return pk.msm(name, points, scalars, dev)

    a_acc = g1_msm("a", pk.a_query, z)
    b1_acc = g1_msm("b1", pk.b_g1_query, z)
    h_acc = g1_msm("h", pk.h_query, h)
    wit = z[pk.num_instance + 1 :]
    l_acc = g1_msm("l", pk.l_query, wit)
    with stage("g16_msm_b2_host"):
        b2_acc = g2_msm(pk.b_g2_query, z)

    from ..curve.bn254 import g1_mul

    g_a = g1_add(g1_add(pk.vk.alpha_g1, a_acc), g1_mul(pk.delta_g1, r))
    g_b2 = g2_add(g2_add(pk.vk.beta_g2, b2_acc), _g2_mul(pk.vk.delta_g2, s))
    g_b1 = g1_add(g1_add(pk.beta_g1, b1_acc), g1_mul(pk.delta_g1, s))
    # C = l + h + s*A + r*B1 - rs*delta
    g_c = g1_add(l_acc, h_acc)
    g_c = g1_add(g_c, g1_mul(g_a, s))
    g_c = g1_add(g_c, g1_mul(g_b1, r))
    g_c = g1_add(g_c, g1_neg(g1_mul(pk.delta_g1, r * s % P)))
    return Groth16Proof(a=g_a, b=g_b2, c=g_c)


def _g2_mul(p, k):
    from ..curve.bn254 import g2_mul

    return g2_mul(p, k)


def verify(vk: Groth16Vk, public_inputs: List[int], proof: Groth16Proof) -> bool:
    """e(A,B) == e(alpha,beta) * e(vk_x,gamma) * e(C,delta) — the equation
    checked by Groth16Verifier.sol's single pairing call."""
    assert len(public_inputs) == len(vk.gamma_abc_g1) - 1
    vk_x = vk.gamma_abc_g1[0]
    from ..curve.bn254 import g1_mul

    for x, pt in zip(public_inputs, vk.gamma_abc_g1[1:]):
        if pt is not None and x % P:
            vk_x = g1_add(vk_x, g1_mul(pt, x))
    return multi_pairing_is_one(
        [
            (g1_neg(proof.a), proof.b),
            (vk.alpha_g1, vk.beta_g2),
            (vk_x, vk.gamma_g2),
            (proof.c, vk.delta_g2),
        ]
    )
