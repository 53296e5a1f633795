"""Host-side (python-int) prime field arithmetic for BN254 Fr / Fq.

This is the *orchestration / witness-generation* layer: field elements are
plain python ints in [0, p).  It is deliberately tiny — the TPU compute path
lives in `uzkge_tpu.ff.jax_field` (limb-vectorized Montgomery kernels) and is
tested against this layer.

Reference semantics: ark-ff `Fp256<MontBackend<...>>` as used throughout
the reference's uzkge/src (values compared in the standard domain).
"""

from ..constants.bn254 import R_MOD, Q_MOD, FR_TWO_ADICITY, FR_TWO_ADIC_ROOT_OF_UNITY


class PrimeField:
    """A prime field context: stateless helpers over python ints."""

    def __init__(self, modulus: int, two_adicity: int = 0, two_adic_root: int = 0):
        self.p = modulus
        self.two_adicity = two_adicity
        self.two_adic_root = two_adic_root
        self.bits = modulus.bit_length()
        self.nbytes = (self.bits + 7) // 8

    def add(self, a, b):
        return (a + b) % self.p

    def mul(self, a, b):
        return (a * b) % self.p

    def neg(self, a):
        return (-a) % self.p

    def inv(self, a):
        if a % self.p == 0:
            raise ZeroDivisionError("field inverse of zero")
        return pow(a, self.p - 2, self.p)

    def pow(self, a, e):
        return pow(a, e, self.p)

    def batch_inv(self, xs):
        """Montgomery's trick, mirrors ark-ff `batch_inversion`
        (zeros are passed through unchanged, like ark's behavior of skipping
        them is NOT replicated — reference never batch-inverts zeros)."""
        n = len(xs)
        prefix = [1] * (n + 1)
        for i, x in enumerate(xs):
            prefix[i + 1] = prefix[i] * x % self.p
        inv_all = self.inv(prefix[n])
        out = [0] * n
        for i in range(n - 1, -1, -1):
            out[i] = prefix[i] * inv_all % self.p
            inv_all = inv_all * xs[i] % self.p
        return out

    def root_of_unity(self, n: int) -> int:
        """2^k-th root of unity for domain size n, exactly as ark-poly's
        `Radix2EvaluationDomain::new` computes `group_gen`."""
        assert n & (n - 1) == 0 and n > 0
        log_n = n.bit_length() - 1
        assert log_n <= self.two_adicity, f"no 2^{log_n} root of unity"
        return pow(self.two_adic_root, 1 << (self.two_adicity - log_n), self.p)

    def to_bytes_be(self, a: int) -> bytes:
        return int(a % self.p).to_bytes(32, "big")

    def legendre_is_qr(self, a: int) -> bool:
        return pow(a, (self.p - 1) // 2, self.p) == 1

    def sqrt(self, a: int):
        """Tonelli-Shanks square root; returns None if a is a non-residue."""
        a %= self.p
        if a == 0:
            return 0
        if not self.legendre_is_qr(a):
            return None
        p = self.p
        q = p - 1
        s = 0
        while q % 2 == 0:
            q //= 2
            s += 1
        # find a non-residue z
        z = 2
        while pow(z, (p - 1) // 2, p) != p - 1:
            z += 1
        m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
        while t != 1:
            i, tt = 0, t
            while tt != 1:
                tt = tt * tt % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, b * b % p
            t = t * c % p
            r = r * b % p
        return r


Fr = PrimeField(R_MOD, FR_TWO_ADICITY, FR_TWO_ADIC_ROOT_OF_UNITY)
Fq = PrimeField(Q_MOD)
