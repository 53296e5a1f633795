"""Readers for uzkge's published parameter files: the unchecked SRS
container (kzg_poly_commitment.rs:206-264) and the bincode of
`VerifierParamsSplitSpecific` (gen_params/mod.rs:85-92), whose verifier key
the reference verifier takes.  The files are the program's inputs as
published; nothing here reads what the program made."""

from types import SimpleNamespace

from .bn254 import Q_MOD, R_MOD, g1_on_curve

_INF, _NEG = 1 << 6, 1 << 7


class Bytes:
    def __init__(self, data: bytes):
        self.data, self.off = data, 0

    def take(self, n: int) -> bytes:
        b = self.data[self.off:self.off + n]
        if len(b) != n:
            raise ValueError("truncated parameter file")
        self.off += n
        return b

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "little")

    def u64_vec(self):
        return [self.u64() for _ in range(self.u64())]

    def blob(self) -> "Bytes":
        return Bytes(self.take(self.u64()))

    def fr(self) -> int:
        v = int.from_bytes(self.take(32), "little")
        if v >= R_MOD:
            raise ValueError("non-canonical Fr")
        return v

    def fr_vec(self):
        return [self.fr() for _ in range(self.u64())]

    def fr_vec_vec(self):
        return [self.fr_vec() for _ in range(self.u64())]

    def g1_compressed(self):
        b = self.take(32)
        top = b[31]
        if top & _INF:
            return None
        x = int.from_bytes(b[:31] + bytes([top & 0x3F]), "little")
        y = pow((x * x * x + 3) % Q_MOD, (Q_MOD + 1) // 4, Q_MOD)
        if (y * y - x * x * x - 3) % Q_MOD:
            raise ValueError("compressed G1 x off the curve")
        if (y > Q_MOD - y) != bool(top & _NEG):
            y = Q_MOD - y
        return (x, y)

    def done(self):
        if self.off != len(self.data):
            raise ValueError("trailing bytes in parameter file")


def g1_uncompressed(b: bytes):
    """ark's 64-byte G1: x, y little-endian, the flags in byte 63."""
    if b[63] & _INF:
        return None
    p = (int.from_bytes(b[:32], "little"), int.from_bytes(b[32:63] + bytes([b[63] & 0x3F]), "little"))
    if not g1_on_curve(p):
        raise ValueError("SRS point off the curve")
    return p


def g2_uncompressed(b: bytes):
    c = [int.from_bytes(b[i:i + 32], "little") for i in (0, 32, 64)]
    c.append(int.from_bytes(b[96:127] + bytes([b[127] & 0x3F]), "little"))
    return ((c[0], c[1]), (c[2], c[3]))


class SRS:
    """An unchecked SRS container: u32 len1 | u32 len2 | len1 G1 | len2 G2.
    G1 points are read on demand."""

    def __init__(self, data: bytes):
        self.data = data
        self.len1 = int.from_bytes(data[0:4], "little")
        self.len2 = int.from_bytes(data[4:8], "little")

    def g1(self, i: int):
        if not 0 <= i < self.len1:
            raise IndexError(i)
        return g1_uncompressed(self.data[8 + 64 * i:8 + 64 * (i + 1)])

    def g2(self, i: int):
        off = 8 + 64 * self.len1 + 128 * i
        return g2_uncompressed(self.data[off:off + 128])


def _commitment(r: Bytes):
    a = r.blob()
    p = a.g1_compressed()
    a.done()
    return p


def _fr_blob(r: Bytes) -> int:
    a = r.blob()
    v = a.fr()
    a.done()
    return v


def verifier_key(data: bytes, with_shuffle: bool, g1_gen):
    """The verifier key of a `vk-specific*.bin` file, the constraint system
    before it skipped, as a namespace for plonk.pairing_inputs."""
    r = Bytes(data)
    r.blob()  # selectors (empty in a verifier-only system)
    for _ in range(5):
        r.u64_vec()  # wiring
    for _ in range(1 + 6 + 2 + 2):  # edwards_a, shuffle windows, Anemoi keys and generators
        r.blob()
    r.u64_vec()  # anemoi_constraints_indices
    r.u64()
    r.u64()
    r.u64()  # n_iteration_shuffle_scalar_mul, num_vars, size
    for _ in range(3):
        r.u64_vec()
    r.blob()  # shuffle_remark_constraint_indices
    r.take(1)  # verifier_only
    r.blob()  # witness

    vk = {"cm_q_vec": [_commitment(r) for _ in range(r.u64())],
          "cm_s_vec": [_commitment(r) for _ in range(r.u64())],
          "cm_qb": _commitment(r),
          "cm_prk_vec": [_commitment(r) for _ in range(r.u64())]}
    if with_shuffle:
        vk["cm_q_ecc"] = _commitment(r)
        vk["cm_shuffle_generator_vec"] = [_commitment(r) for _ in range(r.u64())]
        vk["cm_shuffle_public_key_vec"] = [_commitment(r) for _ in range(r.u64())]
    vk["anemoi_generator"] = _fr_blob(r)
    vk["anemoi_generator_inv"] = _fr_blob(r)
    a = r.blob()
    vk["k"] = a.fr_vec()
    a.done()
    vk["edwards_a"] = _fr_blob(r) if with_shuffle else 0
    vk["cs_size"] = r.u64()
    vk["public_vars_constraint_indices"] = r.u64_vec()
    a = r.blob()
    vk["lagrange_constants"] = a.fr_vec()
    a.done()
    r.done()
    return SimpleNamespace(with_shuffle=with_shuffle, g1=g1_gen, **vk)
