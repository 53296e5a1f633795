"""Byte-exact codecs for the reference's wire formats.

Covers:
  * big-endian scalar/point codecs used by proofs and the Solidity verifier
    (uzkge/src/utils/serialization.rs:62-111, plonk/indexer.rs:539-732);
  * arkworks canonical (de)serialization for BN254 G1/G2/Fr (LE, flags in the
    top bits of the last byte);
  * the unchecked SRS container (kzg_poly_commitment.rs:206-264);
  * a minimal bincode-1.x reader for the embedded vk bins
    (uzkge/src/gen_params/mod.rs, shuffle/src/gen_params/mod.rs).
"""

from ..errors import DeserializationError, MissingSRSError
from ..constants.bn254 import Q_MOD, R_MOD
from ..ff.host_field import Fq

_INF_FLAG = 1 << 6
_NEG_FLAG = 1 << 7

# ---------------------------------------------------------------------------
# Big-endian formats (transcript/proof/Solidity facing)
# ---------------------------------------------------------------------------


def scalar_to_bytes_be(v: int) -> bytes:
    return int(v).to_bytes(32, "big")


def scalar_from_bytes_be(b: bytes, modulus: int = R_MOD) -> int:
    return int.from_bytes(b, "big") % modulus


def point_to_uncompress_be(p) -> bytes:
    """Affine G1/Edwards point -> BE x || BE y (64 bytes); identity -> zeros
    (matches `point_to_uncompress_be`, serialization.rs:62-69)."""
    if p is None:
        return b"\x00" * 64
    x, y = p
    return int(x).to_bytes(32, "big") + int(y).to_bytes(32, "big")


def g1_from_uncompress_be(b: bytes):
    """BE x || y -> affine G1 point (None for the all-zero encoding)."""
    if len(b) != 64:
        raise DeserializationError(f"G1 uncompressed needs 64 bytes, got {len(b)}")
    x = int.from_bytes(b[:32], "big")
    y = int.from_bytes(b[32:], "big")
    if x == 0 and y == 0:
        return None
    if (y * y - x * x * x - 3) % Q_MOD != 0:
        raise DeserializationError("point not on BN254 G1")
    return (x, y)


def edwards_from_uncompress_be(b: bytes):
    if len(b) != 64:
        raise DeserializationError(f"point needs 64 bytes, got {len(b)}")
    x = int.from_bytes(b[:32], "big")
    y = int.from_bytes(b[32:], "big")
    return (x, y)


# ---------------------------------------------------------------------------
# arkworks canonical formats (little-endian + flag bits)
# ---------------------------------------------------------------------------


def ark_g1_uncompressed_read(b: bytes):
    """64 bytes: x LE32 || y LE32 with infinity flag in bit 6 of byte 63."""
    if len(b) != 64:
        raise DeserializationError("ark G1 uncompressed needs 64 bytes")
    x = int.from_bytes(b[:32], "little")
    ytop = b[63]
    infinity = bool(ytop & _INF_FLAG)
    y = int.from_bytes(b[32:63] + bytes([ytop & 0x3F]), "little")
    if infinity:
        return None
    return (x, y)


def ark_g1_uncompressed_write(p) -> bytes:
    if p is None:
        out = bytearray(64)
        out[63] |= _INF_FLAG
        return bytes(out)
    x, y = p
    out = bytearray(int(x).to_bytes(32, "little") + int(y).to_bytes(32, "little"))
    # ark also stamps the y-sign flag on uncompressed points
    if not (y <= (Q_MOD - y) % Q_MOD):
        out[63] |= _NEG_FLAG
    return bytes(out)


def ark_g1_compressed_read(b: bytes):
    """32 bytes: x LE with flags (bit7: y 'negative' i.e. y > -y; bit6: inf)."""
    if len(b) != 32:
        raise DeserializationError("ark G1 compressed needs 32 bytes")
    top = b[31]
    infinity = bool(top & _INF_FLAG)
    negative = bool(top & _NEG_FLAG)
    x = int.from_bytes(b[:31] + bytes([top & 0x3F]), "little")
    if infinity:
        return None
    y = Fq.sqrt((x * x % Q_MOD * x + 3) % Q_MOD)
    assert y is not None, "invalid compressed G1 x-coordinate"
    neg_y = (Q_MOD - y) % Q_MOD
    # ark: positive iff y <= -y
    y_is_neg = not (y <= neg_y)
    if y_is_neg != negative:
        y = neg_y
    return (x, y)


def ark_g1_compressed_write(p) -> bytes:
    if p is None:
        out = bytearray(32)
        out[31] |= _INF_FLAG
        return bytes(out)
    x, y = p
    out = bytearray(int(x).to_bytes(32, "little"))
    if not (y <= (Q_MOD - y) % Q_MOD):
        out[31] |= _NEG_FLAG
    return bytes(out)


def ark_g2_uncompressed_read(b: bytes):
    """128 bytes: x.c0, x.c1, y.c0, y.c1 (each LE32), flags on byte 127."""
    if len(b) != 128:
        raise DeserializationError("ark G2 uncompressed needs 128 bytes")
    xc0 = int.from_bytes(b[0:32], "little")
    xc1 = int.from_bytes(b[32:64], "little")
    yc0 = int.from_bytes(b[64:96], "little")
    top = b[127]
    infinity = bool(top & _INF_FLAG)
    yc1 = int.from_bytes(b[96:127] + bytes([top & 0x3F]), "little")
    if infinity:
        return None
    return ((xc0, xc1), (yc0, yc1))


def ark_g2_uncompressed_write(p) -> bytes:
    if p is None:
        out = bytearray(128)
        out[127] |= _INF_FLAG
        return bytes(out)
    (xc0, xc1), (yc0, yc1) = p
    out = bytearray(
        b"".join(int(c).to_bytes(32, "little") for c in (xc0, xc1, yc0, yc1))
    )
    if _fq2_is_negative((yc0, yc1)):
        out[127] |= _NEG_FLAG
    return bytes(out)


def _fq2_is_negative(y) -> bool:
    """ark QuadExtField ordering: compare c1 first, then c0."""
    ny = ((Q_MOD - y[0]) % Q_MOD, (Q_MOD - y[1]) % Q_MOD)
    if y[1] != ny[1]:
        return y[1] > ny[1]
    return y[0] > ny[0]


def ark_g2_compressed_write(p) -> bytes:
    """64 bytes: x.c0 LE32 || x.c1 LE32 with flags on byte 63."""
    if p is None:
        out = bytearray(64)
        out[63] |= _INF_FLAG
        return bytes(out)
    x, y = p
    out = bytearray(int(x[0]).to_bytes(32, "little") + int(x[1]).to_bytes(32, "little"))
    if _fq2_is_negative(y):
        out[63] |= _NEG_FLAG
    return bytes(out)


def _fq2_sqrt(a):
    """Square root in Fq2 = Fq[u]/(u^2+1) (ark-ff `QuadExtField::sqrt`):
    via the norm c0^2 + c1^2; returns None when `a` is a non-residue."""
    c0, c1 = a[0] % Q_MOD, a[1] % Q_MOD
    if c1 == 0:
        s = Fq.sqrt(c0)
        if s is not None:
            return (s, 0)
        s = Fq.sqrt((Q_MOD - c0) % Q_MOD)  # (t*u)^2 = -t^2
        return None if s is None else (0, s)
    delta = Fq.sqrt((c0 * c0 + c1 * c1) % Q_MOD)
    if delta is None:
        return None
    inv2 = (Q_MOD + 1) // 2
    x0 = (c0 + delta) * inv2 % Q_MOD
    s0 = Fq.sqrt(x0)
    if s0 is None:
        x0 = (c0 - delta) % Q_MOD * inv2 % Q_MOD
        s0 = Fq.sqrt(x0)
        if s0 is None:
            return None
    s1 = c1 * pow(2 * s0 % Q_MOD, Q_MOD - 2, Q_MOD) % Q_MOD
    return (s0, s1)


def ark_g2_compressed_read(b: bytes):
    """64 bytes: x.c0 LE32 || x.c1 LE32, flags on byte 63 (bit7: y 'negative'
    under the (c1, c0)-lexicographic QuadExtField ordering; bit6: infinity)."""
    if len(b) != 64:
        raise DeserializationError("ark G2 compressed needs 64 bytes")
    top = b[63]
    infinity = bool(top & _INF_FLAG)
    negative = bool(top & _NEG_FLAG)
    xc0 = int.from_bytes(b[:32], "little")
    xc1 = int.from_bytes(b[32:63] + bytes([top & 0x3F]), "little")
    if infinity:
        return None
    from ..curve.bn254 import G2_B, fq2_add, fq2_mul

    x = (xc0, xc1)
    y = _fq2_sqrt(fq2_add(fq2_mul(fq2_mul(x, x), x), G2_B))
    assert y is not None, "invalid compressed G2 x-coordinate"
    if _fq2_is_negative(y) != negative:
        y = ((Q_MOD - y[0]) % Q_MOD, (Q_MOD - y[1]) % Q_MOD)
    return (x, y)


def srs_to_unchecked_bytes(g1_points, g2_points) -> bytes:
    """Inverse of load_srs_unchecked (`KZGCommitmentScheme::to_unchecked_bytes`,
    kzg_poly_commitment.rs:206-227): u32 len1 | u32 len2 | G1s | G2s."""
    out = [len(g1_points).to_bytes(4, "little"), len(g2_points).to_bytes(4, "little")]
    out += [ark_g1_uncompressed_write(p) for p in g1_points]
    out += [ark_g2_uncompressed_write(p) for p in g2_points]
    return b"".join(out)


def vk_common_to_bytes(g1_points, g2_points) -> bytes:
    """bincode serialization of the shrunk KZG scheme (`gen-params
    gen-vk-common`, uzkge/src/gen_params/setup.rs:72-83): two serde byte-blobs
    each wrapping an ark compressed Vec<point>."""
    blob1 = len(g1_points).to_bytes(8, "little") + b"".join(
        ark_g1_compressed_write(p) for p in g1_points
    )
    blob2 = len(g2_points).to_bytes(8, "little") + b"".join(
        ark_g2_compressed_write(p) for p in g2_points
    )
    return (
        len(blob1).to_bytes(8, "little")
        + blob1
        + len(blob2).to_bytes(8, "little")
        + blob2
    )


def ark_fr_read(b: bytes) -> int:
    if len(b) != 32:
        raise DeserializationError(f"Fr needs 32 bytes, got {len(b)}")
    v = int.from_bytes(b, "little")
    if v >= R_MOD:
        raise DeserializationError("non-canonical Fr")
    return v


def ark_fr_write(v: int) -> bytes:
    return int(v).to_bytes(32, "little")


# ---------------------------------------------------------------------------
# SRS container (`to/from_unchecked_bytes`)
# ---------------------------------------------------------------------------


def load_srs_unchecked(data: bytes):
    """Parse the reference SRS container: u32 len1 | u32 len2 | len1 * G1
    uncompressed | len2 * G2 uncompressed.  Returns (g1_points, g2_points)."""
    len1 = int.from_bytes(data[0:4], "little")
    len2 = int.from_bytes(data[4:8], "little")
    off = 8
    g1 = []
    for _ in range(len1):
        g1.append(ark_g1_uncompressed_read(data[off : off + 64]))
        off += 64
    g2 = []
    for _ in range(len2):
        g2.append(ark_g2_uncompressed_read(data[off : off + 128]))
        off += 128
    return g1, g2


def load_srs_params(size: int, srs_padding_bytes: bytes):
    """Rebuild the padded SRS exactly like `load_srs_params`
    (uzkge/src/gen_params/mod.rs:151-183): powers 0..2050 plus the three
    t-split blinding powers at {size, size+1, size+2} for
    size in {4096, 8192, 16384}."""
    g1, g2 = load_srs_unchecked(srs_padding_bytes)
    n = max(size + 3, 2051)
    new_g1 = [None] * n
    new_g1[0:2051] = g1[0:2051]
    if size == 4096:
        new_g1[4096:4099] = g1[2051:2054]
    elif size == 8192:
        new_g1[8192:8195] = g1[2054:2057]
    elif size == 16384:
        new_g1[16384:16387] = g1[2057:2060]
    elif size > 16384:
        raise MissingSRSError("SRS capped at n = 16384")
    return new_g1, g2


# ---------------------------------------------------------------------------
# bincode-1.x reader (fixed-int encoding) for the embedded vk bins
# ---------------------------------------------------------------------------


class BincodeReader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def take(self, n: int) -> bytes:
        b = self.data[self.off : self.off + n]
        if len(b) != n:
            raise DeserializationError("bincode: truncated")
        self.off += n
        return b

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "little")

    def boolean(self) -> bool:
        return self.take(1) != b"\x00"

    def blob(self) -> bytes:
        """serde `serialize_bytes` payload: u64 length + raw bytes."""
        return self.take(self.u64())

    def u64_vec(self):
        return [self.u64() for _ in range(self.u64())]


class ArkReader:
    """Reader for CanonicalSerialize payloads inside serde blobs."""

    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def take(self, n):
        b = self.data[self.off : self.off + n]
        if len(b) != n:
            raise DeserializationError("ark: truncated")
        self.off += n
        return b

    def u64(self):
        return int.from_bytes(self.take(8), "little")

    def fr(self):
        return ark_fr_read(self.take(32))

    def fr_vec(self):
        return [self.fr() for _ in range(self.u64())]

    def fr_vec_vec(self):
        return [self.fr_vec() for _ in range(self.u64())]

    def g1_compressed(self):
        return ark_g1_compressed_read(self.take(32))

    def done(self):
        assert self.off == len(self.data), (self.off, len(self.data))


def _commitment(r: BincodeReader):
    """KZGCommitment = newtype with serde-bytes blob of one compressed G1."""
    a = ArkReader(r.blob())
    p = a.g1_compressed()
    a.done()
    return p


def _commitment_vec(r: BincodeReader):
    return [_commitment(r) for _ in range(r.u64())]


def parse_verifier_params_specific(data: bytes, with_shuffle: bool = True):
    """Parse `VerifierParamsSplitSpecific` (bincode of the serde structs in
    uzkge/src/gen_params/mod.rs:85-92 — a verifier-only TurboCS followed by
    PlonkVerifierParams, field order as declared in
    plonk/constraint_system/turbo/mod.rs:29-97 and plonk/indexer.rs:153-193).

    Returns a dict with the constraint-system shape and verifier key.
    """
    r = BincodeReader(data)
    cs = {}
    a = ArkReader(r.blob())
    cs["selectors"] = a.fr_vec_vec()
    a.done()
    cs["wiring"] = [r.u64_vec() for _ in range(5)]
    a = ArkReader(r.blob()); cs["edwards_a"] = a.fr(); a.done()
    for name in ("pk_x", "pk_y", "pk_dxy", "gen_x", "gen_y", "gen_dxy"):
        a = ArkReader(r.blob()); cs["shuffle_" + name] = a.fr_vec_vec(); a.done()
    for name in ("anemoi_prk_x", "anemoi_prk_y"):
        a = ArkReader(r.blob())
        cs[name] = [[a.fr(), a.fr()] for _ in range(14)]
        a.done()
    a = ArkReader(r.blob()); cs["anemoi_generator"] = a.fr(); a.done()
    a = ArkReader(r.blob()); cs["anemoi_generator_inv"] = a.fr(); a.done()
    cs["anemoi_constraints_indices"] = r.u64_vec()
    cs["n_iteration_shuffle_scalar_mul"] = r.u64()
    cs["num_vars"] = r.u64()
    cs["size"] = r.u64()
    cs["public_vars_constraint_indices"] = r.u64_vec()
    cs["public_vars_witness_indices"] = r.u64_vec()
    cs["boolean_constraint_indices"] = r.u64_vec()
    # shuffle_remark_constraint_indices: ark blob Vec<(u64, [Vec<F>; 3])>
    a = ArkReader(r.blob())
    n = a.u64()
    cs["shuffle_remark_constraint_indices"] = [
        (a.u64(), [a.fr_vec() for _ in range(3)]) for _ in range(n)
    ]
    a.done()
    cs["verifier_only"] = r.boolean()
    a = ArkReader(r.blob()); cs["witness"] = a.fr_vec(); a.done()

    vk = {}
    vk["cm_q_vec"] = _commitment_vec(r)
    vk["cm_s_vec"] = _commitment_vec(r)
    vk["cm_qb"] = _commitment(r)
    vk["cm_prk_vec"] = _commitment_vec(r)
    if with_shuffle:
        vk["cm_q_ecc"] = _commitment(r)
        vk["cm_shuffle_generator_vec"] = _commitment_vec(r)
        vk["cm_shuffle_public_key_vec"] = _commitment_vec(r)
    a = ArkReader(r.blob()); vk["anemoi_generator"] = a.fr(); a.done()
    a = ArkReader(r.blob()); vk["anemoi_generator_inv"] = a.fr(); a.done()
    a = ArkReader(r.blob()); vk["k"] = a.fr_vec(); a.done()
    if with_shuffle:
        a = ArkReader(r.blob()); vk["edwards_a"] = a.fr(); a.done()
    vk["cs_size"] = r.u64()
    vk["public_vars_constraint_indices"] = r.u64_vec()
    a = ArkReader(r.blob()); vk["lagrange_constants"] = a.fr_vec(); a.done()
    assert r.off == len(data), (r.off, len(data))
    return {"cs": cs, "vk": vk}
