"""Proof wire format: the fixed big-endian byte layout consumed byte-for-byte
by the Solidity verifier (reference indexer.rs:538-732,
ShuffleVerifier.sol:31-86).

Shuffle-shaped proof = 16 uncompressed G1 points + 19 Fr scalars = 1632 bytes;
generic (non-shuffle) = 13 points + 15 scalars = 1312 bytes.  (The JAX
package's proof_io states 12 points and 1248 bytes for the generic shape, so
its `proof_from_bytes_be` refuses every generic proof; its writer agrees
with this one.)
"""

PROOF_BYTES = {True: 1632, False: 1312}  # by with_shuffle

from ..errors import ProofError
from ..utils.serialize import point_to_uncompress_be, g1_from_uncompress_be, scalar_to_bytes_be, scalar_from_bytes_be


def proof_to_bytes_be(proof: dict, with_shuffle: bool = True) -> bytes:
    out = bytearray()
    for p in proof["cm_w_vec"]:
        out += point_to_uncompress_be(p)
    if with_shuffle:
        for p in proof["cm_w_sel_vec"]:
            out += point_to_uncompress_be(p)
    for p in proof["cm_t_vec"]:
        out += point_to_uncompress_be(p)
    out += point_to_uncompress_be(proof["cm_z"])
    out += scalar_to_bytes_be(proof["prk_3_poly_eval_zeta"])
    out += scalar_to_bytes_be(proof["prk_4_poly_eval_zeta"])
    for s in proof["w_polys_eval_zeta"]:
        out += scalar_to_bytes_be(s)
    for s in proof["w_polys_eval_zeta_omega"]:
        out += scalar_to_bytes_be(s)
    out += scalar_to_bytes_be(proof["z_eval_zeta_omega"])
    for s in proof["s_polys_eval_zeta"]:
        out += scalar_to_bytes_be(s)
    if with_shuffle:
        out += scalar_to_bytes_be(proof["q_ecc_poly_eval_zeta"])
        for s in proof["w_sel_polys_eval_zeta"]:
            out += scalar_to_bytes_be(s)
    out += point_to_uncompress_be(proof["opening_witness_zeta"])
    out += point_to_uncompress_be(proof["opening_witness_zeta_omega"])
    return bytes(out)


def proof_from_bytes_be(data: bytes, with_shuffle: bool = True) -> dict:
    want = PROOF_BYTES[with_shuffle]
    if len(data) != want:
        raise ProofError(f"proof must be {want} bytes, got {len(data)}")
    n_wire = 5
    n_sel = 3
    pos = 0

    def point():
        nonlocal pos
        p = g1_from_uncompress_be(data[pos : pos + 64])
        pos += 64
        return p

    def scalar():
        nonlocal pos
        s = scalar_from_bytes_be(data[pos : pos + 32])
        pos += 32
        return s

    proof = {}
    proof["cm_w_vec"] = [point() for _ in range(n_wire)]
    if with_shuffle:
        proof["cm_w_sel_vec"] = [point() for _ in range(n_sel)]
    proof["cm_t_vec"] = [point() for _ in range(n_wire)]
    proof["cm_z"] = point()
    proof["prk_3_poly_eval_zeta"] = scalar()
    proof["prk_4_poly_eval_zeta"] = scalar()
    proof["w_polys_eval_zeta"] = [scalar() for _ in range(n_wire)]
    proof["w_polys_eval_zeta_omega"] = [scalar() for _ in range(3)]
    proof["z_eval_zeta_omega"] = scalar()
    proof["s_polys_eval_zeta"] = [scalar() for _ in range(n_wire - 1)]
    if with_shuffle:
        proof["q_ecc_poly_eval_zeta"] = scalar()
        proof["w_sel_polys_eval_zeta"] = [scalar() for _ in range(n_sel)]
    proof["opening_witness_zeta"] = point()
    proof["opening_witness_zeta_omega"] = point()
    assert pos == len(data), (pos, len(data))
    return proof
