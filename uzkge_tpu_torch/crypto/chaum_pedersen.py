"""Chaum-Pedersen discrete-log equality proofs over BabyJubjub.

Sigma protocol proving the same scalar under two bases (g, h): used for
mask/reveal proofs.  Keccak-transcript variant (`cp_prove`/`cp_verify`) and
Anemoi-hash variant (`cp_prove0`/`cp_verify0`), plus the fixed 160-byte BE
wire format.  Reference: uzkge/src/chaum_pedersen/dl.rs.
"""

from dataclasses import dataclass

from ..constants.bn254 import R_MOD
from ..curve import babyjubjub as bjj
from ..utils.transcript import Transcript
from ..hash.anemoi import eval_variable_length_hash

# BabyJubjub scalar field order (proof scalar r lives here, but the
# challenge is reduced mod the BabyJubjub Fr = bjj.ORDER like ark's
# get_challenge_field_elem::<ark_ed_on_bn254::Fr>)
ORDER = bjj.ORDER


@dataclass
class ChaumPedersenDLProof:
    a: tuple  # point
    b: tuple  # point
    r: int    # scalar

    def to_uncompress(self) -> bytes:
        out = bytearray()
        for pt in (self.a, self.b):
            out += int(pt[0]).to_bytes(32, "big") + int(pt[1]).to_bytes(32, "big")
        out += int(self.r).to_bytes(32, "big")
        return bytes(out)

    @staticmethod
    def from_uncompress(data: bytes) -> "ChaumPedersenDLProof":
        assert len(data) >= 160
        ax = int.from_bytes(data[0:32], "big") % R_MOD
        ay = int.from_bytes(data[32:64], "big") % R_MOD
        bx = int.from_bytes(data[64:96], "big") % R_MOD
        by = int.from_bytes(data[96:128], "big") % R_MOD
        r = int.from_bytes(data[128:160], "big") % ORDER
        return ChaumPedersenDLProof((ax, ay), (bx, by), r)


def _append_point(transcript: Transcript, pt):
    transcript.append_commitment(pt)


def _init_transcript(transcript: Transcript, g, h, c1, c2):
    transcript.append_message(b"DL")
    for pt in (g, h, c1, c2):
        _append_point(transcript, pt)


def cp_prove(rng, g, h, transcript: Transcript, witness: int, c1, c2) -> ChaumPedersenDLProof:
    """(dl.rs:75-109)"""
    assert bjj.mul(g, witness) == c1 and bjj.mul(h, witness) == c2
    _init_transcript(transcript, g, h, c1, c2)
    omega = rng.randrange(1, ORDER)
    a = bjj.mul(g, omega)
    b = bjj.mul(h, omega)
    _append_point(transcript, a)
    _append_point(transcript, b)
    c = transcript.get_challenge(ORDER)
    r = (omega + c * witness) % ORDER
    return ChaumPedersenDLProof(a, b, r)


def cp_verify(g, h, transcript: Transcript, c1, c2, proof: ChaumPedersenDLProof) -> bool:
    """(dl.rs:165-193)"""
    _init_transcript(transcript, g, h, c1, c2)
    _append_point(transcript, proof.a)
    _append_point(transcript, proof.b)
    c = transcript.get_challenge(ORDER)
    if bjj.mul(g, proof.r) != bjj.add(proof.a, bjj.mul(c1, c)):
        return False
    if bjj.mul(h, proof.r) != bjj.add(proof.b, bjj.mul(c2, c)):
        return False
    return True


def _anemoi_challenge(g, h, c1, c2, a, b) -> int:
    inputs = []
    for pt in (g, h, c1, c2, a, b):
        x, y = pt if pt != bjj.IDENTITY else (0, 1)
        inputs += [x, y]
    out = eval_variable_length_hash(inputs)
    # Fr(bn254) value re-read as BabyJubjub-Fr from its BE bytes (dl.rs:158)
    return int.from_bytes(int(out).to_bytes(32, "big"), "big") % ORDER


def cp_prove0(rng, g, h, witness: int, c1, c2) -> ChaumPedersenDLProof:
    """zk-friendly (Anemoi) variant (dl.rs:112-163)."""
    assert bjj.mul(g, witness) == c1 and bjj.mul(h, witness) == c2
    omega = rng.randrange(1, ORDER)
    a = bjj.mul(g, omega)
    b = bjj.mul(h, omega)
    c = _anemoi_challenge(g, h, c1, c2, a, b)
    r = (omega + c * witness) % ORDER
    return ChaumPedersenDLProof(a, b, r)


def cp_verify0(g, h, c1, c2, proof: ChaumPedersenDLProof) -> bool:
    """(dl.rs:196-241)"""
    c = _anemoi_challenge(g, h, c1, c2, proof.a, proof.b)
    if bjj.mul(g, proof.r) != bjj.add(proof.a, bjj.mul(c1, c)):
        return False
    if bjj.mul(h, proof.r) != bjj.add(proof.b, bjj.mul(c2, c)):
        return False
    return True
