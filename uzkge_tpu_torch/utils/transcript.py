"""Fiat-Shamir transcript, byte-identical to the reference's Keccak state
machine (uzkge/src/utils/transcript.rs:8-70) and its Solidity mirror
(contracts/libraries/Transcript.sol).

State machine:
  * messages shorter than 32 bytes are left-padded with zeros into a 32-byte
    slot; longer messages must be a multiple of 32 bytes and are appended raw;
  * a challenge is keccak256(state), byte-reversed, reduced mod r from
    little-endian — equivalently, int(digest_be) mod r — and the state RESETS
    to the challenge's 32 big-endian bytes;
  * single bytes are appended unpadded (used for the 0x01 before gamma).
"""

from ..hash.keccak import keccak256

SLOT_SIZE = 32


class Transcript:
    def __init__(self, msg: bytes):
        self.state = bytearray()
        self.append_message(msg)

    def append_message(self, msg: bytes):
        if len(msg) < SLOT_SIZE:
            self.state += b"\x00" * (SLOT_SIZE - len(msg)) + msg
        else:
            assert len(msg) % SLOT_SIZE == 0
            self.state += msg

    def append_u64(self, a: int):
        self.append_message(int(a).to_bytes(8, "big"))

    def append_single_byte(self, b: int):
        self.state.append(b)

    def append_field_elem(self, v: int):
        """Append a field element as 32 big-endian bytes (ark
        `into_bigint().to_bytes_be()`)."""
        self.append_message(int(v).to_bytes(32, "big"))

    def append_commitment(self, point_xy):
        """Append an uncompressed G1 point as BE x || BE y (64 bytes), the
        reference's `to_transcript_bytes` (kzg_poly_commitment.rs:37-53).
        `point_xy` is an affine (x, y) pair of Fq ints; the identity is
        encoded as (0, 0)."""
        x, y = point_xy
        self.append_message(int(x).to_bytes(32, "big") + int(y).to_bytes(32, "big"))

    def get_challenge(self, modulus: int) -> int:
        digest = keccak256(bytes(self.state))
        challenge = int.from_bytes(digest, "big") % modulus
        self.state = bytearray(challenge.to_bytes(32, "big"))
        return challenge
