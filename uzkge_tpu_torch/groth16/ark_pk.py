"""Parser for the reference's embedded ark-groth16 proving key (a copy of
`uzkge_tpu/groth16/ark_pk.py`; the binary is read by path from
`uzkge_tpu/parameters/`, as data, and the key caches its device MSM bases).

`shuffle/parameters/groth16_pk.bin` is an ark-serialize *compressed,
unchecked* `ProvingKey<Bn254>` (reference: shuffle/src/gen_params/params.rs:172,
`deserialize_compressed_unchecked`).  Layout (ark-groth16 0.4 derive order):

    vk: alpha_g1, beta_g2, gamma_g2, delta_g2, gamma_abc_g1(Vec)
    beta_g1, delta_g1,
    a_query(Vec<G1>), b_g1_query(Vec<G1>), b_g2_query(Vec<G2>),
    h_query(Vec<G1>), l_query(Vec<G1>)

Vectors carry a u64-LE length prefix; G1 compressed = 32 B (x LE + 2 flag
bits in the top byte), G2 compressed = 64 B (x.c0 then x.c1, flags on the
last byte).  The embedded 52-card key has 7 instance columns (ONE + the six
public coordinates h/reveal/pk), 4869 QAP variables, 4862 witnesses and an
8192-point evaluation domain (h_query = 8191).
"""

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from ..utils.serialize import ark_g1_compressed_read, ark_g2_compressed_read


@dataclass
class ArkGroth16Vk:
    alpha_g1: Tuple[int, int]
    beta_g2: tuple
    gamma_g2: tuple
    delta_g2: tuple
    gamma_abc_g1: List


@dataclass
class ArkGroth16Pk:
    vk: ArkGroth16Vk
    beta_g1: Tuple[int, int]
    delta_g1: Tuple[int, int]
    a_query: List
    b_g1_query: List
    b_g2_query: List
    h_query: List
    l_query: List
    # (query name, device) -> the device MSM bases over the query's non-identity points
    _msm_cache: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def num_instance(self) -> int:
        return len(self.vk.gamma_abc_g1)

    @property
    def num_witness(self) -> int:
        return len(self.l_query)

    @property
    def domain_size(self) -> int:
        return len(self.h_query) + 1


class _Cursor:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def take(self, n: int) -> bytes:
        b = self.data[self.off : self.off + n]
        if len(b) != n:
            from ..errors import DeserializationError

            raise DeserializationError(f"groth16 pk truncated at offset {self.off}")
        self.off += n
        return b

    def g1(self):
        return ark_g1_compressed_read(self.take(32))

    def g2(self):
        return ark_g2_compressed_read(self.take(64))

    def vec(self, reader):
        n = struct.unpack("<Q", self.take(8))[0]
        return [reader() for _ in range(n)]


def parse_groth16_pk(data: bytes) -> ArkGroth16Pk:
    c = _Cursor(data)
    vk = ArkGroth16Vk(
        alpha_g1=c.g1(),
        beta_g2=c.g2(),
        gamma_g2=c.g2(),
        delta_g2=c.g2(),
        gamma_abc_g1=c.vec(c.g1),
    )
    pk = ArkGroth16Pk(
        vk=vk,
        beta_g1=c.g1(),
        delta_g1=c.g1(),
        a_query=c.vec(c.g1),
        b_g1_query=c.vec(c.g1),
        b_g2_query=c.vec(c.g2),
        h_query=c.vec(c.g1),
        l_query=c.vec(c.g1),
    )
    if c.off != len(data):
        from ..errors import DeserializationError

        raise DeserializationError(
            f"groth16 pk: {len(data) - c.off} trailing bytes after ProvingKey"
        )
    return pk


_CACHED: Optional[ArkGroth16Pk] = None


def load_reference_groth16_pk() -> ArkGroth16Pk:
    """The embedded 52-card reveal proving key (GROTH16_PK_52)."""
    global _CACHED
    if _CACHED is None:
        import os

        path = os.path.join(os.path.dirname(__file__), "..", "..", "uzkge_tpu", "parameters",
                            "groth16_pk.bin")
        with open(path, "rb") as f:
            _CACHED = parse_groth16_pk(f.read())
    return _CACHED
