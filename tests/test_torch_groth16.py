"""The port's Groth16 (uzkge_tpu_torch/groth16/) against the JAX package's.

Exact comparisons throughout: equal affine points, equal field values and
equal proof words from the same ChaCha20Rng.

  * ark's compressed G1 / G2 readers on the embedded proving key's vk and on
    the first 64 points of each of its vectors, read at their raw offsets
    (the length prefixes give them, so no full load);
  * the own-shape setup on a 40-product chain (domain 64), point for point,
    and the port's prove(device="cpu") on it: the sha256 of its words equal
    to the JAX package's (`g16toy64`, tests/torch_golden.py: its prove
    compiles the JAX NTT for ~30 s), accepted by verify, a wrong public
    input rejected;
  * slow: the 700-product chain (domain 1024, so that every G1 query has
    more than HOST_MSM_MAX = 512 points and reaches the Pippenger's plain
    versions): one JAX setup, the port's key made from its fields, the
    port's proof equal to the JAX package's `prove` on its host Pippenger
    (HOST_MSM_MAX monkeypatched in this process) and to the golden
    `g16toy`; and the JAX package's device route, whose proof at this
    shape `verify` rejects (ROADMAP queue 3, item 7: its MSM drops chunks
    when n has an odd divisor; this case fails once that is repaired).
"""

import dataclasses
import json
import os
import struct

import pytest
import torch

from uzkge_tpu_torch.groth16 import groth16 as pg
from uzkge_tpu_torch.utils import serialize as pser

from .torch_golden import G16TOY, g16_rng, g16toy_circuit, to_jax_r1cs, words_digest

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PK_BIN = os.path.join(ROOT, "uzkge_tpu", "parameters", "groth16_pk.bin")
GOLDEN = json.load(open(os.path.join(ROOT, "tests", "data", "torch_golden.json")))
G16TOY_SHA = GOLDEN["g16toy"]["sha256"]


def _pk_points(first: int = 64):
    """(kind, bytes) of the vk's points and of the first `first` points of
    each vector of groth16_pk.bin, in the file's order (ark_pk.py's layout)."""
    data = open(PK_BIN, "rb").read()
    off, out = 0, []

    def take(kind):
        nonlocal off
        size = 32 if kind == "g1" else 64
        out.append((kind, data[off : off + size]))
        off += size

    def vec(kind):
        nonlocal off
        n = struct.unpack("<Q", data[off : off + 8])[0]
        off += 8
        size = 32 if kind == "g1" else 64
        for i in range(min(n, first)):
            out.append((kind, data[off + i * size : off + (i + 1) * size]))
        off += n * size

    for kind in ("g1", "g2", "g2", "g2"):
        take(kind)
    vec("g1")  # gamma_abc_g1
    take("g1")  # beta_g1
    take("g1")  # delta_g1
    for kind in ("g1", "g1", "g2", "g1", "g1"):  # a, b_g1, b_g2, h, l
        vec(kind)
    assert off == len(data)
    return out


def test_ark_compressed_readers_match_jax():
    from uzkge_tpu.utils import serialize as jser

    pts = _pk_points()
    assert sum(k == "g2" for k, _ in pts) == 3 + 64
    for kind, b in pts:
        read = (pser.ark_g1_compressed_read, jser.ark_g1_compressed_read) if kind == "g1" else (
            pser.ark_g2_compressed_read, jser.ark_g2_compressed_read)
        assert read[0](b) == read[1](b)
    # the infinity flag and a flipped sign flag
    inf = bytes(63) + bytes([0x40])
    assert pser.ark_g2_compressed_read(inf) is None is jser.ark_g2_compressed_read(inf)
    kind, b = next(p for p in pts if p[0] == "g2")
    flip = b[:63] + bytes([b[63] ^ 0x80])
    got = pser.ark_g2_compressed_read(flip)
    assert got == jser.ark_g2_compressed_read(flip)
    plain = pser.ark_g2_compressed_read(b)
    assert got[0] == plain[0] and got[1] != plain[1]


def _fields(obj):
    """A key's dataclass fields but its device MSM cache, recursively."""
    return {f.name: (_fields(getattr(obj, f.name)) if dataclasses.is_dataclass(getattr(obj, f.name))
                     else getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.name != "_msm_cache"}


@pytest.fixture(scope="module")
def toy64():
    """The 40-product chain (domain 64), set up by both packages."""
    from uzkge_tpu.groth16 import groth16 as jg

    cs = g16toy_circuit(products=GOLDEN["g16toy64"]["products"])
    seed = GOLDEN["g16toy64"]["setup_seed"].encode()
    return cs, pg.setup(cs, seed=seed), jg.setup(to_jax_r1cs(cs), seed=seed)


def test_setup_matches_jax(toy64):
    _, pk, jpk = toy64
    assert pk.domain_size == jpk.domain_size == 64
    assert _fields(pk) == _fields(jpk)


def test_prove_matches_jax_and_verifies(toy64):
    cs, pk, _ = toy64
    proof = pg.prove(pk, cs, rng=g16_rng(), device="cpu")
    assert words_digest(proof.to_solidity_words()) == GOLDEN["g16toy64"]["sha256"]
    public = cs.public_inputs()
    assert pg.verify(pk.vk, public, proof)
    assert not pg.verify(pk.vk, [public[0], (public[1] + 1) % pg.P], proof)


@pytest.fixture(scope="module")
def toy1024():
    """The 700-product chain: one JAX setup, the port's key from its fields."""
    from uzkge_tpu.groth16 import groth16 as jg

    cs = g16toy_circuit()
    jpk = jg.setup(to_jax_r1cs(cs), seed=G16TOY["setup_seed"].encode())
    vk = pg.Groth16Vk(**_fields(jpk.vk))
    pk = pg.Groth16Pk(**{k: v for k, v in _fields(jpk).items() if k != "vk"}, vk=vk)
    return cs, pk, jpk


@pytest.mark.slow
def test_prove_1024_matches_jax_host_msm(toy1024, monkeypatch):
    """Every G1 query above 512 points: the port's Pippenger (plain versions)
    against the JAX package's prove on its host Pippenger."""
    import uzkge_tpu.msm.msm as jmsm
    from uzkge_tpu.groth16 import groth16 as jg

    cs, pk, jpk = toy1024
    assert min(sum(p is not None for p in q)
               for q in (pk.a_query, pk.b_g1_query, pk.h_query, pk.l_query)) > 512
    proof = pg.prove(pk, cs, rng=g16_rng(), device="cpu")
    monkeypatch.setattr(jmsm, "HOST_MSM_MAX", 10**9)
    want = jg.prove(jpk, to_jax_r1cs(cs), rng=g16_rng())
    assert proof.to_solidity_words() == want.to_solidity_words()
    assert words_digest(proof.to_solidity_words()) == G16TOY_SHA
    assert pg.verify(pk.vk, cs.public_inputs(), proof)


@pytest.mark.slow
def test_jax_device_route_proof_rejected(toy1024):
    """Records ROADMAP queue 3, item 7: the JAX package's own prove, its MSMs
    on its device route, gives a proof that verify rejects at domain 1024
    (MSMBases picks 11 and 10 chunks for the h and l queries, and the
    device MSM folds an odd chunk count by halves, dropping one).  Fails
    once the reference is repaired."""
    from uzkge_tpu.groth16 import groth16 as jg

    cs, _, jpk = toy1024
    jcs = to_jax_r1cs(cs)
    proof = jg.prove(jpk, jcs, rng=g16_rng())
    assert not jg.verify(jpk.vk, jcs.public_inputs(), proof)
