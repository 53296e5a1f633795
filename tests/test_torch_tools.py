"""The port's host tools and the serializer, curve and gen_params functions
under them, against the JAX package's, on the CPU, exactly:

* `gen_solidity_vk` on the port's embedded 48-, 52- and 54-card vks equals
  the JAX package's `tools/gen_solidity_vk.py` on its own, source for
  source; the VerifierKey_52 block loads the same memory through both
  packages' Yul VMs, the vk's selector commitments at `vk`;
* the serializer's writers round-trip through the port's readers and equal
  the JAX package's writers byte for byte;
* `gen_vk_common` reproduces the committed vk-common.bin, `cut_srs` the
  committed srs-padding.bin (as tests/test_aux.py does for the JAX tool);
* both tools' `main`.
"""

import os
import random
import sys

import pytest

from uzkge_tpu.evm import yul as jyul
from uzkge_tpu.utils import serialize as jser
from uzkge_tpu_torch.constants.bn254 import Q_MOD, R_MOD
from uzkge_tpu_torch.curve import babyjubjub as bjj
from uzkge_tpu_torch.curve import bn254 as tbn
from uzkge_tpu_torch.evm import yul as tyul
from uzkge_tpu_torch.errors import DeserializationError
from uzkge_tpu_torch.gen_params import PARAMS_DIR, _read, load_shuffle_verifier_params
from uzkge_tpu_torch.tools import gen_params_cli, gen_solidity_vk
from uzkge_tpu_torch.utils import serialize as ser

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))


@pytest.fixture(scope="module")
def vk_sources():
    """{n: (the port's sources, the JAX tool's sources)} for 48, 52, 54."""
    import gen_solidity_vk as jtool
    from uzkge_tpu.gen_params import load_shuffle_verifier_params as jload

    return {n: (gen_solidity_vk.gen_solidity_vk(load_shuffle_verifier_params(n), n),
                jtool.gen_solidity_vk(jload(n), n)) for n in (48, 52, 54)}


@pytest.mark.parametrize("n_cards", [48, 52, 54])
def test_gen_solidity_vk_matches_jax(vk_sources, n_cards):
    got, want = vk_sources[n_cards]
    assert set(got) == {f"VerifierKey_{n_cards}.sol", f"VerifierKeyExtra1_{n_cards}.sol",
                        f"VerifierKeyExtra2_{n_cards}.sol"}
    assert got == want


def test_verifier_key_block_loads_the_same_memory(vk_sources):
    src = vk_sources[52][0]["VerifierKey_52.sol"]
    vk, pi = 0x380, 0x3000
    mems = []
    for mod in (tyul, jyul):
        blocks = mod.extract_assembly_blocks(src)
        assert len(blocks) == 1
        vm = mod.YulVM()
        vm.run(mod.parse_block(blocks[0]), {"vk": vk, "pi": pi})
        mems.append(bytes(vm.memory))
    assert mems[0] == mems[1]
    mem = mems[0]
    key = load_shuffle_verifier_params(52)
    assert len(key.cm_q_vec) == 9
    assert any(p is not None for p in key.cm_q_vec)
    for i, p in enumerate(key.cm_q_vec):
        x, y = (0, 0) if p is None else p  # the identity loads as two zero words
        off = vk + 64 * i
        assert int.from_bytes(mem[off : off + 32], "big") == x
        assert int.from_bytes(mem[off + 32 : off + 64], "big") == y
    assert int.from_bytes(mem[pi : pi + 32], "big") == 52 * 8


def _points(rng, k):
    g1 = [tbn.g1_mul(tbn.G1_GEN, rng.randrange(1, R_MOD)) for _ in range(k)] + [None]
    g2 = [tbn.g2_mul(tbn.G2_GEN, rng.randrange(1, R_MOD)) for _ in range(2)] + [None]
    g1 += [tbn.g1_neg(p) for p in g1[:2]]
    g2 += [tbn.g2_neg(q) for q in g2[:2]]
    return g1, g2


def test_serializer_writers_round_trip_and_match_jax():
    rng = random.Random(7)
    g1, g2 = _points(rng, 6)
    for p in g1:
        for tw, jw, read in ((ser.ark_g1_uncompressed_write, jser.ark_g1_uncompressed_write,
                              ser.ark_g1_uncompressed_read),
                             (ser.ark_g1_compressed_write, jser.ark_g1_compressed_write,
                              ser.ark_g1_compressed_read)):
            b = tw(p)
            assert b == jw(p) and read(b) == p
    for q in g2:
        for tw, jw, read in ((ser.ark_g2_uncompressed_write, jser.ark_g2_uncompressed_write,
                              ser.ark_g2_uncompressed_read),
                             (ser.ark_g2_compressed_write, jser.ark_g2_compressed_write,
                              ser.ark_g2_compressed_read)):
            b = tw(q)
            assert b == jw(q) and read(b) == q
    for v in (0, 1, R_MOD - 1, rng.randrange(R_MOD)):
        assert ser.ark_fr_write(v) == jser.ark_fr_write(v) and ser.ark_fr_read(ser.ark_fr_write(v)) == v
    blob = ser.srs_to_unchecked_bytes(g1, g2)
    assert blob == jser.srs_to_unchecked_bytes(g1, g2)
    assert ser.load_srs_unchecked(blob) == (g1, g2)
    assert ser.vk_common_to_bytes(g1[:2], g2[:2]) == jser.vk_common_to_bytes(g1[:2], g2[:2])
    e = bjj.mul(bjj.GENERATOR, 12345)
    b = ser.point_to_uncompress_be(e)
    assert ser.edwards_from_uncompress_be(b) == jser.edwards_from_uncompress_be(b) == e
    with pytest.raises(DeserializationError):
        ser.edwards_from_uncompress_be(b[:63])


def test_curve_functions_match_jax():
    from uzkge_tpu.curve import babyjubjub as jbjj
    from uzkge_tpu.curve import bn254 as jbn

    rng = random.Random(11)
    pts = [tbn.g1_mul(tbn.G1_GEN, rng.randrange(1, R_MOD)) for _ in range(4)]
    sc = [rng.randrange(R_MOD) for _ in range(4)] + [0]
    assert tbn.g1_msm(pts + [tbn.G1_GEN], sc) == jbn.g1_msm(pts + [tbn.G1_GEN], sc)
    for p in pts + [None, (1, 2), (1, 3)]:
        assert tbn.g1_is_on_curve(p) == jbn.g1_is_on_curve(p)
    q = tbn.g2_mul(tbn.G2_GEN, 99)
    for p in (q, None, tbn.g2_neg(q), ((1, 2), (3, 4))):
        assert tbn.g2_is_on_curve(p) == jbn.g2_is_on_curve(p)
        assert tbn.g2_neg(p) == jbn.g2_neg(p)
    assert tbn.g2_add(q, tbn.g2_neg(q)) is None
    assert tbn.fq2_neg((3, Q_MOD - 1)) == jbn.fq2_neg((3, Q_MOD - 1)) == (Q_MOD - 3, 1)
    e = bjj.mul(bjj.GENERATOR, 777)
    for p in (e, bjj.IDENTITY, (1, 1), (e[0], e[1] + 1)):
        assert bjj.is_on_curve(p) == jbjj.is_on_curve(p)
    assert bjj.is_on_curve(e) and not bjj.is_on_curve((1, 1))


def test_gen_vk_common_reproduces_the_committed_file():
    from uzkge_tpu.gen_params import _read as jread

    assert _read("srs-padding.bin") == jread("srs-padding.bin")
    assert gen_params_cli.gen_vk_common(_read("srs-padding.bin")) == _read("vk-common.bin")


def test_cut_srs_reproduces_the_committed_padding():
    pad = _read("srs-padding.bin")
    g1, g2 = ser.load_srs_unchecked(pad)
    # a "full" SRS carrying the real powers at the positions cut_srs keeps
    full = [g1[0]] * 16387
    full[0:2051] = g1[0:2051]
    full[4096:4099] = g1[2051:2054]
    full[8192:8195] = g1[2054:2057]
    full[16384:16387] = g1[2057:2060]
    assert gen_params_cli.cut_srs(ser.srs_to_unchecked_bytes(full, g2)) == pad
    assert gen_params_cli.cut_srs(pad) == pad  # idempotent on a cut SRS
    with pytest.raises(ValueError):
        gen_params_cli.cut_srs(ser.srs_to_unchecked_bytes(full[:5000], g2))


def test_tool_mains_write_the_files(tmp_path, vk_sources):
    assert gen_params_cli.main(["gen-vk-common", str(tmp_path)]) == 0
    assert (tmp_path / "vk-common.bin").read_bytes() == _read("vk-common.bin")
    assert gen_params_cli.main(["cut-srs", os.path.join(PARAMS_DIR, "srs-padding.bin"),
                                str(tmp_path)]) == 0
    assert (tmp_path / "srs-padding.bin").read_bytes() == _read("srs-padding.bin")
    assert gen_params_cli.main(["nothing"]) == 1
    assert gen_solidity_vk.main(["52", str(tmp_path / "sol")]) == 0
    for name, src in vk_sources[52][1].items():
        assert (tmp_path / "sol" / name).read_text() == src
