"""The plain reference against the published parameters and, in these
tests only, against the program's host code on the same inputs."""

import os
import random
import sys

from .conftest import ROOT

sys.path.insert(0, ROOT)

from zkbench.reference import anemoi, babyjubjub as bjj, params  # noqa: E402
from zkbench.reference import matchmaking as ref_mm  # noqa: E402
from zkbench.reference import shuffle as ref_sh  # noqa: E402
from zkbench.reference.bn254 import G1_GEN, g1_add, g1_msm, g1_mul  # noqa: E402


def _published(name):
    with open(os.path.join(ROOT, "uzkge_tpu", "parameters", name), "rb") as f:
        return f.read()


def test_remark_rows_give_the_published_generator_commitments():
    vk = params.verifier_key(_published("vk-specific-52.bin"), True, G1_GEN)
    lag = params.SRS(_published("lagrange-srs-16384.bin"))
    sums = ref_sh.selector_rows(lag, {"first": 6, "stride": 89, "count": 52}, 84)
    assert ref_sh.selector_commitments(bjj.GENERATOR, sums) == vk.cm_shuffle_generator_vec
    moved = ref_sh.selector_rows(lag, {"first": 7, "stride": 89, "count": 52}, 84)
    assert ref_sh.selector_commitments(bjj.GENERATOR, moved) != vk.cm_shuffle_generator_vec


def test_published_keys_read_as_the_program_reads_them():
    from uzkge_tpu_torch.utils import serialize as ser

    for name, shuffle in (("vk-specific-52.bin", True), ("vk-specific-matchmaking.bin", False)):
        want = ser.parse_verifier_params_specific(_published(name), with_shuffle=shuffle)["vk"]
        got = params.verifier_key(_published(name), shuffle, G1_GEN)
        for k, v in want.items():
            assert getattr(got, k) == v, (name, k)


def test_curve_arithmetic_matches_the_program():
    from uzkge_tpu_torch.curve import babyjubjub as pb
    from uzkge_tpu_torch.curve import bn254 as pbn
    from uzkge_tpu_torch.shuffle.primitives import create_windows

    rng = random.Random(5)
    for _ in range(5):
        k = rng.randrange(bjj.ORDER)
        p = bjj.mul(bjj.GENERATOR, k)
        assert p == pb.mul(pb.GENERATOR, k) and bjj.on_curve(p)
        assert bjj.add(p, bjj.GENERATOR) == pb.add(p, pb.GENERATOR)
        s = rng.randrange(1 << 254)
        assert g1_mul(G1_GEN, s) == pbn.g1_mul(G1_GEN, s)
    pts = [g1_mul(G1_GEN, rng.randrange(1 << 250)) for _ in range(20)]
    sc = [rng.randrange(1 << 254) for _ in range(20)]
    acc = None
    for p, s in zip(pts, sc):
        acc = g1_add(acc, g1_mul(p, s))
    assert g1_msm(pts, sc) == acc
    pk = bjj.mul(bjj.GENERATOR, 12345)
    assert bjj.windows(pk, 84) == create_windows(pk)


def test_table_decrypts_to_its_cards():
    table = ref_sh.Table(random.Random(9), 6, 4)
    assert table.bad_cards(table.deck) == 0
    perm = list(reversed(table.deck))
    assert table.bad_cards(perm) == 0
    e1, e2 = perm[0]
    r = 77
    remasked = [(bjj.add(e1, bjj.mul(bjj.GENERATOR, r)), bjj.add(e2, bjj.mul(table.joint, r)))]
    assert table.bad_cards(remasked + perm[1:]) == 0
    assert table.bad_cards([perm[1]] + perm[1:]) == 1  # a card twice, one missing
    assert table.bad_cards(perm[1:]) == 1
    assert table.bad_cards([(e1, bjj.add(e2, bjj.GENERATOR))] + perm[1:]) == 1


def test_lobby_reference_matches_the_circuit():
    from uzkge_tpu_torch.hash.anemoi import eval_stream_cipher, eval_variable_length_hash
    from uzkge_tpu_torch.matchmaking.app import build_cs

    ids, seed, number = ref_mm.lobby(random.Random(4), 7)
    assert anemoi.hash_vl([seed]) == eval_variable_length_hash([seed])
    assert anemoi.stream_cipher([seed, number], 49) == eval_stream_cipher([seed, number], 49)
    cs, outs = build_cs(ids, seed, number, 7)
    witness = cs.get_and_clear_witness()
    assert ref_mm.matched(ids, seed, number) == [witness[v] for v in outs]
