"""The port's EVM (uzkge_tpu_torch/evm/) against the JAX package's, on the CPU.

The reference's Solidity contracts are not in this repository, so the
verifier call paths cannot run here through the real PlonkVerifier; these
tests hold the parts that can run against the JAX package's, exactly:

* a table of inline Yul snippets through both packages' `YulVM`: the same
  outcome (return, revert or the error raised, with its data), the same
  memory, the same outer environment afterwards;
* the precompiles 0x05-0x08 on valid and invalid input, byte for byte;
* `_abi_encode_verify_shuffle` and `pkc_words` on seeded inputs;
* `Groth16VerifierVM` on a stand-in Groth16Verifier.sol in a temporary
  contracts directory (the call path: calldata layout, constants, the
  assembly block's return), and a missing directory refused by both.
"""

import random

import pytest

from uzkge_tpu.evm import verifier_vm as jvm
from uzkge_tpu.evm import yul as jyul
from uzkge_tpu_torch.constants.bn254 import Q_MOD, R_MOD
from uzkge_tpu_torch.curve.bn254 import G1_GEN, G2_GEN, g1_mul, g1_neg, g2_mul
from uzkge_tpu_torch.evm import verifier_vm as tvm
from uzkge_tpu_torch.evm import yul as tyul

CALLDATA = bytes(range(1, 41))  # 40 bytes: calldataload past the end pads zeros

SNIPPETS = {
    "wraparound": """{
        let m := not(0)
        mstore(0, add(m, 2))
        mstore(32, sub(0, 1))
        mstore(64, mul(m, m))
        mstore(96, exp(2, 256))
        mstore(128, exp(3, 200))
        mstore(160, sub(5, 7))
        return(0, 192)
    }""",
    "division_by_zero": """{
        let m := not(0)
        mstore(0, div(7, 0))
        mstore(32, mod(7, 0))
        mstore(64, mulmod(5, 6, 0))
        mstore(96, addmod(5, 6, 0))
        mstore(128, div(m, 3))
        mstore(160, mod(m, 1000))
        mstore(192, mulmod(m, m, 7))
        mstore(224, addmod(m, m, 11))
        return(0, 256)
    }""",
    "bitwise_and_compare": """{
        let m := not(0)
        mstore(0, and(0xff00ff, 0x0ff0f0))
        mstore(32, or(0xff00ff, 0x0ff0f0))
        mstore(64, xor(0xff00ff, 0x0ff0f0))
        mstore(96, shl(255, 3))
        mstore(128, shl(256, 1))
        mstore(160, shr(1, m))
        mstore(192, shr(300, m))
        mstore(224, add(add(lt(1, 2), gt(1, 2)), add(eq(m, sub(0, 1)), iszero(0))))
        mstore(256, add(iszero(5), lt(m, 0)))
    }""",
    "mstore8_and_memory_growth": """{
        mstore8(5, 0x1ff)
        mstore8(31, 0xab)
        mstore(40, mload(0))
        mstore(72, mload(1000))
        mstore8(1100, 7)
        return(0, 104)
    }""",
    "calldataload_past_the_end": """{
        mstore(0, calldataload(0))
        mstore(32, calldataload(20))
        mstore(64, calldataload(39))
        mstore(96, calldataload(100))
        mstore(128, calldatasize())
        return(0, 160)
    }""",
    "keccak256_over_memory": """{
        mstore(0, 0x1234)
        mstore(32, keccak256(0, 32))
        mstore(64, keccak256(7, 0))
        mstore(96, keccak256(16, 100))
        mstore(300, keccak256(0, 1))
        return(0, 332)
    }""",
    "let_assign_if_for": """{
        let acc := 0
        let i
        for { let j := 0 } lt(j, 10) { j := add(j, 1) } {
            acc := add(acc, mul(j, j))
            if eq(j, 4) { i := j }
        }
        if gt(acc, 1000) { acc := 0 }
        { let shadow := 99 mstore(96, shadow) }
        mstore(0, acc)
        mstore(32, i)
        mstore(64, true)
        mstore(128, false)
    }""",
    "functions": """{
        function sq(x) -> y { y := mul(x, x) }
        function sum3(a, b, c) -> s { s := add(add(a, b), sq(c)) }
        function store(off, v) { mstore(off, v) }
        function early(x) -> r {
            r := 1
            if x { r := 2 }
        }
        store(0, sum3(1, 2, 3))
        store(32, early(0))
        store(64, early(5))
        store(96, sq(sq(3)))
        pop(sq(7))
        mstore(128, gas())
        return(0, 160)
    }""",
    "literals": """{
        mstore(0, 0xDeadBeef)
        mstore(32, 1234567890123456789012345678901234567890)
        mstore(64, 0x30644e72e131a029b85045b68181585d97816a916871ca8d3c208c16d87cfd47)
        mstore(96, add(true, true))
        return(0, 128)
    }""",
    "string_literal_is_not_tokenized": """{
        mstore(0, "abc")
    }""",
    "revert_with_data": """{
        mstore(0, 0x08c379a0)
        mstore(32, 42)
        revert(28, 36)
        mstore(0, 1)
    }""",
    "outer_environment": """{
        mstore(add(vk, 0x20), mul(pi, 3))
        vk := add(vk, 1)
        function f(x) -> y { y := add(x, pi) }
        mstore(0, f(1))
    }""",
    "staticcall": """{
        mstore(0, 32)
        mstore(32, 32)
        mstore(64, 32)
        mstore(96, 3)
        mstore(128, 200)
        mstore(160, 1000007)
        let ok := staticcall(gas(), 0x05, 0, 192, 256, 32)
        mstore(288, ok)
        mstore(320, staticcall(gas(), 0x1001, 0, 4, 352, 64))
        mstore(416, staticcall(gas(), 0x1002, 0, 4, 448, 64))
        mstore(512, staticcall(gas(), 0x01, 0, 32, 544, 32))
        mstore(576, staticcall(gas(), 0x1001, 0, 4, 608, 8))
    }""",
    "undefined_identifier": """{
        mstore(0, 5)
        mstore(32, nothing)
    }""",
    "unknown_builtin": """{
        sstore(0, 1)
    }""",
    "assignment_to_undeclared": """{
        nowhere := 3
    }""",
}


def _contract(data: bytes):
    return b"\x11" * 40 if data[:4] == bytes(4) else None


def _contract_none(data: bytes):
    return None


def _run(mod, src):
    """Parse and run `src` through `mod`'s YulVM; returns (outcome, memory,
    environment afterwards)."""
    env = {"vk": 0x200, "pi": 7}
    vm = mod.YulVM(CALLDATA, contracts={0x1001: _contract, 0x1002: _contract_none})
    try:
        vm.run(mod.parse_block(src), env)
        outcome = ("end", None)
    except mod.EvmReturn as r:
        outcome = ("return", r.data)
    except mod.EvmRevert as r:
        outcome = ("revert", r.data)
    except (SyntaxError, NameError) as e:
        outcome = ("error", type(e).__name__)
    return outcome, bytes(vm.memory), env


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_yul_snippet_matches_jax(name):
    got = _run(tyul, SNIPPETS[name])
    want = _run(jyul, SNIPPETS[name])
    assert got == want
    if name in ("undefined_identifier", "unknown_builtin", "assignment_to_undeclared"):
        assert got[0] == ("error", "NameError")
    elif name == "string_literal_is_not_tokenized":
        assert got[0] == ("error", "SyntaxError")
    else:
        assert got[0][0] in ("end", "return", "revert") and got[1]
    if name == "staticcall":
        mem = got[1]
        assert mem[256:288] == pow(3, 200, 1000007).to_bytes(32, "big")
        assert [mem[o + 31] for o in (288, 320, 416, 512, 576)] == [1, 1, 0, 0, 1]


def test_yul_snippets_cover_every_builtin():
    """Every builtin `_builtin` handles is called by some snippet."""
    import inspect
    import re

    handled = set(re.findall(r'if name == "(\w+)"', inspect.getsource(tyul.YulVM._builtin)))
    called = set()
    for src in SNIPPETS.values():
        called |= set(re.findall(r"\b(\w+)\(", src))
    assert len(handled) == 29 and handled <= called, handled - called


def test_yul_source_helpers_match_jax():
    sol = """
    contract C {
        uint256 constant A = 0x10 + 2 * (3 - 1);
        uint256 internal constant B = 21888242871839275222246405745257275088548364400416034343698204186575808495617;
        uint16 constant C_ = 7;
        function f() public {
            assembly { /* { not a block */ mstore(0, A) // } nor this
                { let x := B }
            }
            uint x = 1;
            assembly { mstore(32, C_) }
        }
    }"""
    assert tyul.extract_constants(sol) == jyul.extract_constants(sol)
    assert tyul.extract_assembly_blocks(sol) == jyul.extract_assembly_blocks(sol)
    assert len(tyul.extract_assembly_blocks(sol)) == 2
    for src in SNIPPETS.values():
        if '"' not in src:
            assert tyul.tokenize(src) == jyul.tokenize(src)
            assert tyul.parse_block(src) == jyul.parse_block(src)
    bad = "uint256 constant X = foo();"
    with pytest.raises(ValueError):
        tyul.extract_constants(bad)
    with pytest.raises(ValueError):
        jyul.extract_constants(bad)


# ------------------------------------------------------------- precompiles


def _w(v: int) -> bytes:
    return (v % (1 << 256)).to_bytes(32, "big")


def _g1(p) -> bytes:
    return _w(0) + _w(0) if p is None else _w(p[0]) + _w(p[1])


def _g2(q) -> bytes:
    (x_re, x_im), (y_re, y_im) = q
    return _w(x_im) + _w(x_re) + _w(y_im) + _w(y_re)


P5 = g1_mul(G1_GEN, 5)
OFF_CURVE = (1, 3)

PRECOMPILE_CASES = {
    "modexp": (5, _w(1) + _w(1) + _w(3) + bytes([3]) + bytes([200]) + (1000007).to_bytes(3, "big")),
    "modexp_wide": (5, _w(32) + _w(32) + _w(32) + _w(Q_MOD - 2) + _w(R_MOD - 1) + _w(Q_MOD)),
    "modexp_zero_modulus": (5, _w(1) + _w(1) + _w(4) + bytes([3]) + bytes([5]) + bytes(4)),
    "modexp_truncated": (5, _w(2) + _w(2) + _w(3) + bytes([1, 2, 3])),
    "ecadd": (6, _g1(G1_GEN) + _g1(P5)),
    "ecadd_identity": (6, _g1(None) + _g1(P5)),
    "ecadd_both_identity": (6, _g1(None) + _g1(None)),
    "ecadd_to_identity": (6, _g1(P5) + _g1(g1_neg(P5))),
    "ecadd_doubling": (6, _g1(P5) + _g1(P5)),
    "ecadd_off_curve": (6, _g1(OFF_CURVE) + _g1(P5)),
    "ecmul": (7, _g1(G1_GEN) + _w(123456789)),
    "ecmul_by_zero": (7, _g1(P5) + _w(0)),
    "ecmul_by_r": (7, _g1(P5) + _w(R_MOD)),
    "ecmul_identity": (7, _g1(None) + _w(9)),
    "ecmul_off_curve": (7, _g1(OFF_CURVE) + _w(2)),
    "pairing_empty": (8, b""),
    "pairing_bad_length": (8, _g1(G1_GEN) + _g2(G2_GEN)[:100]),
    "pairing_off_curve": (8, _g1(OFF_CURVE) + _g2(G2_GEN)),
    "pairing_identity_skipped": (8, _g1(None) + _g2(G2_GEN)),
    "unknown_address": (1, _w(1)),
}


@pytest.mark.parametrize("name", sorted(PRECOMPILE_CASES))
def test_precompile_matches_jax(name):
    addr, data = PRECOMPILE_CASES[name]
    got = tyul.precompile(addr, data)
    assert got == jyul.precompile(addr, data)
    if name.endswith(("off_curve", "bad_length")) or name == "unknown_address":
        assert got is None
    else:
        assert got is not None
    if name in ("ecmul_by_zero", "ecmul_by_r", "ecadd_to_identity", "ecadd_both_identity"):
        assert got == bytes(64)
    if name == "modexp_zero_modulus":
        assert got == bytes(4)


@pytest.mark.parametrize("is_one", [True, False])
def test_pairing_precompile_matches_jax(is_one):
    """e(aP, bQ) * e(-abP, Q) is one; with +abP it is not."""
    a, b = 1234567, 7654321
    ab = g1_mul(G1_GEN, a * b)
    data = (_g1(g1_mul(G1_GEN, a)) + _g2(g2_mul(G2_GEN, b))
            + _g1(g1_neg(ab) if is_one else ab) + _g2(G2_GEN))
    got = tyul.precompile(8, data)
    assert got == jyul.precompile(8, data) == _w(int(is_one))


# ------------------------------------------------------- ABI and pkc words


def test_abi_encoding_and_pkc_words_match_jax():
    rng = random.Random(13)
    for n_cards, proof_len in ((20, 0x660), (52, 0x660), (3, 37)):
        proof = bytes(rng.randrange(256) for _ in range(proof_len))
        pi = [rng.randrange(R_MOD) for _ in range(n_cards * 8)]
        pkc = [rng.randrange(Q_MOD) for _ in range(24)]
        got = tvm._abi_encode_verify_shuffle(proof, pi, pkc)
        assert got == jvm._abi_encode_verify_shuffle(proof, pi, pkc)
        assert got[:4] == tvm._selector("verifyShuffle(bytes,uint256[],uint256[])")
        assert len(got) == 4 + 3 * 32 + 32 + -(-proof_len // 32) * 32 + 32 * (2 + len(pi) + 24)
    cms = [g1_mul(G1_GEN, rng.randrange(1, R_MOD)) for _ in range(11)] + [None]
    assert tvm.pkc_words(cms) == jvm.pkc_words(cms)
    assert tvm.pkc_words(cms)[-2:] == [0, 0] and len(tvm.pkc_words(cms)) == 24


# ------------------------------------------------------------- call paths

_G16_STANDIN = """// a stand-in with the deployed verifier's interface, not the verifier
pragma solidity ^0.8.0;
contract Groth16Verifier {
    uint256 constant q   = 21888242871839275222246405745257275088696311157297823662689037894645226208583;
    uint256 constant deltax1 = 0x10 + 5;
    function verifyProof(uint[8] calldata _proof, uint[6] calldata _pubSignals) public view returns (bool) {
        assembly {
            function checkField(v) {
                if iszero(lt(v, q)) {
                    mstore(0, 0)
                    return(0, 0x20)
                }
            }
            checkField(calldataload(add(_pubSignals, 0)))
            let acc := 0
            for { let i := 0 } lt(i, 8) { i := add(i, 1) } {
                acc := addmod(acc, calldataload(add(_proof, mul(i, 32))), q)
            }
            mstore(0x80, acc)
            let ok := staticcall(sub(gas(), 2000), 6, 0x100, 0x80, 0x100, 0x40)
            mstore(0, and(ok, eq(calldataload(add(_pubSignals, 160)), add(acc, deltax1))))
            return(0, 0x20)
        }
    }
}
"""


def test_groth16_call_path_matches_jax(tmp_path):
    (tmp_path / "verifier").mkdir()
    (tmp_path / "verifier" / "Groth16Verifier.sol").write_text(_G16_STANDIN)
    t, j = tvm.Groth16VerifierVM(str(tmp_path)), jvm.Groth16VerifierVM(str(tmp_path))
    assert t.consts == j.consts and t.consts["deltax1"] == 21
    rng = random.Random(5)
    proof = [rng.randrange(Q_MOD) for _ in range(8)]
    acc = sum(proof) % Q_MOD
    for last, big in ((acc + 21, False), (acc + 22, False), (acc + 21, True)):
        pi = [Q_MOD if big else 1, 2, 3, 4, 5, last]
        got = t.verify_proof(proof, pi)
        assert got == j.verify_proof(proof, pi)
        assert got is (last == acc + 21 and not big)


def test_verifier_vms_need_the_contracts(tmp_path):
    for mod in (tvm, jvm):
        with pytest.raises(FileNotFoundError):
            mod.Groth16VerifierVM(str(tmp_path))
        with pytest.raises(FileNotFoundError):
            mod.ShuffleVerifierVM(52, contracts_dir=str(tmp_path))
    assert tvm.REFERENCE_CONTRACTS.endswith("contracts/solidity/contracts")
