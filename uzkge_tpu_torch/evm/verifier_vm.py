"""ShuffleVerifier and Groth16Verifier call paths over the Yul interpreter.

Counterpart of `uzkge_tpu/evm/verifier_vm.py`.  It mirrors the reference's
hardhat acceptance flow (contracts/solidity/test/plonk_20.js:1-225):
`ShuffleService.verify` -> `ShuffleVerifier.verifyShuffle(proof, pi, pkc)`
-> `VerifierKey_N.load` + `ExternalTranscript.load` + calldata loading
-> `PlonkVerifier.verifyShuffleProof` (ShuffleVerifier.sol:19-131,
PlonkVerifier.sol:218-226), every assembly block executed VERBATIM from the
unchanged Solidity sources, with precompiles 0x05-0x08 and the
VerifierKeyExtra data contracts served by shims (yul.py).

The Solidity sources are the reference's (its contracts/solidity/contracts
directory), which this repository does not hold: pass their directory as
`contracts_dir` (the default is contracts/solidity/contracts under the
checkout's root).  Host code only.
"""

import os
import re
from typing import List, Optional

from ..constants.bn254 import R_MOD
from ..hash.keccak import keccak256
from .yul import (
    EvmReturn,
    EvmRevert,
    YulVM,
    extract_assembly_blocks,
    extract_constants,
    parse_block,
)

REFERENCE_CONTRACTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "contracts", "solidity", "contracts")

_VK1_ADDR = 0x1001
_VK2_ADDR = 0x1002


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def _parse_extra_values(src: str) -> List[int]:
    """Extract the `NAME[i] = 0x...;` table of a VerifierKeyExtra contract,
    in index order."""
    vals = []
    for m in re.finditer(r"\[(\d+)\]\s*=\s*(0x[0-9a-fA-F]+);", src):
        assert int(m.group(1)) == len(vals), "extra table not in order"
        vals.append(int(m.group(2), 16))
    return vals


def _selector(sig: str) -> bytes:
    return keccak256(sig.encode())[:4]


def _abi_encode_verify_shuffle(proof: bytes, pi: List[int], pkc: List[int]) -> bytes:
    """calldata for verifyShuffle(bytes,uint256[],uint256[])."""

    def pad32(b: bytes) -> bytes:
        return b + b"\x00" * ((32 - len(b) % 32) % 32)

    proof_sec = len(proof).to_bytes(32, "big") + pad32(proof)
    pi_sec = len(pi).to_bytes(32, "big") + b"".join(v.to_bytes(32, "big") for v in pi)
    pkc_sec = len(pkc).to_bytes(32, "big") + b"".join(v.to_bytes(32, "big") for v in pkc)
    off_proof = 0x60
    off_pi = off_proof + len(proof_sec)
    off_pkc = off_pi + len(pi_sec)
    head = (
        off_proof.to_bytes(32, "big")
        + off_pi.to_bytes(32, "big")
        + off_pkc.to_bytes(32, "big")
    )
    return _selector("verifyShuffle(bytes,uint256[],uint256[])") + head + proof_sec + pi_sec + pkc_sec


class ShuffleVerifierVM:
    """One deck size's verifier stack, parsed once and reusable.

    vk_sources: optional {filename: source} overriding the reference's
    contracts (e.g. the output of tools/gen_solidity_vk.py::gen_solidity_vk
    for a new deck size); defaults to the files in `contracts_dir`."""

    def __init__(self, deck_num: int, vk_sources: Optional[dict] = None,
                 contracts_dir: str = REFERENCE_CONTRACTS):
        self.deck_num = deck_num
        pv_src = _read(os.path.join(contracts_dir, "verifier/PlonkVerifier.sol"))
        sv_src = _read(os.path.join(contracts_dir, "shuffle/ShuffleVerifier.sol"))
        et_src = _read(os.path.join(contracts_dir, "shuffle/ExternalTranscript.sol"))

        def vk_file(name):
            if vk_sources and name in vk_sources:
                return vk_sources[name]
            return _read(os.path.join(contracts_dir, "shuffle", name))

        vk_src = vk_file(f"VerifierKey_{deck_num}.sol")
        e1_src = vk_file(f"VerifierKeyExtra1_{deck_num}.sol")
        e2_src = vk_file(f"VerifierKeyExtra2_{deck_num}.sol")

        self.consts = extract_constants(pv_src)
        # bytes4 selector constants load LEFT-aligned in inline assembly
        for m in re.finditer(r"bytes4\s+internal\s+constant\s+(\w+)\s*=\s*(0x[0-9a-fA-F]{8});", pv_src):
            self.consts[m.group(1)] = int(m.group(2), 16) << 224
        assert self.consts["sig1"] >> 224 == int.from_bytes(_selector("PI_POLY_INDICES_LOC()"), "big")
        assert self.consts["sig2"] >> 224 == int.from_bytes(_selector("PI_POLY_LAGRANGE_LOC()"), "big")

        self.verify_proof_ast = parse_block(extract_assembly_blocks(pv_src)[0])
        self.sv_blocks = [parse_block(b) for b in extract_assembly_blocks(sv_src)]
        assert len(self.sv_blocks) == 3  # proof, public inputs, pkc loaders
        self.et_ast = parse_block(extract_assembly_blocks(et_src)[0])
        self.vk_ast = parse_block(extract_assembly_blocks(vk_src)[0])
        self.extra1 = _parse_extra_values(e1_src)
        self.extra2 = _parse_extra_values(e2_src)
        assert len(self.extra1) == len(self.extra2) == deck_num * 8

    def _extra_shim(self, sig: str, vals: List[int]):
        want = _selector(sig)

        def shim(data: bytes):
            if data[:4] != want:
                return None
            return b"".join(v.to_bytes(32, "big") for v in vals)

        return shim

    def verify_shuffle(self, proof_bytes: bytes, pi_values: List[int],
                       pkc: List[int]) -> bool:
        """Execute ShuffleVerifier.verifyShuffle on our proof bytes.
        pi_values = flattened input cards ‖ output cards (8 words/card);
        pkc = the 24-word public-key commitment."""
        assert len(pi_values) == self.deck_num * 8 and len(pkc) == 24
        calldata = _abi_encode_verify_shuffle(
            proof_bytes, [v % (1 << 256) for v in pi_values], [v % (1 << 256) for v in pkc]
        )
        vm = YulVM(
            calldata,
            contracts={
                _VK1_ADDR: self._extra_shim("PI_POLY_INDICES_LOC()", self.extra1),
                _VK2_ADDR: self._extra_shim("PI_POLY_LAGRANGE_LOC()", self.extra2),
            },
        )
        c = self.consts
        try:
            # _verifyKey(CM_Q0_X_LOC, PI_POLY_RELATED_LOC)
            vm.run(self.vk_ast, {"vk": c["CM_Q0_X_LOC"], "pi": c["PI_POLY_RELATED_LOC"]})
            # ExternalTranscript.load(EXTERNAL_TRANSCRIPT_LENGTH_LOC, n_cards)
            vm.run(self.et_ast, {"loc": c["EXTERNAL_TRANSCRIPT_LENGTH_LOC"],
                                 "num": len(pi_values) // 8})
            # the three calldata-loading blocks (Solidity local `r` in scope)
            for blk in self.sv_blocks:
                vm.run(blk, {**c, "r": R_MOD})
            # PlonkVerifier.verifyProof(vk1, vk2, shuffle_specified=true)
            vm.run(self.verify_proof_ast,
                   {**c, "vk1": _VK1_ADDR, "vk2": _VK2_ADDR, "shuffle_specified": 1})
        except EvmReturn as ret:
            return int.from_bytes(ret.data[:32], "big") == 1
        except EvmRevert:
            return False
        return False  # fell off the end without return(...)


class Groth16VerifierVM:
    """The deployed snarkjs-style Groth16 reveal verifier
    (contracts/verifier/Groth16Verifier.sol) executed verbatim:
    `verifyProof(uint256[8] _proof, uint256[6] _pubSignals)` is one Yul
    assembly block over precompiles 6/7/8."""

    def __init__(self, contracts_dir: str = REFERENCE_CONTRACTS):
        src = _read(os.path.join(contracts_dir, "verifier/Groth16Verifier.sol"))
        self.consts = extract_constants(src)
        self.ast = parse_block(extract_assembly_blocks(src)[0])

    def verify_proof(self, proof8: List[int], pi6: List[int]) -> bool:
        assert len(proof8) == 8 and len(pi6) == 6
        calldata = _selector("verifyProof(uint256[8],uint256[6])") + b"".join(
            (v % (1 << 256)).to_bytes(32, "big") for v in list(proof8) + list(pi6)
        )
        vm = YulVM(calldata)
        try:
            # calldata array args in inline assembly evaluate to their
            # calldata offsets (static arrays: laid out inline after the
            # 4-byte selector)
            vm.run(self.ast, {**self.consts, "_proof": 0x04, "_pubSignals": 0x04 + 8 * 32})
        except EvmReturn as ret:
            return int.from_bytes(ret.data[:32], "big") == 1
        except EvmRevert:
            return False
        return False


def pkc_words(cms: List) -> List[int]:
    """12 affine G1 commitments -> the on-chain 24-word PKC array."""
    out = []
    for p in cms:
        x, y = p if p is not None else (0, 0)
        out += [x, y]
    return out
