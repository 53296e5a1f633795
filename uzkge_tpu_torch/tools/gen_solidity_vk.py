"""Generate the Solidity verifier-key contracts (VerifierKey_N.sol +
VerifierKeyExtra{1,2}_N.sol) from a VerifierParams: the Python equivalent of
the reference's tera-based codegen (uzkge/src/gen_params/solidity.rs:17-146).
Counterpart of the JAX package's `tools/gen_solidity_vk.py`, whose output it
equals source for source (tests/test_torch_tools.py).

The output is meant to be byte-identical to the reference's deployed
contracts (its contracts/solidity/contracts/shuffle/VerifierKey*_{20,52}.sol),
including the Extra contracts' ABI: each is a no-argument FUNCTION returning
`uint256[N] memory` (PlonkVerifier.sol:366-371 staticcalls that selector to
load the PI indices/lagrange tables), not a public array.

VerifierKey_N layout (mstore offsets): 32 points (9 q, 5 s, qb, 4 prk,
q_ecc, 12 shuffle-generator), a 768-byte gap for the 12 calldata-loaded
public-key commitment slots, then anemoi g, g_inv, k0..k4, edwards_a,
root-of-unity, cs_size (decimal).

Usage: python -m uzkge_tpu_torch.tools.gen_solidity_vk <n_cards> <out_dir> [--device D]

For 48, 52 and 54 cards the vk is the embedded one; any other deck size is
indexed from scratch (gen_shuffle_prover_params) on `--device`, the card by
default.
"""

import argparse
import os
import sys

from ..constants.bn254 import R_MOD
from ..ff.host_field import Fr

_HEADER = """// SPDX-License-Identifier: UNLICENSED
// Generated file from uzkge/gen-params, DONOT edit!
pragma solidity ^0.8.20;

"""


def _word(v: int) -> str:
    return "0x" + int(v).to_bytes(32, "big").hex()


def gen_solidity_vk(vk, deck_num: int):
    """Returns {filename: source} for the three contracts."""
    entries = []
    off = 0

    def push_point(p):
        nonlocal off
        x, y = p if p is not None else (0, 0)
        entries.append((off, _word(x)))
        off += 32
        entries.append((off, _word(y)))
        off += 32

    def push_scalar(v):
        nonlocal off
        entries.append((off, _word(v)))
        off += 32

    for c in vk.cm_q_vec:
        push_point(c)
    for c in vk.cm_s_vec:
        push_point(c)
    push_point(vk.cm_qb)
    for c in vk.cm_prk_vec:
        push_point(c)
    push_point(vk.cm_q_ecc)
    for c in vk.cm_shuffle_generator_vec:
        push_point(c)
    off += 768  # 12 public-key commitment slots come from calldata
    push_scalar(vk.anemoi_generator)
    push_scalar(vk.anemoi_generator_inv)
    for k in vk.k:
        push_scalar(k)
    push_scalar(vk.edwards_a)
    root = Fr.root_of_unity(vk.cs_size)
    push_scalar(root)
    entries.append((off, str(vk.cs_size)))  # decimal, like the reference
    off += 32

    n_pi = deck_num * 8
    main = (
        _HEADER
        + f"library VerifierKey_{deck_num} {{\n"
        + "    function load(uint256 vk, uint256 pi) internal pure {\n"
        + "        assembly {\n"
        + "            // verifier key\n"
        + "".join(f"            mstore(add(vk, {hex(o)}), {v})\n" for o, v in entries)
        + "            \n"
        + "            /// public inputs length\n"
        + f"            mstore(add(pi, 0x0), {n_pi})\n"
        + "        }\n"
        + "    }\n"
        + "}"  # no trailing newline, matching the committed files
    )

    indices = [pow(root, ci, R_MOD) for ci in vk.public_vars_constraint_indices]
    lagrange = list(vk.lagrange_constants)

    def extra(n_file, name, vals):
        return (
            _HEADER
            + f"contract VerifierKeyExtra{n_file}_{deck_num} {{\n"
            + f"    function {name}() public returns (uint256[{n_pi}] memory) {{\n"
            + "        // The public constrain variables indices.\n"
            + f"        uint256[{n_pi}] memory {name};\n"
            + "        \n"
            + "".join(f"        {name}[{i}] = {_word(v)};\n" for i, v in enumerate(vals))
            + "\n"
            + f"        return {name};\n"
            + "    }\n"
            + "}\n"
        )

    return {
        f"VerifierKey_{deck_num}.sol": main,
        f"VerifierKeyExtra1_{deck_num}.sol": extra(1, "PI_POLY_INDICES_LOC", indices),
        f"VerifierKeyExtra2_{deck_num}.sol": extra(2, "PI_POLY_LAGRANGE_LOC", lagrange),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description="Write VerifierKey_N.sol and "
                                 "VerifierKeyExtra{1,2}_N.sol for an N-card shuffle")
    ap.add_argument("n_cards", type=int)
    ap.add_argument("out_dir")
    ap.add_argument("--device", default=None,
                    help="where a deck size without an embedded vk is indexed (default: the card)")
    args = ap.parse_args(argv)
    from ..gen_params import load_shuffle_verifier_params

    if args.n_cards in (48, 52, 54):
        vk = load_shuffle_verifier_params(args.n_cards)
    else:
        from ..shuffle.app import gen_shuffle_prover_params

        pp, _, _ = gen_shuffle_prover_params(args.n_cards, args.device)
        vk = pp.verifier_params
    os.makedirs(args.out_dir, exist_ok=True)
    for name, src in gen_solidity_vk(vk, args.n_cards).items():
        with open(os.path.join(args.out_dir, name), "w") as f:
            f.write(src)
        print("wrote", os.path.join(args.out_dir, name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
