"""In-process EVM-semantics execution of the reference's UNCHANGED Solidity
verifier source, the acceptance oracle of the on-chain verifiers.

Counterpart of `uzkge_tpu/evm/`: a Yul-subset interpreter (yul.py) runs the
verifier contracts' assembly blocks verbatim with BN254 precompile shims on
this package's host curve and pairing, and verifier_vm.py wires the
ShuffleVerifier and Groth16Verifier call paths
(contracts/solidity/test/plonk_20.js:1-225 is the reference's equivalent
hardhat flow).  Host code only: nothing here runs on the card.
"""
