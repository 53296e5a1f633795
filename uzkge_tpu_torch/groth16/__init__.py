"""Groth16 SNARK over BN254 (reference: shuffle/src/reveal_with_snark.rs,
ark-groth16).  Used by zshuffle for the cheap on-chain reveal verification path
(`RevealVerifier.verifyRevealWithSnark`, contracts/shuffle/RevealVerifier.sol:52-57).

The port's counterpart of `uzkge_tpu/groth16/`.  Split:
  r1cs.py    - sparse R1CS builder (host, python ints; circuits are tiny)
  groth16.py - setup / prove / verify; proving MSMs and NTTs run on the card
  reveal.py  - the reveal statement circuit: sk*G = pk  and  sk*e1 = reveal
  ark_r1cs.py, ark_pk.py, ark_prove.py - the reference-interoperable reveal:
               ark-r1cs-std's synthesis, the embedded ark proving key, and
               the ark prover (witness map and G1 MSMs on the card)
"""

from .r1cs import R1CS
from .groth16 import Groth16Pk, Groth16Vk, Groth16Proof, setup, prove, verify
from .reveal import (
    reveal_circuit,
    prove_reveal,
    verify_reveal_snark,
    reveal_setup,
    prove_reveal_onchain,
    verify_reveal_onchain,
)
from .ark_pk import load_reference_groth16_pk
