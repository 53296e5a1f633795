"""The benchmark's plain reference: BN254, BabyJubjub, Anemoi, Keccak and a
TurboPLONK verifier in plain Python integers.  It imports nothing of the
program (`uzkge_tpu_torch`) and nothing of the JAX package, and reads only the
published parameter files and what the program produced, to judge it."""
