"""Anemoi-Jive254 protocol constants.

Extracted from the reference (uzkge/src/anemoi/bn254/mod.rs) by
tools/extract_constants.py.  These are interoperability-required hash
constants (like SHA-2 round constants), all elements of BN254 Fr.
"""

N_ANEMOI_ROUNDS = 14
MDS_MATRIX = [[1, 5],
    [5, 26]]
