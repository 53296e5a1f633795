"""Least times of the port's kernels on one H100, from the work their inputs
need, whatever implements it.

Peaks.  Memory: 3.35e12 B/s, NVIDIA's data sheet for the H100 SXM.  Integer
work: a field product is counted as 32-bit multiplies, at 64 multiplies per
SM per clock (the CUDA C Programming Guide's throughput for compute
capability 9.0), times the SMs and the maximum SM clock that the card
reports (132 SMs x 1980 MHz: 1.673e13 multiplies/s).  This peak is derived,
not published.  A Montgomery product over 8 x 32-bit limbs is 264
multiplies: 64 limb products a_j b_i and 64 products m p_j, each a low and
a high half, and the 8 digits m.

A bound is the larger of bytes over the memory peak and products over the
product peak; each input byte is read once and each output byte written
once.
"""

import numpy as np

HBM_BYTES_PER_S = 3.35e12
IMUL_PER_SM_CLOCK = 64
MULS_PER_PRODUCT = 264
LIMB_BYTES = 32  # one field element
# An affine addition of two points given the inverse of x2 - x1: the slope,
# its square and y3, 3 products; the batch inversion that shares one
# inversion among many costs 3 more per element.
AFFINE_ADD_PRODUCTS = 6


def product_rate(sm_count: int, max_sm_mhz: float) -> float:
    """Montgomery products per second at the card's peak integer rate."""
    return sm_count * IMUL_PER_SM_CLOCK * max_sm_mhz * 1e6 / MULS_PER_PRODUCT


def bound_s(nbytes: float, products: float, rate: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, products / rate)


def signed_digits_nonzero(values, c: int) -> int:
    """Nonzero digits of the scalars `values` (ints in [0, 2^256)) written in
    signed radix 2^c, digits in (-2^(c-1), 2^(c-1)]: the table rows a
    fixed-base MSM with 2^(c-1) multiples per window has to add."""
    values = list(values)
    if not values:
        return 0
    raw = np.frombuffer(b"".join(int(v).to_bytes(32, "little") for v in values), np.uint8)
    bits = np.unpackbits(raw.reshape(len(values), 32), axis=1, bitorder="little")
    W = -(-257 // c)  # room for the last carry
    bits = np.pad(bits, ((0, 0), (0, W * c - 256))).reshape(len(values), W, c).astype(np.int64)
    digits = bits @ (1 << np.arange(c, dtype=np.int64))
    half, full = 1 << (c - 1), 1 << c
    carry = np.zeros(len(values), np.int64)
    count = 0
    for w in range(W):
        d = digits[:, w] + carry
        carry = (d > half).astype(np.int64)
        count += int(np.count_nonzero(d - carry * full))
    return count


def fixed_base_query_s(P: int, n: int, nonzero: int, rate: float) -> float:
    """P MSMs of n scalars each over a fixed-base table, `nonzero` table rows
    selected in all: the scalars read out of Montgomery form (one product
    each), every selected row added in (nonzero - P additions, affine), the
    scalars and the rows read, P projective sums written."""
    products = P * n + AFFINE_ADD_PRODUCTS * max(nonzero - P, 0)
    nbytes = P * n * LIMB_BYTES + nonzero * 2 * LIMB_BYTES + P * 3 * LIMB_BYTES
    return bound_s(nbytes, products, rate)


def ntt_twiddle_products(S: int) -> int:
    """Twiddle products of one radix-2 NTT of size S: its (S/2) log2 S
    butterflies less the S - 1 whose twiddle is 1 (in the stage of blocks
    of 2^s, one butterfly in each of the S / 2^s blocks)."""
    return (S // 2) * (S.bit_length() - 1) - (S - 1)


def ntt_pass_s(OUT: int, S: int, IN: int, pre: int, post: int, const: int, rate: float) -> float:
    """One radix-2 NTT pass of size S over OUT x IN columns: every butterfly
    whose twiddle is not 1 multiplies by it, each ladder (pre, post) and the
    constant one product per element; x and the ladders read once, y
    written once."""
    elems = OUT * S * IN
    products = OUT * IN * ntt_twiddle_products(S) + elems * (pre + post + const)
    nbytes = (2 * elems + S // 2 + (pre + post) * S * IN + const) * LIMB_BYTES
    return bound_s(nbytes, products, rate)
