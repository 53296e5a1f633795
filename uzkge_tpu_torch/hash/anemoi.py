"""AnemoiJive254 algebraic hash: native evaluation + circuit traces.

Reference: uzkge/src/anemoi/mod.rs (trait algorithms) and
uzkge/src/anemoi/bn254/mod.rs (constants, extracted into
constants/anemoi_constants.py).  N = 2 columns, 14 rounds, S-box alpha = 5,
MDS [[1, g], [g, g^2+1]] with g = 5.

The *_with_trace evaluators record the per-round states consumed by the
PLONK gadget (plonk/constraint_system/anemoi/mod.rs) to fill witnesses —
this trace-native/constrain-in-circuit split mirrors the reference design.

Host-side python ints: hashing happens during witness generation and
Fiat-Shamir (tiny data); bulk hashing is not on the proving hot path.
"""

from dataclasses import dataclass, field
from typing import List, Tuple

from ..constants.bn254 import R_MOD as P
from ..constants.anemoi_constants import (
    N_ANEMOI_ROUNDS,
    GENERATOR,
    GENERATOR_INV,
    MDS_MATRIX,
    ROUND_KEYS_X,
    ROUND_KEYS_Y,
    PREPROCESSED_ROUND_KEYS_X,
    PREPROCESSED_ROUND_KEYS_Y,
)

ALPHA = 5
ALPHA_INV = pow(5, -1, P - 1)
RATE = 3  # 2*N - 1 with N = 2


def _mds_in_place(x, y):
    """x <- M x;  y <- M (y rotated by one word)."""
    m = MDS_MATRIX
    nx = [(m[0][0] * x[0] + m[0][1] * x[1]) % P, (m[1][0] * x[0] + m[1][1] * x[1]) % P]
    oy = [y[1], y[0]]
    ny = [(m[0][0] * oy[0] + m[0][1] * oy[1]) % P, (m[1][0] * oy[0] + m[1][1] * oy[1]) % P]
    return nx, ny


def _round(x, y, r):
    x = [(x[i] + ROUND_KEYS_X[r][i]) % P for i in range(2)]
    y = [(y[i] + ROUND_KEYS_Y[r][i]) % P for i in range(2)]
    x, y = _mds_in_place(x, y)
    y = [(y[i] + x[i]) % P for i in range(2)]
    x = [(x[i] + y[i]) % P for i in range(2)]
    # open Flystel S-box
    for i in range(2):
        x[i] = (x[i] - GENERATOR * y[i] * y[i]) % P
        y[i] = (y[i] - pow(x[i], ALPHA_INV, P)) % P
        x[i] = (x[i] + GENERATOR * y[i] * y[i] + GENERATOR_INV) % P
    return x, y


def _final_linear(x, y):
    x, y = _mds_in_place(x, y)
    y = [(y[i] + x[i]) % P for i in range(2)]
    x = [(x[i] + y[i]) % P for i in range(2)]
    return x, y


def anemoi_permutation(x, y):
    """One full Anemoi permutation on state ([x0,x1], [y0,y1])."""
    for r in range(N_ANEMOI_ROUNDS):
        x, y = _round(x, y, r)
    return _final_linear(x, y)


def _permutation_with_rounds(x, y):
    """Permutation returning (x, y, per-round states before the next round's
    constant additions) — the gadget's intermediate values."""
    inter_x, inter_y = [], []
    for r in range(N_ANEMOI_ROUNDS):
        x, y = _round(x, y, r)
        inter_x.append(list(x))
        inter_y.append(list(y))
    x, y = _final_linear(x, y)
    return x, y, (inter_x, inter_y)


def _pad(input_list):
    inp = list(input_list)
    if len(inp) % RATE == 0 and len(inp) > 0:
        sigma = 1
    else:
        inp.append(1)
        if len(inp) % RATE != 0:
            inp.extend([0] * (RATE - len(inp) % RATE))
        sigma = 0
    return inp, sigma


@dataclass
class AnemoiVLHTrace:
    """Mirrors reference AnemoiVLHTrace (anemoi/traces.rs:6-60)."""

    input: List[int] = field(default_factory=list)
    before_permutation: List[Tuple[list, list]] = field(default_factory=list)
    intermediate_values: List[Tuple[list, list]] = field(default_factory=list)
    after_permutation: List[Tuple[list, list]] = field(default_factory=list)
    output: int = 0


@dataclass
class AnemoiStreamCipherTrace:
    input: List[int] = field(default_factory=list)
    before_permutation: List[Tuple[list, list]] = field(default_factory=list)
    intermediate_values: List[Tuple[list, list]] = field(default_factory=list)
    after_permutation: List[Tuple[list, list]] = field(default_factory=list)
    output: List[int] = field(default_factory=list)


def eval_variable_length_hash(input_list) -> int:
    inp, sigma = _pad(input_list)
    x, y = [0, 0], [0, 0]
    for c in range(0, len(inp), RATE):
        chunk = inp[c : c + RATE]
        x = [(x[0] + chunk[0]) % P, (x[1] + chunk[1]) % P]
        y = [(y[0] + chunk[2]) % P, y[1]]
        x, y = anemoi_permutation(x, y)
    y[1] = (y[1] + sigma) % P
    return x[0]


def eval_variable_length_hash_with_trace(input_list) -> AnemoiVLHTrace:
    trace = AnemoiVLHTrace(input=list(input_list))
    inp, sigma = _pad(input_list)
    x, y = [0, 0], [0, 0]
    for c in range(0, len(inp), RATE):
        chunk = inp[c : c + RATE]
        x = [(x[0] + chunk[0]) % P, (x[1] + chunk[1]) % P]
        y = [(y[0] + chunk[2]) % P, y[1]]
        trace.before_permutation.append((list(x), list(y)))
        x, y, inter = _permutation_with_rounds(x, y)
        trace.intermediate_values.append(inter)
        trace.after_permutation.append((list(x), list(y)))
    y[1] = (y[1] + sigma) % P
    trace.output = x[0]
    return trace


def eval_stream_cipher(input_list, output_len: int) -> List[int]:
    return eval_stream_cipher_with_trace(input_list, output_len).output


def eval_stream_cipher_with_trace(input_list, output_len: int) -> AnemoiStreamCipherTrace:
    trace = AnemoiStreamCipherTrace(input=list(input_list))
    inp, sigma = _pad(input_list)
    x, y = [0, 0], [0, 0]

    def permute():
        nonlocal x, y
        trace.before_permutation.append((list(x), list(y)))
        nx, ny, inter = _permutation_with_rounds(x, y)
        trace.intermediate_values.append(inter)
        trace.after_permutation.append((list(nx), list(ny)))
        x, y = nx, ny

    for c in range(0, len(inp), RATE):
        chunk = inp[c : c + RATE]
        x = [(x[0] + chunk[0]) % P, (x[1] + chunk[1]) % P]
        y = [(y[0] + chunk[2]) % P, y[1]]
        permute()
    y[1] = (y[1] + sigma) % P

    out = []
    if output_len <= 2:
        out = x[:output_len]
    elif output_len == 3:
        out = x + y[:1]
    else:
        out = x + y[:1]
        squeezes = output_len // RATE - 1
        remaining = output_len % RATE
        for _ in range(squeezes):
            permute()
            out += x + y[:1]
        if remaining > 0:
            permute()
            out += (x + y)[:remaining]
    trace.output = out
    return trace


def sanity_check_preprocessed_keys():
    """The preprocessed round keys are the constant contributions of the round
    keys after MDS + the 'y += x; x += y' mixing:
        prk_y[r] = M(rk_x[r]) + M(rot(rk_y[r]))
        prk_x[r] = M(rk_x[r]) + prk_y[r]
    (these constants appear directly in the gadget's four per-round equations,
    turbo/mod.rs:1098-1142)."""
    ok = True
    for r in range(N_ANEMOI_ROUNDS):
        mx, my = _mds_in_place(list(ROUND_KEYS_X[r]), list(ROUND_KEYS_Y[r]))
        py = [(mx[i] + my[i]) % P for i in range(2)]
        px = [(mx[i] + py[i]) % P for i in range(2)]
        ok &= px == list(PREPROCESSED_ROUND_KEYS_X[r])
        ok &= py == list(PREPROCESSED_ROUND_KEYS_Y[r])
    return ok
