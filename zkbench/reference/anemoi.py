"""Anemoi-Jive254 (uzkge src/anemoi): the permutation, the variable-length
hash and the stream cipher, two columns, 14 rounds, x^5 S-box."""

from .anemoi_constants import GENERATOR, GENERATOR_INV, MDS_MATRIX, N_ANEMOI_ROUNDS, ROUND_KEYS_X, \
    ROUND_KEYS_Y
from .bn254 import R_MOD as P

_ALPHA_INV = pow(5, -1, P - 1)
RATE = 3


def _mds(x, y):
    m = MDS_MATRIX
    nx = [(m[0][0] * x[0] + m[0][1] * x[1]) % P, (m[1][0] * x[0] + m[1][1] * x[1]) % P]
    ny = [(m[0][0] * y[1] + m[0][1] * y[0]) % P, (m[1][0] * y[1] + m[1][1] * y[0]) % P]
    return nx, ny


def permutation(x, y):
    for r in range(N_ANEMOI_ROUNDS):
        x = [(x[i] + ROUND_KEYS_X[r][i]) % P for i in range(2)]
        y = [(y[i] + ROUND_KEYS_Y[r][i]) % P for i in range(2)]
        x, y = _mds(x, y)
        y = [(y[i] + x[i]) % P for i in range(2)]
        x = [(x[i] + y[i]) % P for i in range(2)]
        for i in range(2):
            x[i] = (x[i] - GENERATOR * y[i] * y[i]) % P
            y[i] = (y[i] - pow(x[i], _ALPHA_INV, P)) % P
            x[i] = (x[i] + GENERATOR * y[i] * y[i] + GENERATOR_INV) % P
    x, y = _mds(x, y)
    y = [(y[i] + x[i]) % P for i in range(2)]
    x = [(x[i] + y[i]) % P for i in range(2)]
    return x, y


def _absorb(values):
    inp = list(values)
    if inp and len(inp) % RATE == 0:
        sigma = 1
    else:
        inp.append(1)
        inp.extend([0] * (-len(inp) % RATE))
        sigma = 0
    x, y = [0, 0], [0, 0]
    for c in range(0, len(inp), RATE):
        x = [(x[0] + inp[c]) % P, (x[1] + inp[c + 1]) % P]
        y = [(y[0] + inp[c + 2]) % P, y[1]]
        x, y = permutation(x, y)
    y[1] = (y[1] + sigma) % P
    return x, y


def hash_vl(values) -> int:
    return _absorb(values)[0][0]


def stream_cipher(values, n_out: int):
    x, y = _absorb(values)
    if n_out <= 2:
        return x[:n_out]
    out = x + y[:1]
    if n_out == 3:
        return out
    for _ in range(n_out // RATE - 1):
        x, y = permutation(x, y)
        out += x + y[:1]
    if n_out % RATE:
        x, y = permutation(x, y)
        out += (x + y)[:n_out % RATE]
    return out
