"""ctypes wrapper over the native host-math library (csrc/hostmath.c).

Builds the shared object when imported, with the system C compiler (no pip
dependencies), so that no proof pays for the build, and exposes the prover's
host-side hot loops; a failed build raises.

All scalars and coordinates cross the boundary as 32-byte little-endian
standard-form blobs.
"""

import ctypes
import os
import subprocess
import tempfile

from . import kernels
from .constants.bn254 import R_MOD

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "csrc", "hostmath.c")
_SO = os.path.join(_DIR, "build", "hostmath.so")


def _build():
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        # build beside the target and rename, so that concurrent processes
        # never load a half-written object
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_SO))
        os.close(fd)
        subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
                       check=True, capture_output=True)
        os.replace(tmp, _SO)
    lib = ctypes.CDLL(_SO)
    c = ctypes.c_char_p
    u64 = ctypes.c_uint64
    pu64 = ctypes.POINTER(ctypes.c_uint64)
    lib.horner_eval.argtypes = [c, u64, c, c]
    lib.z_poly.argtypes = [c, pu64, c, c, c, c, u64, c]
    lib.lincomb.argtypes = [c, pu64, c, u64, u64, c]
    lib.synthetic_div.argtypes = [c, u64, c, c, c]
    lib.alpha_combine.argtypes = [c, pu64, u64, c, c, u64, c, c]
    lib.g1_blind.argtypes = [c, ctypes.c_int, c, c, u64, c]
    lib.g1_blind.restype = ctypes.c_int
    return lib


_lib = _build()


def _pack(vals):
    return b"".join(int(v).to_bytes(32, "little") for v in vals)


def horner_eval_bytes(coefs_blob: bytes, x: int) -> int:
    out = ctypes.create_string_buffer(32)
    _lib.horner_eval(coefs_blob, len(coefs_blob) // 32, _pack([x]), out)
    return int.from_bytes(out.raw, "little")


def lincomb_bytes(row_blobs, scalars, out_len: int) -> bytes:
    """sum_i scalars[i] * rows[i] as a coefficient blob of out_len."""
    rows_buf = b"".join(row_blobs)
    lens = (ctypes.c_uint64 * len(row_blobs))(*[len(r) // 32 for r in row_blobs])
    out = ctypes.create_string_buffer(32 * out_len)
    _lib.lincomb(rows_buf, lens, _pack(scalars), len(row_blobs), out_len, out)
    return out.raw


def alpha_combine_bytes(row_blobs, alpha: int, point: int, out_len: int):
    """h = sum alpha^i (p_i - p_i(point)); returns (h coefficient blob,
    evaluation blob)."""
    rows_buf = b"".join(row_blobs)
    lens = (ctypes.c_uint64 * len(row_blobs))(*[len(r) // 32 for r in row_blobs])
    out = ctypes.create_string_buffer(32 * out_len)
    evals = ctypes.create_string_buffer(32 * len(row_blobs))
    _lib.alpha_combine(rows_buf, lens, len(row_blobs), _pack([alpha]), _pack([point]), out_len,
                       out, evals)
    return out.raw, evals.raw


def synthetic_div_bytes(coefs_blob: bytes, z: int):
    """Returns (quotient coefficient blob, remainder) of coefs / (X - z)."""
    n = len(coefs_blob) // 32
    out = ctypes.create_string_buffer(32 * (n - 1))
    rem = ctypes.create_string_buffer(32)
    _lib.synthetic_div(coefs_blob, n, _pack([z]), out, rem)
    return out.raw, int.from_bytes(rem.raw, "little")


def z_poly_bytes(witness_blob: bytes, perm, group_blob: bytes, k, beta: int, gamma: int, n: int) -> bytes:
    pbuf = (ctypes.c_uint64 * len(perm))(*perm)
    out = ctypes.create_string_buffer(32 * n)
    _lib.z_poly(witness_blob, pbuf, group_blob, _pack(k), _pack([beta]), _pack([gamma]), n, out)
    return out.raw


def g1_blind(cm, points, scalars):
    """cm + sum_i scalars[i] * points[i] on BN254 G1, points as
    curve/bn254.py has them (affine (x, y) tuples, None the identity), in one
    native call (counted in `kernels.CALLS["g1_blind"]`); equal to folding
    `g1_add` over `g1_mul(points[i], scalars[i])`."""
    terms = [(p, s % R_MOD) for p, s in zip(points, scalars) if p is not None]
    out = ctypes.create_string_buffer(64)
    inf = _lib.g1_blind(_pack(cm or (0, 0)), cm is None, _pack(c for p, _ in terms for c in p),
                        _pack(s for _, s in terms), len(terms), out)
    kernels.count("g1_blind", kernels.CALLS)
    if inf:
        return None
    return int.from_bytes(out.raw[:32], "little"), int.from_bytes(out.raw[32:], "little")
