"""Montgomery arithmetic for BN254 Fr and Fq over torch tensors.

Counterpart of `uzkge_tpu/ff/jax_field.py::MontCtx`.  Both packages keep
field elements in Montgomery form with R = 2^256, so one integer stands for
the same value in both, whatever the limb width:

  * the JAX package stores (..., 16) uint32 arrays of 16-bit limbs;
  * this package stores (..., 8) int32 tensors holding the bit patterns of
    32-bit little-endian limbs — 32 bytes per element, the layout the CUDA
    kernels in `csrc/` read.

The torch-op arithmetic below is the plain version that the CPU runs and
that the kernels are held against.  torch lacks unsigned 32-bit arithmetic
on the CPU, so operations work on a "wide" form: int64 tensors of the eight
32-bit limbs with the limb axis first, (8, ...), so that each per-limb slice
is contiguous.  Sums and differences carry in the int64 lanes and are
resolved by a sequential ripple using the arithmetic shift (a negative lane
is a borrow).  A 32x32-bit product overflows int64, so the multiplication
splits its operands into 16-bit pieces.  Every public operation returns
canonical values (< p).
"""

import numpy as np
import torch

from ..constants.bn254 import Q_MOD, R_MOD
from ..device import resolve

L = 8  # 32-bit limbs per element
W = 8  # int64 lanes per element in the wide form (one per 32-bit limb)
MASK = 0xFFFF
MASK32 = 0xFFFFFFFF


def ints_to_limbs(values) -> np.ndarray:
    """python ints (< 2^256) -> (N, 8) int32 bit patterns of LE 32-bit limbs."""
    blob = b"".join(int(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(blob, dtype="<i4").reshape(-1, L).copy()


def limbs_to_ints(arr) -> list:
    """(..., 8) int32 tensor or array -> flat list of python ints."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    blob = np.ascontiguousarray(arr, dtype="<i4").reshape(-1, L).tobytes()
    return [int.from_bytes(blob[i : i + 32], "little") for i in range(0, len(blob), 32)]


def from_jax_limbs(arr, device=None) -> torch.Tensor:
    """(..., 16) uint32 16-bit limbs (the JAX package's layout, as numpy)
    -> (..., 8) int32 tensor of 32-bit limbs."""
    a = np.asarray(arr).astype(np.uint32)
    v = (a[..., 0::2] & MASK) | ((a[..., 1::2] & MASK) << 16)
    return torch.from_numpy(np.ascontiguousarray(v).view(np.int32)).to(resolve(device))


def to_jax_limbs(t: torch.Tensor) -> np.ndarray:
    """(..., 8) int32 tensor -> (..., 16) uint32 numpy array of 16-bit limbs."""
    v = t.detach().cpu().numpy().astype(np.int32).view(np.uint32)
    out = np.empty(v.shape[:-1] + (2 * L,), np.uint32)
    out[..., 0::2] = v & MASK
    out[..., 1::2] = v >> 16
    return out


def lift(x: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 -> wide (8, ...) int64 of unsigned 32-bit limbs."""
    return (x.to(torch.int64) & MASK32).movedim(-1, 0).contiguous()


def lower(w: torch.Tensor) -> torch.Tensor:
    """wide (8, ...) int64 of canonical limbs -> (..., 8) int32."""
    v = w.movedim(0, -1)
    v = torch.where(v >= 1 << 31, v - (1 << 32), v)
    return v.to(torch.int32).contiguous()


def _ripple(x: torch.Tensor) -> torch.Tensor:
    """Resolve carries (and borrows) of a wide tensor in place: limbs 0..6
    end in [0, 2^32), limb 7 keeps the signed remainder."""
    for j in range(W - 1):
        c = x[j] >> 32
        x[j] &= MASK32
        x[j + 1] += c
    return x


def _pieces(x: torch.Tensor) -> torch.Tensor:
    """wide (8, ...) canonical limbs -> (16, ...) 16-bit pieces, low first."""
    return torch.stack([x & MASK, x >> 16], dim=1).reshape((2 * W,) + x.shape[1:])


class MontField:
    """Montgomery context for one modulus: constants plus the torch-op
    arithmetic on (..., 8) int32 tensors (and on the wide form)."""

    def __init__(self, modulus: int):
        self.p = modulus
        self.R = 1 << 256
        self.r2 = self.R * self.R % modulus
        self.rinv = pow(self.R, -1, modulus)
        self.n0inv = (-pow(modulus, -1, 1 << 16)) % (1 << 16)
        self._p_limbs = [(modulus >> (32 * i)) & MASK32 for i in range(W)]
        self._p_pieces = [(modulus >> (16 * i)) & MASK for i in range(2 * W)]
        self._consts = {}

    # ---------------------------------------------------------- constants

    def _col(self, name: str, values, device, ndim: int) -> torch.Tensor:
        key = (name, str(device))
        t = self._consts.get(key)
        if t is None:
            t = torch.tensor(values, dtype=torch.int64, device=device)
            self._consts[key] = t
        return t.reshape((len(values),) + (1,) * (ndim - 1))

    def _p_col(self, device, ndim: int) -> torch.Tensor:
        """p as wide 32-bit limbs, broadcastable against ndim-dim wide."""
        return self._col("p", self._p_limbs, device, ndim)

    def const(self, value: int, device=None) -> torch.Tensor:
        """(8,) Montgomery limbs of the python int `value`."""
        return self.to_mont_limbs([value], device)[0]

    # ------------------------------------------------- host <-> device

    def to_mont_limbs(self, values, device=None) -> torch.Tensor:
        """python int or list of ints -> Montgomery limbs, (8,) or (N, 8)."""
        scalar = isinstance(values, int)
        vals = [values] if scalar else values
        p, r = self.p, self.R
        arr = ints_to_limbs(v % p * r % p for v in vals)
        out = torch.from_numpy(arr).to(resolve(device))
        return out[0] if scalar else out

    def from_mont_limbs(self, t: torch.Tensor):
        """Montgomery limbs -> python ints (a scalar for a (8,) tensor, a flat
        list otherwise)."""
        out = [v * self.rinv % self.p for v in limbs_to_ints(t)]
        return out[0] if t.dim() == 1 else out

    def from_mont_bytes(self, t: torch.Tensor) -> bytes:
        """Montgomery limbs -> concatenated 32-byte LE standard-form scalars
        (the native host-math format)."""
        return self.from_mont(t).cpu().numpy().astype("<i4").tobytes()

    def to_mont_limbs_from_bytes(self, blob: bytes, device=None) -> torch.Tensor:
        """Packed 32-byte LE standard-form scalars -> (N, 8) Montgomery limbs
        (the conversion runs on `device`)."""
        arr = np.frombuffer(blob, dtype="<i4").reshape(-1, L).copy()
        return self.to_mont(torch.from_numpy(arr).to(resolve(device)))

    # ------------------------------------------------------- wide form

    def wadd(self, a, b):
        s = _ripple(a + b)
        d = _ripple(s - self._p_col(s.device, s.dim()))
        return torch.where(d[W - 1] < 0, s, d)

    def wsub(self, a, b):
        d = _ripple(a - b)
        e = _ripple(d + self._p_col(d.device, d.dim()))
        return torch.where(d[W - 1] < 0, e, d)

    def wneg(self, a):
        return self.wsub(torch.zeros_like(a), a)

    def wmul(self, a, b):
        """CIOS Montgomery product a*b*R^-1 mod p on wide operands, over
        16-bit pieces so that every product fits int64.  Lane i+j of t
        accumulates the piece products of weight 2^(16(i+j)) without
        carrying (each lane stays below 2^38); step i consumes lane i, whose
        low 16 bits the Montgomery digit m clears, and moves its high part
        up.  The result pieces pair up into 32-bit limbs again."""
        shape = torch.broadcast_shapes(a.shape, b.shape)
        a16 = _pieces(a.expand(shape))
        b16 = _pieces(b.expand(shape))
        pc16 = self._col("p16", self._p_pieces, a.device, len(shape))
        n = 2 * W
        t = torch.zeros((2 * n,) + shape[1:], dtype=torch.int64, device=a.device)
        for i in range(n):
            t[i : i + n] += a16 * b16[i]
            m = ((t[i] & MASK) * self.n0inv) & MASK
            t[i : i + n] += pc16 * m
            t[i + 1] += t[i] >> 16
        r = _ripple(t[n::2] + (t[n + 1 :: 2] << 16))
        d = _ripple(r - self._p_col(a.device, len(shape)))
        return torch.where(d[W - 1] < 0, r, d)

    def wconst(self, value_mont_limbs: torch.Tensor, ndim: int):
        """(8,) limbs -> wide constant broadcastable against ndim-dim wide."""
        return lift(value_mont_limbs).reshape((W,) + (1,) * (ndim - 1))

    # ---------------------------------------------- public (..., 8) ops

    def _binary(self, op, a, b):
        shape = torch.broadcast_shapes(a.shape, b.shape)
        return lower(op(lift(a.expand(shape)), lift(b.expand(shape))))

    def add(self, a, b):
        return self._binary(self.wadd, a, b)

    def sub(self, a, b):
        return self._binary(self.wsub, a, b)

    def mul(self, a, b):
        return self._binary(self.wmul, a, b)

    def neg(self, a):
        return lower(self.wneg(lift(a)))

    def to_mont(self, a):
        return self.mul(a, self.const_raw(self.r2, a.device))

    def from_mont(self, a):
        return self.mul(a, self.const_raw(1, a.device))

    def const_raw(self, value: int, device=None) -> torch.Tensor:
        """(8,) limbs of `value` as stored (no Montgomery conversion)."""
        return torch.from_numpy(ints_to_limbs([value])[0]).to(resolve(device))

    def pow_const(self, a, e: int):
        """a^e for a python-int exponent (square and multiply)."""
        if e == 0:
            return self.const(1, a.device).expand(a.shape).clone()
        wa = lift(a)
        result = None
        while e:
            if e & 1:
                result = wa if result is None else self.wmul(result, wa)
            e >>= 1
            if e:
                wa = self.wmul(wa, wa)
        return lower(result)

    def inv(self, a):
        """Fermat inverse a^(p-2)."""
        return self.pow_const(a, self.p - 2)

    def batch_inv(self, a, axis: int = 0):
        """Inverses of every element along `axis` with one Fermat inversion:
        inv_i = prefix_{<i} * suffix_{>i} * total^-1.  All must be nonzero."""
        x = a.movedim(axis, 0)
        one = self.const(1, a.device).expand(x.shape[1:])

        def scan(v):  # inclusive prefix products, log-depth
            v = v.clone()
            d = 1
            while d < v.shape[0]:
                v[d:] = self.mul(v[d:].clone(), v[:-d].clone())
                d *= 2
            return v

        pre = scan(x)
        suf = scan(x.flip(0)).flip(0)
        total_inv = self.inv(pre[-1])
        ex_pre = torch.cat([one[None], pre[:-1]], 0)
        ex_suf = torch.cat([suf[1:], one[None]], 0)
        out = self.mul(self.mul(ex_pre, ex_suf), total_inv.expand(x.shape))
        return out.movedim(0, axis).contiguous()


fr = MontField(R_MOD)
fq = MontField(Q_MOD)
