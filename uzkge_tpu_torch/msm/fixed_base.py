"""Fixed-base signed-window table over BN254 G1: the table build.

Counterpart of the set-up half of `uzkge_tpu/msm/fixed_base.py`
(`FixedBaseTable.__init__`, `_build_bases`, `_build_chunk`,
`pbatch_inv_fq`): for every window w < W = ceil(bits / c), base point i < n
and digit d in [1, D = 2^(c-1)], the affine point d * 2^(c*w) * P_i, built
once per SRS on the table's device.  The query (the MSM over the table) is
not part of this module yet.

Layout: leaf-major rows, row (w*n + i)*D + (d-1) holding x || y as 16 int32
(64 B): a (K, D, 16) int32 tensor, K = W*n.  Byte for byte, that is the JAX
package's CPU table, (D*K, 32) uint16.  The TPU's vertical (D, 32, K) layout
serves only its where-chain select and is not copied.

The build is three hand-written CUDA kernels (csrc/fixed_base.cu) plus the
elementwise product of ff/cuda_field.py, each beside its plain torch-op
version in the same module:

  * fb_bases: per base point, the doubling chain that emits the window bases
    B_w = 2^(c*w) * P_i, projective (the TPU's _bases_kernel);
  * fb_mult_chunk: per (window, point) lane, CH consecutive multiples of B_w
    by mixed additions, projective, and the advanced chain state (the TPU's
    _mult_chunk_kernel);
  * fq_batch_inv: the batch inversion that normalises both to affine (the
    TPU's _prod_kernel and _inv_kernel, through pbatch_inv_fq), one function
    for every size;
  * fp_mont_mul: x * z^-1 and y * z^-1.

The group formulas are msm/msm.py's (`_padd_w`, `_madd_w`) in the plain
versions and field.cuh's (`g1_padd`, `g1_madd`) in the kernels.
"""

import numpy as np
import torch

from .. import kernels
from ..device import resolve
from ..errors import ParameterError
from ..ff.cuda_field import fp_mont_mul
from ..ff.field import fq, lift, lower
from .msm import _madd_w, _padd_w

INV_GROUP = 16  # elements per strided group of one batch-inversion level
INV_ROOTS = 4096  # at most this many roots are inverted by Fermat


# ------------------------------------------------------------ plain versions


def fb_bases_plain(x, y, W: int, c: int):
    """Torch-op version of the fb_bases kernel."""
    X, Y = lift(x), lift(y)
    Z = fq.wconst(fq.const(1, x.device), 2).expand_as(X)
    rows = []
    for w in range(W):
        rows.append((X, Y, Z))
        if w + 1 < W:
            for _ in range(c):
                X, Y, Z = _padd_w(X, Y, Z, X, Y, Z)
    return tuple(lower(torch.cat([r[j] for r in rows], dim=1)) for j in range(3))


def fb_mult_chunk_plain(tx, ty, tz, bx, by, CH: int):
    """Torch-op version of the fb_mult_chunk kernel."""
    T = tuple(lift(t) for t in (tx, ty, tz))
    BX, BY = lift(bx), lift(by)
    emitted = []
    for _ in range(CH):
        emitted.append(T)
        T = _madd_w(*T, BX, BY)
    return tuple(lower(torch.stack([e[j] for e in emitted], dim=1)) for j in range(3)) + \
        tuple(lower(t) for t in T)


def fq_batch_inv_plain(a):
    """Torch-op version of the fq_batch_inv kernel: ff/field.py's batch
    inversion (prefix and suffix products, one Fermat inversion)."""
    return fq.batch_inv(a)


# ------------------------------------------------------------- the kernels


def fb_bases(x, y, W: int, c: int):
    """Window bases of n affine points x, y (n, 8) Fq Montgomery: returns
    projective (X, Y, Z), each (W*n, 8), row w*n + i holding 2^(c*w) * P_i."""
    n, dev = x.shape[0], x.device
    kernels.check(x, "x", (n, 8), dev)
    kernels.check(y, "y", (n, 8), dev)
    if n < 1 or W < 1 or c < 1:
        raise ValueError(f"fb_bases: n = {n}, W = {W}, c = {c}: all must be >= 1")
    if not kernels.use_kernel(dev, "fb_bases"):
        return fb_bases_plain(x, y, W, c)
    out = tuple(torch.empty((W * n, 8), dtype=torch.int32, device=dev) for _ in range(3))
    kernels.launch("fb_bases_launch", x.data_ptr(), y.data_ptr(), *(o.data_ptr() for o in out),
                   n, W, c, kernels.stream_of(x))
    kernels.LAUNCHES["fb_bases"] += 1
    return out


def fb_mult_chunk(tx, ty, tz, bx, by, CH: int):
    """CH consecutive multiples per lane: the chain state T = m * B (tx, ty,
    tz: (K, 8) projective) and the window bases B (bx, by: (K, 8) affine).
    Returns (EX, EY, EZ), each (CH, K, 8) with row j = (m + j) * B, and the
    advanced state (TX, TY, TZ) = (m + CH) * B, each (K, 8)."""
    K, dev = tx.shape[0], tx.device
    for t, name in ((tx, "tx"), (ty, "ty"), (tz, "tz"), (bx, "bx"), (by, "by")):
        kernels.check(t, name, (K, 8), dev)
    if K < 1 or CH < 1:
        raise ValueError(f"fb_mult_chunk: K = {K}, CH = {CH}: both must be >= 1")
    if not kernels.use_kernel(dev, "fb_mult_chunk"):
        return fb_mult_chunk_plain(tx, ty, tz, bx, by, CH)
    out = tuple(torch.empty((CH, K, 8), dtype=torch.int32, device=dev) for _ in range(3)) + \
        tuple(torch.empty((K, 8), dtype=torch.int32, device=dev) for _ in range(3))
    kernels.launch("fb_mult_chunk_launch", *(t.data_ptr() for t in (tx, ty, tz, bx, by)),
                   *(o.data_ptr() for o in out), K, CH, kernels.stream_of(tx))
    kernels.LAUNCHES["fb_mult_chunk"] += 1
    return out


def batch_inv_levels(N: int):
    """The product tree of fq_batch_inv on N elements: a list of (N_l, M_l),
    level l's N_l elements forming M_l = ceil(N_l / INV_GROUP) strided groups
    whose products are level l + 1's elements, and the number of roots
    (<= INV_ROOTS) that are inverted by Fermat."""
    levels = []
    while N > INV_ROOTS:
        M = -(-N // INV_GROUP)
        levels.append((N, M))
        N = M
    return levels, N


def fq_batch_inv(a):
    """Inverses of N nonzero Fq elements a (N, 8), Montgomery in and out, for
    any N >= 1.  On the card: forward prefix products per strided group down
    the tree of batch_inv_levels, Fermat at the roots, backward sweeps up;
    one launch of the kernel, whatever its number of CUDA launches."""
    N, dev = a.shape[0], a.device
    kernels.check(a, "a", (N, 8), dev)
    if N < 1:
        raise ValueError("fq_batch_inv: no elements")
    if not kernels.use_kernel(dev, "fq_batch_inv"):
        return fq_batch_inv_plain(a)
    levels, nroots = batch_inv_levels(N)
    stream = kernels.stream_of(a)
    cur, down = a, []
    for n_l, m_l in levels:
        pref = torch.empty((n_l, 8), dtype=torch.int32, device=dev)  # prefixes, then inverses
        prod = torch.empty((m_l, 8), dtype=torch.int32, device=dev)
        kernels.launch("fq_inv_prefix_launch", cur.data_ptr(), pref.data_ptr(), prod.data_ptr(),
                       n_l, m_l, stream)
        down.append((cur, pref))
        cur = prod
    inv = torch.empty((nroots, 8), dtype=torch.int32, device=dev)
    kernels.launch("fq_inv_roots_launch", cur.data_ptr(), inv.data_ptr(), nroots, stream)
    for (src, pref), (n_l, m_l) in zip(reversed(down), reversed(levels)):
        kernels.launch("fq_inv_back_launch", src.data_ptr(), pref.data_ptr(), inv.data_ptr(),
                       pref.data_ptr(), n_l, m_l, stream)
        inv = pref
    kernels.LAUNCHES["fq_batch_inv"] += 1
    return inv


# -------------------------------------------------------------- table build


def build_bases(x, y, W: int, c: int):
    """(n, 8) affine points -> affine window bases (bax, bay), each (W*n, 8),
    row w*n + i holding 2^(c*w) * P_i (`_build_bases`)."""
    BX, BY, BZ = fb_bases(x, y, W, c)
    zinv = fq_batch_inv(BZ)
    return fp_mont_mul(fq, BX, zinv), fp_mont_mul(fq, BY, zinv)


def build_chunk(T, bax, bay, CH: int, rows):
    """One chunk of the table (`_build_chunk`): from the chain state T =
    (TX, TY, TZ) = m * B, the CH multiples m * B .. (m + CH - 1) * B, made
    affine and written as x || y into `rows`, a (K, CH, 16) view of the
    table; returns the advanced state (m + CH) * B."""
    K = bax.shape[0]
    EX, EY, EZ, *T = fb_mult_chunk(*T, bax, bay, CH)
    zinv = fq_batch_inv(EZ.view(CH * K, 8))
    for E, half in ((EX, slice(0, 8)), (EY, slice(8, 16))):
        rows[..., half] = fp_mont_mul(fq, E.view(CH * K, 8), zinv).view(CH, K, 8).transpose(0, 1)
    return tuple(T)


class FixedBaseTable:
    """Signed-window multiple table of a fixed set of affine G1 points on
    `device` (the card unless the caller passes another): `table` is the
    (K, D, 16) int32 tensor described in the module docstring.  `bits` bounds
    the scalars a query may take (254 covers Fr)."""

    def __init__(self, points, c: int = 8, bits: int = 254, device=None):
        self.device = dev = resolve(device)
        self.n = n = len(points)
        self.c, self.bits = c, bits
        if 16 % c != 0 or bits % c > c - 2:
            raise ParameterError(
                f"window width c={c} must divide 16 with bits%c <= c-2 (bits={bits})"
            )
        self.W = W = (bits + c - 1) // c
        self.D = D = 1 << (c - 1)
        K = W * n
        if any(p is None for p in points):
            raise ParameterError("the identity is not a table base")
        if K & (K - 1) or K < 32:
            raise ParameterError(f"W*n = {K} must be a power of two >= 32")
        self.points = list(points)

        x = fq.to_mont_limbs([p[0] for p in points], dev).reshape(n, 8)
        y = fq.to_mont_limbs([p[1] for p in points], dev).reshape(n, 8)
        bax, bay = build_bases(x, y, W, c)
        CH = min(16, D)
        T = (bax, bay, fq.const(1, dev).expand(K, 8).contiguous())
        self.table = torch.empty((K, D, 16), dtype=torch.int32, device=dev)
        for d0 in range(0, D, CH):  # each chunk's rows land in the table in place
            T = build_chunk(T, bax, bay, CH, self.table[:, d0 : d0 + CH])


def fixed_base_table_from_jax(tbl, device=None) -> torch.Tensor:
    """A JAX-package FixedBaseTable's table, in either of its layouts (leaf-
    major (D*K, 32) or vertical (D, 32, K) uint16), as this package's (K, D,
    16) int32 table tensor on `device`."""
    t = np.asarray(tbl.table).astype(np.uint16)
    D = tbl.D
    if t.ndim == 3:  # vertical: t[d - 1, :, k]
        t = t.transpose(2, 0, 1)
    else:
        t = t.reshape(-1, D, 32)
    return torch.from_numpy(np.ascontiguousarray(t).view(np.int32)).to(resolve(device))
