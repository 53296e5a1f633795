"""Variable-base multi-scalar multiplication over BN254 G2, one MSM at a time.

A Groth16 proof's B = beta_g2 + <z, b_g2_query> + s delta_g2
(groth16/ark_prove.py::device_g2_msm) runs as one such MSM.  It is the G1
Pippenger's shape (msm.py) at P = 1, window c = 8, with complete
Renes-Costello-Batina additions over Fq2 (csrc/g2.cuh): two hand-written
CUDA kernels (csrc/msm_g2.cu), each beside its plain torch-op version in this
module, which a CPU tensor takes:

  * g2_bucket_accumulate: the sum of each (window, bucket)'s points: a
    counting sort of each window's points by digit, a thread per piece of at
    most L points, a binary tree over a bucket's pieces (the G1 kernels'
    order, msm.py's msm_bucket_accumulate_plain);
  * g2_bucket_reduce: each window's sum_b b * B_b, bit by bit
    (csrc/msm_g2.cuh, g2_window_sum).

Fq2 = Fq[u] / (u^2 + 1).  Device arrays of projective points lie in two
planes, (2, N, 3, 8): plane 0 the c0 halves of X, Y, Z, plane 1 the c1
halves, Fq Montgomery limbs; the affine bases are (n, 4, 8): x.c0, x.c1,
y.c0, y.c1.  In the plain versions an Fq2 coordinate is a wide (8, 2, ...)
int64 tensor (ff/field.py's wide form with the Fq2 axis second).
"""

import torch

from .. import kernels
from ..constants.bn254 import R_MOD
from ..curve.bn254 import G2_B, fq2_scalar
from ..ff.field import fq, ints_to_limbs, lift, lower
from .msm import C_BITS, N_BUCKETS, N_WINDOWS, _digits, _st

G2_PIECE = 8  # the accumulate's piece length L: the most points one thread sums


def g2_bases(points) -> torch.Tensor:
    """Affine G2 points (((x0, x1), (y0, y1)), none the identity) -> (n, 4,
    8) Montgomery limbs on the host."""
    assert all(p is not None for p in points), "identity base not supported"
    flat = [v for (x, y) in points for v in (*x, *y)]
    return fq.to_mont_limbs(flat, "cpu").reshape(len(points), 4, 8)


# ------------------------------------------------------------ plain versions


def _b3(like):
    """b3 = 3b' = 9 / (9 + u), wide, broadcastable against the Fq2 `like`."""
    b3 = fq.to_mont_limbs(list(fq2_scalar(G2_B, 3)), like.device)
    return lift(b3).reshape((8, 2) + (1,) * (like.dim() - 2))


def _f2mul(*pairs):
    """The Fq2 products a * b of the pairs (a, b) of wide Fq2 tensors, by
    Karatsuba (v0 = a0 b0, v1 = a1 b1, v2 = (a0 + a1)(b0 + b1); a b = v0 - v1
    + (v2 - v0 - v1) u), all in one fq.wmul call."""
    shape = torch.broadcast_shapes(*(x.shape for p in pairs for x in p))
    AB = torch.stack([torch.stack([p[i].expand(shape) for p in pairs], 1) for i in (0, 1)], 1)
    sums = fq.wadd(AB[:, :, :, :1], AB[:, :, :, 1:])  # (8, 2, m, 1, ...): a0 + a1, b0 + b1
    ops = torch.cat([AB, sums], 3)
    v0, v1, v2 = fq.wmul(ops[:, 0], ops[:, 1]).unbind(2)
    c0, s = fq.wsub(_st(v0, v2), _st(v1, fq.wadd(v0, v1))).unbind(1)
    return torch.stack([c0, s], 2).unbind(1)


def _tail(t0, t1, t2, t3, t4, Y3):
    """The shared second half of RCB Alg. 7 / 8 over Fq2, from t0 = X1X2,
    t1 = Y1Y2, t2 = Z1Z2 (Z1 for Alg. 8) and the cross terms: msm.py's
    _tail with b3 = 3b' a full Fq2 constant."""
    add, sub = fq.wadd, fq.wsub
    b3 = _b3(t0)
    t0 = add(add(t0, t0), t0)
    t2, Y3 = _f2mul((t2, b3), (Y3, b3))
    Z3 = add(t1, t2)
    t1 = sub(t1, t2)
    p = _f2mul((t3, t1), (t4, Y3), (t1, Z3), (Y3, t0), (Z3, t4), (t0, t3))
    X3 = sub(p[0], p[1])
    Y3, Z3 = add(_st(p[2], p[4]), _st(p[3], p[5])).unbind(1)
    return X3, Y3, Z3


def _madd2(acc, pt):
    """Complete mixed addition (RCB Alg. 8) over Fq2, csrc/g2.cuh's
    g2_madd: projective acc = (X1, Y1, Z1) + affine pt = (x2, y2)."""
    (X1, Y1, Z1), (x2, y2) = acc, pt
    add, sub = fq.wadd, fq.wsub
    s1, s2 = add(_st(x2, X1), _st(y2, Y1)).unbind(1)  # x2 + y2, X1 + Y1
    t0, t1, t3, t4, Y3 = _f2mul((X1, x2), (Y1, y2), (s1, s2), (y2, Z1), (x2, Z1))
    t3 = sub(t3, add(t0, t1))
    t4, Y3 = add(_st(t4, Y3), _st(Y1, X1)).unbind(1)
    return _tail(t0, t1, Z1, t3, t4, Y3)


def _padd2(a, b):
    """Complete projective addition (RCB Alg. 7) over Fq2, g2_padd."""
    (X1, Y1, Z1), (X2, Y2, Z2) = a, b
    add, sub = fq.wadd, fq.wsub
    s = add(_st(X1, Y1, X1, X2, Y2, X2), _st(Y1, Z1, Z1, Y2, Z2, Z2)).unbind(1)
    t0, t1, t2, m3, m4, m5 = _f2mul((X1, X2), (Y1, Y2), (Z1, Z2), (s[0], s[3]), (s[1], s[4]),
                                    (s[2], s[5]))
    t3, t4, Y3 = sub(_st(m3, m4, m5), add(_st(t0, t1, t0), _st(t1, t2, t2))).unbind(1)
    return _tail(t0, t1, t2, t3, t4, Y3)


def _dbl2(a):
    """Complete doubling (RCB Alg. 9, a = 0) over Fq2, g2_dbl: X3 = 2XY (Y^2
    - 3 b3 Z^2), Y3 = (Y^2 - 3 b3 Z^2)(Y^2 + b3 Z^2) + 8 b3 Y^2 Z^2, Z3 =
    8 Y^3 Z."""
    X, Y, Z = a
    add, sub = fq.wadd, fq.wsub
    t0, t1, t2, xy = _f2mul((Y, Y), (Y, Z), (Z, Z), (X, Y))
    (t2,) = _f2mul((t2, _b3(t2)))
    z8 = add(t0, t0)
    z8 = add(z8, z8)
    z8 = add(z8, z8)
    y3 = add(t0, t2)
    t0 = sub(t0, add(add(t2, t2), t2))
    X3, Z3, Y3, X3b = _f2mul((t2, z8), (t1, z8), (t0, y3), (t0, xy))
    return add(X3b, X3b), add(X3, Y3), Z3


def _identity2(shape, device):
    zero = torch.zeros((8, 2) + tuple(shape), dtype=torch.int64, device=device)
    one = lift(fq.to_mont_limbs([1, 0], device)).reshape((8, 2) + (1,) * len(shape))
    return zero, one.expand_as(zero).clone(), zero.clone()


def _lift_planes(pts):
    """(2, N, 3, 8) planes -> wide (X, Y, Z), each (8, 2, N)."""
    return tuple(lift(pts[:, :, i]) for i in range(3))


def _lower_planes(coords):
    """wide (X, Y, Z), each (8, 2, N) -> (2, N, 3, 8) planes."""
    return torch.stack([lower(c) for c in coords], dim=-2)


def g2_bucket_accumulate_plain(bases, std, L: int):
    """Torch-op version of the accumulate kernels: (2, 32 * 256, 3, 8)
    buckets, equal to theirs limb for limb.  Window w lists its points by
    (digit, index); bucket b's c points make q = ceil(c / L) pieces, piece j
    the entries c*j//q .. c*(j+1)//q - 1, summed from its first point (x, y,
    1) by mixed additions; then the tree's levels at stride h = 1, 2, 4,
    ..., where piece j, j % 2h == 0, adds piece j + h (if below q) into
    itself; piece 0 is the bucket, empty buckets (and bucket 0) the
    identity.  Each round adds only in the pieces that still have a point.
    The sort is torch's here (a plain version, not on the card's path)."""
    n = std.shape[0]
    dev = std.device
    dig = _digits(std).T  # (32, n)
    order = torch.argsort(dig * n + torch.arange(n, device=dev), dim=1).reshape(-1)
    cnt = torch.zeros(N_WINDOWS, N_BUCKETS, dtype=torch.int64, device=dev)
    cnt.scatter_add_(1, dig, torch.ones_like(dig))
    first = (torch.cumsum(cnt, 1) - cnt).reshape(-1)  # into `order`, digit 0's first
    cnt[:, 0] = 0
    cnt = cnt.reshape(-1)
    q = (cnt + L - 1) // L
    owner = torch.repeat_interleave(torch.arange(N_WINDOWS * N_BUCKETS, device=dev), q)
    pstart = torch.cumsum(q, 0) - q
    j = torch.arange(owner.numel(), device=dev) - pstart[owner]
    c, qo = cnt[owner], q[owner]
    lo = first[owner] + c * j // qo
    hi = first[owner] + c * (j + 1) // qo
    base = (owner // N_BUCKETS) * n
    x, y = (lift(bases[:, 2 * i : 2 * i + 2].transpose(0, 1)) for i in (0, 1))  # (8, 2, n)

    def point(sel, e):  # the bases at entries e of the pieces sel
        i = order[base[sel] + e]
        return x[..., i], y[..., i]

    x0, y0 = point(slice(None), lo)
    one = lift(fq.to_mont_limbs([1, 0], dev)).unsqueeze(-1)
    S = [x0.clone(), y0.clone(), one.expand_as(x0).clone()]
    for t in range(1, int((hi - lo).max()) if owner.numel() else 0):
        act = torch.nonzero(lo + t < hi).squeeze(1)  # the pieces with a (t+1)-th point
        new = _madd2([s[..., act] for s in S], point(act, lo[act] + t))
        for s, v in zip(S, new):
            s[..., act] = v
    stride, top = 1, int(q.max())
    while stride < top:
        lead = torch.nonzero((j % (2 * stride) == 0) & (j + stride < qo)).squeeze(1)
        new = _padd2([s[..., lead] for s in S], [s[..., lead + stride] for s in S])
        for s, v in zip(S, new):
            s[..., lead] = v
        stride *= 2
    out = _identity2((N_WINDOWS * N_BUCKETS,), dev)
    full = torch.nonzero(q).squeeze(1)
    for o, s in zip(out, S):
        o[..., full] = s[..., pstart[full]]
    return _lower_planes(out)


def _tree_index(device):
    """(8, 4, 32): I[k, m, j] = the (32 m + j)-th bucket index with bit k set,
    the bucket that thread 32 k + j of g2_window_sum adds m-th."""
    k = torch.arange(C_BITS, device=device).reshape(-1, 1, 1)
    c = torch.arange(N_BUCKETS // 2, device=device).reshape(1, 4, 32)
    return ((c >> k) << (k + 1)) | (1 << k) | (c & ((1 << k) - 1))


def g2_bucket_reduce_plain(buckets):
    """Torch-op version of the reduce kernel, in its order of additions:
    (2, 32 * 256, 3, 8) buckets -> (2, 32, 3, 8) window sums sum_b b * B_b,
    equal to its limb for limb."""
    dev = buckets.device
    idx = (torch.arange(N_WINDOWS, device=dev).reshape(-1, 1, 1, 1) * N_BUCKETS
           + _tree_index(dev))  # (32, 8, 4, 32)
    pts = [c[..., idx] for c in _lift_planes(buckets)]  # (8, 2, 32, 8, 4, 32)
    r = tuple(c[..., 0, :] for c in pts)
    for m in range(1, 4):
        r = _padd2(r, tuple(c[..., m, :] for c in pts))
    h = 16
    while h:
        r = _padd2(tuple(c[..., :h] for c in r), tuple(c[..., h : 2 * h] for c in r))
        h //= 2
    r = tuple(c[..., 0] for c in r)  # (8, 2, 32, 8): C_k of each window
    k = torch.arange(C_BITS, device=dev)
    for d in range(C_BITS - 1):
        r = tuple(torch.where(k > d, v, c) for v, c in zip(_dbl2(r), r))
    h = C_BITS // 2
    while h:
        r = _padd2(tuple(c[..., :h] for c in r), tuple(c[..., h : 2 * h] for c in r))
        h //= 2
    return _lower_planes(tuple(c[..., 0] for c in r))


# ------------------------------------------------------------- the kernels


def g2_bucket_accumulate(bases, std, L: int):
    """Bucket accumulation.  bases: (n, 4, 8) affine G2 bases; std: (n, 8)
    standard-form scalars; L: the piece length.  Returns (2, 32 * 256, 3, 8)
    projective buckets."""
    n = std.shape[0]
    dev = std.device
    kernels.check(bases, "bases", (n, 4, 8), dev)
    kernels.check(std, "std", (n, 8), dev)
    if L < 1:
        raise ValueError(f"g2_bucket_accumulate: L = {L}, want L >= 1")
    if not kernels.use_kernel(dev, "g2_bucket_accumulate"):
        return g2_bucket_accumulate_plain(bases, std, L)
    # the sort stores the identity's c0 halves into empty buckets; c1 stays 0
    buckets = torch.zeros((2, N_WINDOWS * N_BUCKETS, 3, 8), dtype=torch.int32, device=dev)
    idx = torch.empty(N_WINDOWS * n, dtype=torch.int32, device=dev)
    meta = torch.empty((N_WINDOWS, 3 * (N_BUCKETS + 1) + 1), dtype=torch.int32, device=dev)
    xs = -(-n // L)  # the extra points a window: ceil(n / L), as the launch sizes them
    extra = torch.empty((2, N_WINDOWS * xs, 3, 8), dtype=torch.int32, device=dev)
    kernels.launch("g2_bucket_accumulate_launch", bases.data_ptr(), std.data_ptr(),
                   buckets.data_ptr(), idx.data_ptr(), meta.data_ptr(), extra.data_ptr(), n, L,
                   kernels.stream_of(std))
    kernels.count("g2_bucket_accumulate")
    return buckets


def g2_bucket_reduce(buckets):
    """(2, 32 * 256, 3, 8) buckets -> (2, 32, 3, 8) window sums."""
    dev = buckets.device
    kernels.check(buckets, "buckets", (2, N_WINDOWS * N_BUCKETS, 3, 8), dev)
    if not kernels.use_kernel(dev, "g2_bucket_reduce"):
        return g2_bucket_reduce_plain(buckets)
    out = torch.empty((2, N_WINDOWS, 3, 8), dtype=torch.int32, device=dev)
    kernels.launch("g2_bucket_reduce_launch", buckets.data_ptr(), out.data_ptr(),
                   kernels.stream_of(buckets))
    kernels.count("g2_bucket_reduce")
    return out


def g2_msm_windows(bases, scalars, device):
    """The 32 window sums of <scalars, bases> on `device`: bases the (n, 4, 8)
    host limbs of g2_bases, copied in for this call; scalars n python ints.
    Returns 32 projective host points ((X0, X1), (Y0, Y1), (Z0, Z1)), window
    w's sum_b b * B_b, whose sum over w of 2^(8w) times it is the MSM."""
    std = torch.from_numpy(ints_to_limbs(s % R_MOD for s in scalars)).to(device)
    wsums = g2_bucket_reduce(g2_bucket_accumulate(bases.to(device), std, G2_PIECE))
    v = fq.from_mont_limbs(wsums.cpu())  # plane, window, coordinate
    half = N_WINDOWS * 3
    return [tuple((v[3 * w + i], v[half + 3 * w + i]) for i in range(3)) for w in range(N_WINDOWS)]
