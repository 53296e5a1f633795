"""Variable-base multi-scalar multiplication over BN254 G1.

Counterpart of `uzkge_tpu/msm/msm.py` (arkworks `VariableBaseMSM::msm`,
called from `KZGCommitmentScheme::commit`): Pippenger with window c = 8, so
32 windows of 256 buckets, and complete Renes-Costello-Batina additions.

The device half of `_msm_device` is two hand-written CUDA kernels
(csrc/msm.cu), each beside its plain torch-op version in this module:

  * msm_bucket_accumulate: per (batch p, chunk k, window w) lane, the
    buckets of chunk k's points (the TPU's 512-step lax.scan);
  * msm_bucket_reduce: the chunk fold and the weighted bucket sum
    sum_b b*B_b per (p, w) (the TPU's fold tree and 255-step scan).

The 32 window sums of each MSM are combined on the host
(`_window_sums_to_points`), as in the JAX package.  Results are affine host
points (python ints, None for the identity).
"""

import torch

from uzkge_tpu.constants.bn254 import Q_MOD, R_MOD
from uzkge_tpu.curve.bn254 import g1_add
from uzkge_tpu.ff.field import Fq

from .. import kernels
from ..ff.field import W, fq, fr, lift, lower

C_BITS = 8
N_WINDOWS = 32
N_BUCKETS = 1 << C_BITS
HOST_MSM_MAX = 512  # below this many points a host Pippenger wins outright
LANES_TARGET = 16384  # (p, k, w) lanes that keep the card busy


class MSMBases:
    """Fixed affine G1 bases on `device` as (n, 8) Fq Montgomery limbs."""

    def __init__(self, points, device=None):
        assert all(p is not None for p in points), "identity base not supported"
        self.n = len(points)
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.x = fq.to_mont_limbs([p[0] for p in points], self.device).reshape(self.n, 8)
        self.y = fq.to_mont_limbs([p[1] for p in points], self.device).reshape(self.n, 8)
        self.points = list(points)


def pick_chunks(n: int, P: int, device) -> int:
    """Number of point chunks K.  On a card: start where the chunk fold
    (P*32*256*K additions) matches the bucket walk (P*32*n), then double K
    until P*32*K lanes fill the card, keeping >= 16 points per chunk.  On the
    CPU the plain version runs, whose fold is the costly part: few chunks."""
    if torch.device(device).type != "cuda":
        return max(1, min(4, n // 64))
    K = max(1, n // N_BUCKETS)
    while P * N_WINDOWS * K < LANES_TARGET and n // (2 * K) >= 16:
        K *= 2
    return K


# ------------------------------------------------------------ plain versions


def _b3(ndim, device):
    return fq.wconst(fq.const(9, device), ndim)


def _st(*xs):
    """Stack wide tensors of broadcast-compatible shapes on a new axis 1, so
    that independent field operations run as one call."""
    shape = torch.broadcast_shapes(*(x.shape for x in xs))
    return torch.stack([x.expand(shape) for x in xs], dim=1)


def _tail(t0, t1, t2, t3, t4, Y3):
    """The shared second half of RCB Alg. 7 / 8 (b3 = 9), from the products
    t0 = X1X2, t1 = Y1Y2, t2 = Z1Z2 (or Z1 for Alg. 8) and the cross terms."""
    mul, add, sub = fq.wmul, fq.wadd, fq.wsub
    b3 = _b3(t0.dim() + 1, t0.device)
    X3 = add(t0, t0)
    t0 = add(X3, t0)
    t2, Y3 = mul(b3, _st(t2, Y3)).unbind(1)
    Z3 = add(t1, t2)
    t1 = sub(t1, t2)
    p = mul(_st(t3, t4, t1, Y3, Z3, t0), _st(t1, Y3, Z3, t0, t4, t3)).unbind(1)
    X3 = sub(p[0], p[1])
    Y3, Z3 = add(_st(p[2], p[4]), _st(p[3], p[5])).unbind(1)
    return X3, Y3, Z3


def _madd_w(X1, Y1, Z1, x2, y2):
    """Complete mixed addition (RCB Alg. 8, a = 0, b3 = 9) on wide tensors:
    msm.py::_madd with its independent products stacked into one call."""
    mul, add, sub = fq.wmul, fq.wadd, fq.wsub
    s1, s2 = add(_st(x2, X1), _st(y2, Y1)).unbind(1)  # x2 + y2, X1 + Y1
    t0, t1, t3, t4, Y3 = mul(_st(X1, Y1, s1, y2, x2), _st(x2, y2, s2, Z1, Z1)).unbind(1)
    t3 = sub(t3, add(t0, t1))
    t4, Y3 = add(_st(t4, Y3), _st(Y1, X1)).unbind(1)
    return _tail(t0, t1, Z1, t3, t4, Y3)


def _padd_w(X1, Y1, Z1, X2, Y2, Z2):
    """Complete projective addition (RCB Alg. 7, a = 0, b3 = 9) on wide
    tensors: msm.py::_padd with its independent products stacked."""
    mul, add, sub = fq.wmul, fq.wadd, fq.wsub
    s = add(_st(X1, Y1, X1, X2, Y2, X2), _st(Y1, Z1, Z1, Y2, Z2, Z2)).unbind(1)
    t0, t1, t2, m3, m4, m5 = mul(_st(X1, Y1, Z1, s[0], s[1], s[2]),
                                 _st(X2, Y2, Z2, s[3], s[4], s[5])).unbind(1)
    t3, t4, Y3 = sub(_st(m3, m4, m5), add(_st(t0, t1, t0), _st(t1, t2, t2))).unbind(1)
    return _tail(t0, t1, t2, t3, t4, Y3)


def _identity_w(shape, device):
    zero = torch.zeros((W,) + tuple(shape), dtype=torch.int64, device=device)
    one = fq.wconst(fq.const(1, device), len(shape) + 1).expand_as(zero).clone()
    return zero, one, zero.clone()


def _digits(std: torch.Tensor) -> torch.Tensor:
    """(P, n, 8) standard-form limbs -> (P, n, 32) int64 8-bit digits."""
    v = std.to(torch.int64) & 0xFFFFFFFF
    d = torch.stack([(v >> (8 * j)) & 0xFF for j in range(4)], dim=-1)
    return d.reshape(*std.shape[:-1], 4 * 8)


def msm_bucket_accumulate_plain(bx, by, std, K: int):
    """Torch-op version of the accumulate kernel: same (P, K, 32, 256, 3, 8)
    buckets up to the projective representative (bucket 0 collects what the
    kernel skips; the reduction never reads it)."""
    P, n, _ = std.shape
    Cn = (n + K - 1) // K
    dev = std.device
    dig = _digits(std)
    pad = K * Cn - n
    if pad:
        dig = torch.cat([dig, torch.zeros(P, pad, 32, dtype=dig.dtype, device=dev)], dim=1)
    dig = dig.reshape(P, K, Cn, N_WINDOWS).permute(2, 0, 1, 3)  # (Cn, P, K, W)
    pidx = torch.arange(K * Cn, device=dev).clamp(max=n - 1).reshape(K, Cn).T  # (Cn, K)
    X, Y, Z = _identity_w((P, K, N_WINDOWS, N_BUCKETS), dev)
    wx, wy = lift(bx), lift(by)  # (W, n)
    for c in range(Cn):
        idx = dig[c][None, ..., None].expand(W, P, K, N_WINDOWS, 1)
        x2 = wx[:, pidx[c]][:, None, :, None]  # (W, 1, K, 1)
        y2 = wy[:, pidx[c]][:, None, :, None]
        X3, Y3, Z3 = _madd_w(X.gather(-1, idx)[..., 0], Y.gather(-1, idx)[..., 0],
                             Z.gather(-1, idx)[..., 0], x2, y2)
        X.scatter_(-1, idx, X3[..., None])
        Y.scatter_(-1, idx, Y3[..., None])
        Z.scatter_(-1, idx, Z3[..., None])
    return torch.stack([lower(X), lower(Y), lower(Z)], dim=-2)


SEG = 16  # buckets per segment of the weighted sum


def _running_sums(pts, lo: int):
    """Running double-sum over the last axis of wide points (X, Y, Z), from
    the top index down to `lo`: returns (tot, run) with
    tot = sum_{i >= lo} (i - lo + 1) * p_i and run = sum_{i >= lo} p_i."""
    X, Y, Z = pts
    run = _identity_w(X.shape[1:-1], X.device)
    tot = _identity_w(X.shape[1:-1], X.device)
    for i in range(X.shape[-1] - 1, lo - 1, -1):
        run = _padd_w(*run, X[..., i], Y[..., i], Z[..., i])
        tot = _padd_w(*tot, *run)
    return tot, run


def msm_bucket_reduce_plain(buckets):
    """Torch-op version of the reduce kernel: (P, K, 32, 256, 3, 8) buckets
    -> (P, 32, 3, 8) window sums sum_b b*B_b, with the kernel's scheme: a
    tree fold over K, then per 16-bucket segment s the running sums
    tot_s = sum_{u>=1} u*B[16s+u] and agg_s = sum_u B[16s+u], and
    sum_s tot_s + 16 * sum_{s>=1} s*agg_s.  Bucket 0 is never read."""
    P, K = buckets.shape[:2]
    X, Y, Z = (lift(buckets[..., i, :]) for i in range(3))  # (W, P, K, 32, 256)
    while K > 1:
        h = K // 2
        X3, Y3, Z3 = _padd_w(X[:, :, :h], Y[:, :, :h], Z[:, :, :h],
                             X[:, :, h : 2 * h], Y[:, :, h : 2 * h], Z[:, :, h : 2 * h])
        if K % 2:
            X3, Y3, Z3 = (torch.cat([a, b[:, :, 2 * h :]], 2) for a, b in ((X3, X), (Y3, Y), (Z3, Z)))
        X, Y, Z, K = X3, Y3, Z3, h + K % 2
    seg = [a[:, :, 0].reshape(W, P, N_WINDOWS, N_BUCKETS // SEG, SEG) for a in (X, Y, Z)]
    tot, run = _running_sums(seg, 1)  # (W, P, 32, 16) each coordinate
    agg = _padd_w(*run, seg[0][..., 0], seg[1][..., 0], seg[2][..., 0])
    wsum, _ = _running_sums([a[..., 1:] for a in agg], 0)  # sum_{s>=1} s*agg_s
    for _ in range(4):  # * 16
        wsum = _padd_w(*wsum, *wsum)
    tX, tY, tZ = tot
    while tX.shape[-1] > 1:
        h = tX.shape[-1] // 2
        tX, tY, tZ = _padd_w(tX[..., :h], tY[..., :h], tZ[..., :h],
                             tX[..., h:], tY[..., h:], tZ[..., h:])
    out = _padd_w(*wsum, tX[..., 0], tY[..., 0], tZ[..., 0])
    return torch.stack([lower(c) for c in out], dim=-2)


# ------------------------------------------------------------- the kernels


def msm_bucket_accumulate(bx, by, std, K: int):
    """Bucket accumulation.  bx, by: (n, 8) affine Fq bases; std: (P, n, 8)
    standard-form scalars.  Returns (P, K, 32, 256, 3, 8) projective buckets."""
    P, n, _ = std.shape
    dev = std.device
    kernels.check(bx, "bx", (n, 8), dev)
    kernels.check(by, "by", (n, 8), dev)
    kernels.check(std, "std", (P, n, 8), dev)
    if not 1 <= K <= n:
        raise ValueError(f"msm_bucket_accumulate: K = {K} outside [1, {n}]")
    if dev.type == "cpu":
        return msm_bucket_accumulate_plain(bx, by, std, K)
    if dev.type != "cuda":
        raise ValueError(f"msm_bucket_accumulate: unsupported device {dev}")
    buckets = torch.empty((P, K, N_WINDOWS, N_BUCKETS, 3, 8), dtype=torch.int32, device=dev)
    kernels.launch("msm_bucket_accumulate_launch", bx.data_ptr(), by.data_ptr(),
                   std.data_ptr(), buckets.data_ptr(), P, n, K, kernels.stream_of(std))
    kernels.LAUNCHES["msm_bucket_accumulate"] += 1
    return buckets


def msm_bucket_reduce(buckets):
    """(P, K, 32, 256, 3, 8) buckets -> (P, 32, 3, 8) window sums."""
    P, K = buckets.shape[:2]
    dev = buckets.device
    kernels.check(buckets, "buckets", (P, K, N_WINDOWS, N_BUCKETS, 3, 8), dev)
    if dev.type == "cpu":
        return msm_bucket_reduce_plain(buckets)
    if dev.type != "cuda":
        raise ValueError(f"msm_bucket_reduce: unsupported device {dev}")
    out = torch.empty((P, N_WINDOWS, 3, 8), dtype=torch.int32, device=dev)
    kernels.launch("msm_bucket_reduce_launch", buckets.data_ptr(), out.data_ptr(), P, K,
                   kernels.stream_of(buckets))
    kernels.LAUNCHES["msm_bucket_reduce"] += 1
    return out


def _msm_device(px, py, scalars_mont, K: int = None):
    """(n, 8) bases and (P, n, 8) Fr Montgomery scalars -> (P, 32, 3, 8)
    projective window sums."""
    P, n, _ = scalars_mont.shape
    if K is None:
        K = pick_chunks(n, P, scalars_mont.device)
    std = fr.from_mont(scalars_mont)
    return msm_bucket_reduce(msm_bucket_accumulate(px, py, std, K))


# ---------------------------------------------------------------- host side


def _window_sums_to_points(wsums):
    """(P, W, 3, 8) projective Montgomery window sums -> one host affine point
    per batch entry, combined over windows with the 2^8 ladder."""
    P, W = wsums.shape[0], wsums.shape[1]
    ints = fq.from_mont_limbs(wsums.reshape(P * W * 3, 8))
    zs = [ints[3 * i + 2] for i in range(P * W)]
    nz = [z for z in zs if z]
    inv = iter(Fq.batch_inv(nz) if nz else [])
    win = []
    for i, z in enumerate(zs):
        if z == 0:
            win.append(None)
        else:
            zi = next(inv)
            win.append((ints[3 * i] * zi % Q_MOD, ints[3 * i + 1] * zi % Q_MOD))
    out = []
    for pi in range(P):
        acc = None
        for wi in range(W - 1, -1, -1):
            if acc is not None:
                for _ in range(C_BITS):
                    acc = g1_add(acc, acc)
            acc = g1_add(acc, win[pi * W + wi])
        out.append(acc)
    return out


def host_msm(points, scalars, c: int = None):
    """Host Pippenger over affine points (python ints), for small inputs.
    The window c defaults, as in arkworks, to about ln(n) + 2 for n terms
    (3 below 32 terms): every window's running sum costs up to 2^(c+1)
    additions, so a wide window only pays off for many terms."""
    pairs = [(p, s % R_MOD) for p, s in zip(points, scalars) if p is not None and s % R_MOD]
    if not pairs:
        return None
    if c is None:
        c = 3 if len(pairs) < 32 else len(pairs).bit_length() * 69 // 100 + 2
    nwin = (254 + c - 1) // c
    acc = None
    for win in reversed(range(nwin)):
        if acc is not None:
            for _ in range(c):
                acc = g1_add(acc, acc)
        buckets = {}
        shift = win * c
        for p, s in pairs:
            d = (s >> shift) & ((1 << c) - 1)
            if d:
                buckets[d] = g1_add(buckets.get(d), p)
        running = None
        wsum = None
        for d in range(max(buckets.keys(), default=0), 0, -1):
            if d in buckets:
                running = g1_add(running, buckets[d])
            if running is not None:
                wsum = g1_add(wsum, running)
        acc = g1_add(acc, wsum)
    return acc


def msm(bases: MSMBases, scalars):
    """MSM over fixed bases.

    scalars: a list of python ints (one MSM), a list of lists (several MSMs
    over the same bases), or a (P, n, 8) / (n, 8) tensor of Fr Montgomery
    limbs.  Returns one host affine point, or a list for batched input."""
    if not isinstance(scalars, torch.Tensor) and bases.n <= HOST_MSM_MAX:
        if scalars and isinstance(scalars[0], (list, tuple)):
            return [host_msm(bases.points, row) for row in scalars]
        return host_msm(bases.points, scalars)
    if isinstance(scalars, torch.Tensor):
        single = scalars.dim() == 2
        sc = scalars[None] if single else scalars
    else:
        if scalars and isinstance(scalars[0], (list, tuple)):
            rows, single = scalars, False
        else:
            rows, single = [scalars], True
        flat = [s for row in rows for s in row]
        sc = fr.to_mont_limbs(flat, bases.device).reshape(len(rows), bases.n, 8)
    wsums = _msm_device(bases.x, bases.y, sc.contiguous())
    pts = _window_sums_to_points(wsums.cpu())
    return pts[0] if single else pts
