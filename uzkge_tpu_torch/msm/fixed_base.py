"""Fixed-base signed-window table over BN254 G1: the table and its query.

Counterpart of `uzkge_tpu/msm/fixed_base.py::FixedBaseTable`: for every
window w < W = ceil(bits / c), base point i < n and digit d in [1, D =
2^(c-1)], the affine point d * 2^(c*w) * P_i, built once per SRS on the
table's device (`__init__`, `_build_bases`, `_build_chunk`,
`pbatch_inv_fq`); then every MSM over the n points is a query of the table
(`msm_mont`, the TPU path `_msm_affine_impl`).

Layout: leaf-major rows, row (w*n + i)*D + (d-1) holding x || y as 16 int32
(64 B): a (K, D, 16) int32 tensor, K = W*n.  Byte for byte, that is the JAX
package's CPU table, (D*K, 32) uint16.  The TPU's vertical (D, 32, K) layout
serves only its where-chain select and is not copied.

The build is three hand-written CUDA kernels (csrc/fixed_base.cu) plus the
elementwise product of ff/cuda_field.py:

  * fb_bases: per base point, the doubling chain that emits the window bases
    B_w = 2^(c*w) * P_i, projective (the TPU's _bases_kernel);
  * fb_mult_chunk: per (window, point) lane, CH consecutive multiples of B_w
    by mixed additions, projective, and the advanced chain state (the TPU's
    _mult_chunk_kernel);
  * fq_batch_inv: the batch inversion that normalises both to affine (the
    TPU's _prod_kernel and _inv_kernel, through pbatch_inv_fq), one function
    for every size;
  * fp_mont_mul: x * z^-1 and y * z^-1.

A query of P MSMs (scalars (P, n, 8) Fr Montgomery) recodes the scalars into
signed base-2^c digits (torch ops; fp_mont_mul takes them out of Montgomery
form), then runs four more kernels (csrc/fixed_base_query.cu):

  * fb_select: leaf k = w*n + i of MSM p reads its row |d| - 1 and negates y
    for d < 0 (the TPU's _select_kernel, there a where-chain over the table);
  * AFFINE_LEVELS levels of the batch-affine tree, each pairing leaf j with
    leaf j + Kc/2 of its MSM: fb_pair_den (den = x2 - x1 and the pair flags;
    _pair_den_kernel and its small variant), fq_batch_inv over the level's
    dens (the TPU's pbatch_inv_fq_fast: _prefix_kernel, _invback_kernel,
    _fermat_bits_kernel), fb_pair_combine (the affine sums;
    _pair_combine_kernel and its small variant);
  * fb_fold: each tile of up to 512 consecutive projective points to one, by
    8-to-1 halving trees of complete additions, then one halving tree over
    the 2 or 4 left (_fold8_kernel and the XLA remainder), the tree spread
    over a block's threads; `fold_tail` runs it over tiles of 512, then once
    more over what is left, so that one projective point per MSM reaches the
    host (`_extract_host`).

The chain MSM (`msm_chain`, the per-device MSM of parallel/sharded.py)
keeps no table: every call builds the doubling chain 2^k * P_i, k < 256, with
`build_bases(x, y, 256, 1)` and sums signed base-4 digits over it, leaf k =
w*n + i reading chain row (2w + |d| - 1)*n + i, in rounds of two kernels
(csrc/scan_reduce.cu):

  * scan_leaf_reduce: per (MSM, lane), the sum of S consecutive leaves read
    straight from the chain by their digits (the TPU's _scan_leaf_kernel,
    after the gather that msm_chain does there in XLA);
  * scan_proj_reduce: per tile of up to FOLD_TILE consecutive projective
    points, their sum by fb_fold's halving trees, a block per tile
    (_scan_proj_kernel, whose running sums of S <= 32 points took twice the
    rounds), round after round down to one point per MSM.

The leaf round keeps the TPU kernel's two interleaved running sums (even s,
odd s), added at the end, so that its outputs equal the Pallas body's mod p;
the projective rounds add in another order, so the chain's sums equal the
TPU's as group elements (affine points), not limb for limb.

Every kernel sits beside its plain torch-op version in this module; a CPU
tensor takes the plain version, a CUDA tensor the kernel.  The group
formulas are msm/msm.py's (`_padd_w`, `_madd_w`) in the plain versions and
field.cuh's (`g1_padd`, `g1_madd`) in the kernels.  Unlike the TPU's fold,
which keeps afield's lazy [0, 2p) values, every value here is canonical.
"""

import numpy as np
import torch

from .. import kernels
from ..constants.bn254 import Q_MOD
from ..device import resolve
from ..errors import ParameterError
from ..ff.cuda_field import fp_mont_mul
from ..ff.field import MASK32, fq, fr, lift, lower
from ..ff.host_field import Fq
from .msm import _identity_w, _madd_w, _padd_w

INV_GROUP = 16  # elements per strided group of one batch-inversion level
INV_ROOTS = 1 << 17  # at most this many groups in the last level, each inverting its product
FOLD_TILE = 512  # the largest tile fb_fold folds in one block: 8^3 points
AFFINE_LEVELS = 3  # batch-affine levels of a query, then projective folds
INF1, INF2, BAD = 1, 2, 4  # pair flags: first / second point the identity; x1 == x2
SCAN_IL = 2  # interleaved running sums per scan lane (the TPU kernels' IL)


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


def _select_rows(digits, D: int):
    """Each digit's row in its leaf's block: |d| - 1, or row 0 for d = 0 and
    for |d| > D (where the TPU's where-chain matches no row)."""
    mag = digits.to(torch.int64).abs()
    return torch.where((mag >= 1) & (mag <= D), mag - 1, 0)


def fb_select_plain(digits, table):
    """Torch-op version of the fb_select kernel."""
    K, D = table.shape[:2]
    rows = table[torch.arange(K, device=table.device)[None, :], _select_rows(digits, D)]
    y = rows[..., 8:]
    y = torch.where((digits < 0)[..., None], fq.neg(y), y)
    return rows[..., :8].contiguous(), y.contiguous(), (digits == 0).to(torch.int32)


def fb_pair_den_plain(x, inf):
    """Torch-op version of the fb_pair_den kernel."""
    H = inf.shape[1] // 2
    X = lift(x)
    den = fq.wsub(X[:, :, H:], X[:, :, :H])
    i1, i2 = inf[:, :H] != 0, inf[:, H:] != 0
    bad = (den == 0).all(0) & ~i1 & ~i2
    den = torch.where(i1 | i2 | bad, fq.wconst(fq.const(1, x.device), 3), den)
    flags = INF1 * i1.to(torch.int32) + INF2 * i2.to(torch.int32) + BAD * bad.to(torch.int32)
    return lower(den), flags


def fb_pair_combine_plain(x, y, dinv, flags):
    """Torch-op version of the fb_pair_combine kernel."""
    mul, sub = fq.wmul, fq.wsub
    H = flags.shape[1]
    X, Y = lift(x), lift(y)
    x1, x2, y1, y2 = X[:, :, :H], X[:, :, H:], Y[:, :, :H], Y[:, :, H:]
    lam = mul(sub(y2, y1), lift(dinv))
    x3 = sub(sub(mul(lam, lam), x1), x2)
    y3 = sub(mul(lam, sub(x1, x3)), y1)
    i1, i2, bad = ((flags & f) != 0 for f in (INF1, INF2, BAD))
    xo = torch.where(i2, x1, torch.where(i1, x2, x3))
    yo = torch.where(i2, y1, torch.where(i1, y2, y3))
    return lower(xo), lower(yo), ((i1 & i2) | bad).to(torch.int32)


def fold_width(n: int) -> int:
    """The width of the next fold of n points: 8 while 8 divides n (the
    `_fold8` levels), then the 2 or 4 left (the remainder's halving)."""
    return 8 if n % 8 == 0 else n


def fb_fold_plain(X, Y, Z, w: int):
    """Torch-op version of the fb_fold kernel: each tile of w consecutive
    points to one, by halving trees over groups of fold_width(n) points, as
    `_fold8` and the remainder lay them out."""
    P, Kc = X.shape[:2]
    T = Kc // w  # tiles
    pts = [lift(t).reshape(8, P, T, w) for t in (X, Y, Z)]
    while w > 1:
        g = fold_width(w)
        pts = [t.reshape(8, P, T, w // g, g) for t in pts]
        w //= g
        while g > 1:
            h = g // 2
            pts = _padd_w(*(t[..., :h] for t in pts), *(t[..., h:] for t in pts))
            g = h
        pts = [t[..., 0] for t in pts]
    return tuple(lower(t[..., 0]) for t in pts)


def fold_tail_plain(X, Y, Z):
    """Torch-op version of fold_tail: fb_fold_plain over the 8-to-1 folds
    while 8 divides Kc, then over the remainder, one width at a time."""
    Kc = X.shape[1]
    while Kc > 1:
        w = fold_width(Kc)
        X, Y, Z = fb_fold_plain(X, Y, Z, w)
        Kc //= w
    return X[:, 0], Y[:, 0], Z[:, 0]


def chain_rows(digits, n: int):
    """The doubling-chain row of every leaf of (P, K) digits, leaf k = w*n + i:
    (2w + |d| - 1)*n + i, or (2w)*n + i for d = 0 (msm_chain's gather index
    on the TPU)."""
    k = torch.arange(digits.shape[1], device=digits.device)
    mag = digits.to(torch.int64).abs()
    return (2 * (k // n) + (mag - 1).clamp(min=0)) * n + k % n


def _scan_sums(count: int, step, lanes, device):
    """SCAN_IL wide running sums over `lanes` from the identity, step s < count
    folding into sum s % SCAN_IL (`step(acc, s)` -> acc), added at the end:
    the TPU scan kernels' order."""
    accs = [_identity_w(lanes, device) for _ in range(min(SCAN_IL, count))]
    for s in range(count):
        accs[s % len(accs)] = step(accs[s % len(accs)], s)
    return accs[0] if len(accs) == 1 else _padd_w(*accs[0], *accs[1])


def scan_leaf_reduce_plain(ax, ay, digits, n: int, S: int):
    """Torch-op version of the scan_leaf_reduce kernel."""
    P, K = digits.shape
    J = K // S
    rows = chain_rows(digits, n).view(P, J, S)
    d = digits.view(P, J, S)

    def step(acc, s):
        x, y = lift(ax[rows[:, :, s]]), lift(ay[rows[:, :, s]])
        y = torch.where(d[:, :, s] < 0, fq.wneg(y), y)
        keep = d[:, :, s] == 0
        return tuple(torch.where(keep, a, v) for a, v in zip(acc, _madd_w(*acc, x, y)))

    acc = _scan_sums(S, step, (P, J), ax.device)
    return tuple(lower(t).reshape(P * J, 8) for t in acc)


def scan_proj_reduce_plain(X, Y, Z, S: int):
    """Torch-op version of the scan_proj_reduce kernel: fb_fold_plain's trees
    over tiles of S consecutive points (the kernel runs fb_fold's tile)."""
    return tuple(t[0] for t in fb_fold_plain(X[None], Y[None], Z[None], S))


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
    kernels.count("fb_bases")
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
    kernels.count("fb_mult_chunk")
    return out


def batch_inv_levels(N: int, group: int = INV_GROUP, roots: int = INV_ROOTS):
    """The product tree of fq_batch_inv on N elements: a list of (N_l, M_l),
    level l's N_l elements forming M_l = ceil(N_l / group) strided groups
    whose products are level l + 1's elements, down to a last level of at
    most `roots` groups, each of which inverts its own product.  Its CUDA
    launches: 2 * len(levels) - 1."""
    levels = [(N, -(-N // group))]
    while levels[-1][1] > roots:
        N = levels[-1][1]
        levels.append((N, -(-N // group)))
    return levels


def fq_batch_inv(a):
    """Inverses of N nonzero Fq elements a (N, 8), Montgomery in and out, for
    any N >= 1.  On the card: forward prefix products per strided group down
    the tree of batch_inv_levels(N), then on the last level a forward sweep,
    a safegcd inversion of each group's product and a backward sweep in one
    launch, then backward sweeps up; one launch of the kernel, whatever its
    number of CUDA launches."""
    N, dev = a.shape[0], a.device
    kernels.check(a, "a", (N, 8), dev)
    if N < 1:
        raise ValueError(f"fq_batch_inv: N = {N}, want >= 1")
    if not kernels.use_kernel(dev, "fq_batch_inv"):
        return fq_batch_inv_plain(a)
    levels = batch_inv_levels(N)
    stream = kernels.stream_of(a)
    cur, down = a, []
    for n_l, m_l in levels[:-1]:
        pref = torch.empty((n_l, 8), dtype=torch.int32, device=dev)  # prefixes, then inverses
        prod = torch.empty((m_l, 8), dtype=torch.int32, device=dev)
        kernels.launch("fq_inv_down_launch", cur.data_ptr(), pref.data_ptr(), prod.data_ptr(),
                       n_l, m_l, stream)
        down.append((cur, pref))
        cur = prod
    n_l, m_l = levels[-1]
    inv = torch.empty((n_l, 8), dtype=torch.int32, device=dev)  # prefixes, then inverses
    kernels.launch("fq_inv_root_launch", cur.data_ptr(), inv.data_ptr(), inv.data_ptr(), n_l, m_l,
                   stream)
    for (src, pref), (n_l, m_l) in zip(reversed(down), reversed(levels[:-1])):
        kernels.launch("fq_inv_up_launch", src.data_ptr(), pref.data_ptr(), inv.data_ptr(),
                       pref.data_ptr(), n_l, m_l, stream)
        inv = pref
    kernels.count("fq_batch_inv")
    return inv


def _pairs(t, name: str):
    """P and H of a (P, H) int32 tensor of identity flags or pair flags."""
    if t.dim() != 2 or t.shape[0] < 1 or t.shape[1] < 1:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want (P, H) with P, H >= 1")
    return t.shape[0], t.shape[1]


def fb_select(digits, table):
    """Leaves of P MSMs over the table: digits (P, K) int32, leaf k = w*n + i;
    table (K, D, 16).  Returns x, y (P, K, 8) affine Fq Montgomery, y negated
    where d < 0, and inf (P, K) int32, 1 where d = 0 (whose x, y are row 0's,
    as on the TPU)."""
    if digits.dim() != 2 or table.dim() != 3:
        raise ValueError("fb_select: want digits (P, K) and table (K, D, 16)")
    (P, K), D, dev = digits.shape, table.shape[1], digits.device
    kernels.check(digits, "digits", (P, K), dev)
    kernels.check(table, "table", (K, D, 16), dev)
    if P < 1 or K < 1 or D < 1:
        raise ValueError(f"fb_select: P = {P}, K = {K}, D = {D}: all must be >= 1")
    if not kernels.use_kernel(dev, "fb_select"):
        return fb_select_plain(digits, table)
    x, y = (torch.empty((P, K, 8), dtype=torch.int32, device=dev) for _ in range(2))
    inf = torch.empty((P, K), dtype=torch.int32, device=dev)
    kernels.launch("fb_select_launch", table.data_ptr(), digits.data_ptr(), x.data_ptr(),
                   y.data_ptr(), inf.data_ptr(), P, K, D, kernels.stream_of(digits))
    kernels.count("fb_select")
    return x, y, inf


def fb_pair_den(x, inf):
    """First half of a batch-affine level over P MSMs of Kc points (x (P, Kc,
    8), inf (P, Kc)), pairing point j with point j + H, H = Kc / 2: returns
    den (P, H, 8), x2 - x1 or 1 where a side is the identity or x1 == x2, and
    the flags (P, H) int32 (INF1 | INF2 | BAD)."""
    P, Kc = _pairs(inf, "inf")
    H, dev = Kc // 2, inf.device
    if Kc % 2:
        raise ValueError(f"fb_pair_den: Kc = {Kc} points per MSM, want an even count")
    kernels.check(inf, "inf", (P, Kc), dev)
    kernels.check(x, "x", (P, Kc, 8), dev)
    if not kernels.use_kernel(dev, "fb_pair_den"):
        return fb_pair_den_plain(x, inf)
    den = torch.empty((P, H, 8), dtype=torch.int32, device=dev)
    flags = torch.empty((P, H), dtype=torch.int32, device=dev)
    kernels.launch("fb_pair_den_launch", x.data_ptr(), inf.data_ptr(), den.data_ptr(),
                   flags.data_ptr(), P, H, kernels.stream_of(x))
    kernels.count("fb_pair_den")
    return den, flags


def fb_pair_combine(x, y, dinv, flags):
    """Second half of the level: the affine sums of the pairs given dinv =
    den^-1 (P, H, 8) and the flags of fb_pair_den.  Returns xo, yo (P, H, 8)
    and their identity flags (P, H)."""
    P, H = _pairs(flags, "flags")
    dev = flags.device
    kernels.check(flags, "flags", (P, H), dev)
    kernels.check(x, "x", (P, 2 * H, 8), dev)
    kernels.check(y, "y", (P, 2 * H, 8), dev)
    kernels.check(dinv, "dinv", (P, H, 8), dev)
    if not kernels.use_kernel(dev, "fb_pair_combine"):
        return fb_pair_combine_plain(x, y, dinv, flags)
    xo, yo = (torch.empty((P, H, 8), dtype=torch.int32, device=dev) for _ in range(2))
    info = torch.empty((P, H), dtype=torch.int32, device=dev)
    kernels.launch("fb_pair_combine_launch", x.data_ptr(), y.data_ptr(), dinv.data_ptr(),
                   flags.data_ptr(), xo.data_ptr(), yo.data_ptr(), info.data_ptr(), P, H,
                   kernels.stream_of(x))
    kernels.count("fb_pair_combine")
    return xo, yo, info


def fb_fold(X, Y, Z, w: int):
    """Projective points (P, Kc, 8) each -> (P, Kc / w, 8) each: every tile
    of w consecutive points folded to one (fb_fold_plain's trees), w a power
    of two from 2 to FOLD_TILE."""
    if X.dim() != 3:
        raise ValueError(f"fb_fold: X of shape {tuple(X.shape)}, want (P, Kc, 8)")
    P, Kc, dev = X.shape[0], X.shape[1], X.device
    for t, name in ((X, "X"), (Y, "Y"), (Z, "Z")):
        kernels.check(t, name, (P, Kc, 8), dev)
    if not 2 <= w <= FOLD_TILE or w & (w - 1) or P < 1 or Kc < w or Kc % w:
        raise ValueError(f"fb_fold: P = {P}, Kc = {Kc}, w = {w}: want w a power of two in "
                         f"[2, {FOLD_TILE}] dividing Kc >= w")
    if not kernels.use_kernel(dev, "fb_fold"):
        return fb_fold_plain(X, Y, Z, w)
    out = tuple(torch.empty((P, Kc // w, 8), dtype=torch.int32, device=dev) for _ in range(3))
    kernels.launch("fb_fold_launch", X.data_ptr(), Y.data_ptr(), Z.data_ptr(),
                   *(o.data_ptr() for o in out), P * (Kc // w), w, kernels.stream_of(X))
    kernels.count("fb_fold")
    return out


def fold_tiles(Kc: int):
    """The tile of each fb_fold launch that folds Kc points per MSM to one:
    FOLD_TILE while more remain, then all that are left."""
    if Kc < 1 or Kc & (Kc - 1):
        raise ValueError(f"fold_tiles: Kc = {Kc}, want a power of two")
    tiles = []
    while Kc > FOLD_TILE:
        tiles.append(FOLD_TILE)
        Kc //= FOLD_TILE
    return tiles + ([Kc] if Kc > 1 else [])


def fold_tail(X, Y, Z):
    """The projective tail of a query (`_fold8` levels and the remainder):
    (P, Kc, 8) each -> the sums (P, 8) each, through fb_fold over
    fold_tiles(Kc): two launches up to Kc = FOLD_TILE^2."""
    for w in fold_tiles(X.shape[1]):
        X, Y, Z = fb_fold(X, Y, Z, w)
    return X[:, 0], Y[:, 0], Z[:, 0]


def _scan_width(S: int, total: int, name: str):
    if S < 1 or S & (S - 1) or total < S or total % S:
        raise ValueError(f"{name}: S = {S} must be a power of two dividing {total}")


def scan_leaf_reduce(ax, ay, digits, n: int, S: int):
    """The leaf round of the chain MSM: P MSMs of K = W*n leaves, digits (P,
    K) int32 in [-2, 2] with leaf k = w*n + i, over the affine doubling chain
    ax, ay (2K, 8) whose row r*n + i is 2^r * P_i.  Returns (X, Y, Z), each
    (P*J, 8) with J = K / S: element p*J + j the projective sum of leaves
    j*S .. j*S + S - 1 of MSM p."""
    if digits.dim() != 2:
        raise ValueError(f"scan_leaf_reduce: digits of shape {tuple(digits.shape)}, want (P, K)")
    (P, K), dev = digits.shape, digits.device
    kernels.check(digits, "digits", (P, K), dev)
    kernels.check(ax, "ax", (2 * K, 8), dev)
    kernels.check(ay, "ay", (2 * K, 8), dev)
    if P < 1 or n < 1 or n & (n - 1) or K < n or K % n:
        raise ValueError(f"scan_leaf_reduce: P = {P}, K = {K}, n = {n}: want n a power of two "
                         "dividing K")
    _scan_width(S, K, "scan_leaf_reduce")
    if S > 32:
        raise ValueError(f"scan_leaf_reduce: S = {S} above 32 (a lane's mask of its digits)")
    if K >= 1 << 31 or P * (K // S) >= 1 << 31:
        raise ValueError(f"scan_leaf_reduce: K = {K}, P * K / S = {P * (K // S)}: the kernel "
                         "indexes leaves, chain rows and lanes with 32 bits (each below 2^31)")
    if not kernels.use_kernel(dev, "scan_leaf_reduce"):
        return scan_leaf_reduce_plain(ax, ay, digits, n, S)
    out = tuple(torch.empty((P * (K // S), 8), dtype=torch.int32, device=dev) for _ in range(3))
    kernels.launch("scan_leaf_reduce_launch", ax.data_ptr(), ay.data_ptr(), digits.data_ptr(),
                   *(o.data_ptr() for o in out), P, K, n, S, kernels.stream_of(digits))
    kernels.count("scan_leaf_reduce")
    return out


def scan_proj_reduce(X, Y, Z, S: int):
    """A projective round of the chain MSM: (N, 8) points each -> (N / S, 8),
    element t the sum of points t*S .. t*S + S - 1 by fb_fold's halving trees
    (scan_proj_reduce_plain's order), S a power of two from 2 to
    FOLD_TILE."""
    if X.dim() != 2:
        raise ValueError(f"scan_proj_reduce: X of shape {tuple(X.shape)}, want (N, 8)")
    N, dev = X.shape[0], X.device
    for t, name in ((X, "X"), (Y, "Y"), (Z, "Z")):
        kernels.check(t, name, (N, 8), dev)
    _scan_width(S, N, "scan_proj_reduce")
    if not 2 <= S <= FOLD_TILE:
        raise ValueError(f"scan_proj_reduce: S = {S} outside [2, {FOLD_TILE}]")
    if N // S >= 1 << 31:
        raise ValueError(f"scan_proj_reduce: N / S = {N // S}: one block an output, below 2^31")
    if not kernels.use_kernel(dev, "scan_proj_reduce"):
        return scan_proj_reduce_plain(X, Y, Z, S)
    out = tuple(torch.empty((N // S, 8), dtype=torch.int32, device=dev) for _ in range(3))
    kernels.launch("scan_proj_reduce_launch", X.data_ptr(), Y.data_ptr(), Z.data_ptr(),
                   *(o.data_ptr() for o in out), N // S, S, kernels.stream_of(X))
    kernels.count("scan_proj_reduce")
    return out


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


# ------------------------------------------------------------------- query


def recode_digits(std, c: int, bits: int):
    """(..., 8) standard-form limbs (values < 2^bits) -> (..., nd) int32
    signed base-2^c digits, nd = ceil(bits / c), |d| <= 2^(c-1)
    (`recode_digits`): digit k takes bits [k*c, (k+1)*c) plus the carry of
    digit k - 1 and, above 2^(c-1), gives 2^c back as a carry.  The top digit
    absorbs the last carry when bits % c <= c - 2, which c must allow."""
    if 16 % c or bits % c > c - 2:
        raise ParameterError(f"recode: c = {c}, bits = {bits}: want 16 % c == 0, bits % c <= c - 2")
    nd, half, full = (bits + c - 1) // c, 1 << (c - 1), 1 << c
    shifts = torch.arange(0, 32, c, device=std.device)
    raw = (((std.to(torch.int64) & MASK32)[..., None] >> shifts) & (full - 1)).flatten(-2)
    out = torch.empty(raw.shape[:-1] + (nd,), dtype=torch.int32, device=std.device)
    carry = torch.zeros(raw.shape[:-1], dtype=torch.int64, device=std.device)
    for k in range(nd):
        v = raw[..., k] + carry
        ge = v > half
        out[..., k] = torch.where(ge, v - full, v)
        carry = ge.to(torch.int64)
    return out


def scalars_to_digits(scalars, c: int, bits: int):
    """(P, n, 8) Fr Montgomery -> (P, n, nd) signed digits
    (`_scalars_to_digits`): out of Montgomery form by a product with 1 on
    fp_mont_mul, then recode_digits."""
    P, n = scalars.shape[:2]
    flat = scalars.reshape(P * n, 8)
    one = fr.const_raw(1, scalars.device).expand(P * n, 8).contiguous()
    return recode_digits(fp_mont_mul(fr, flat, one).view(P, n, 8), c, bits)


def affine_level(x, y, inf):
    """One batch-affine level (`_affine_level`): P MSMs of Kc affine points
    (x, y (P, Kc, 8), inf (P, Kc)) -> their Kc / 2 pairwise sums."""
    P, Kc = inf.shape
    den, flags = fb_pair_den(x, inf)
    dinv = fq_batch_inv(den.view(P * (Kc // 2), 8)).view(den.shape)
    return fb_pair_combine(x, y, dinv, flags)


def to_projective(x, y, inf):
    """Affine points and identity flags -> projective (X, Y, Z), the identity
    as (0, 1, 0) (`_to_projective`)."""
    one = fq.const(1, x.device)
    isinf = (inf != 0)[..., None]
    zero = torch.zeros((), dtype=torch.int32, device=x.device)
    return (torch.where(isinf, zero, x), torch.where(isinf, one, y),
            torch.where(isinf, zero, one.expand_as(x)))


def _extract_host(X, Y, Z):
    """(P, 8) projective sums, Fq Montgomery -> P host affine points (None =
    the identity); the Zs share one inversion (`_extract_host`)."""
    P = X.shape[0]
    ints = fq.from_mont_limbs(torch.stack([X, Y, Z], 1).reshape(3 * P, 8))
    zs = ints[2::3]
    inv = iter(Fq.batch_inv([z for z in zs if z]) if any(zs) else [])
    out = []
    for i, z in enumerate(zs):
        if z == 0:
            out.append(None)
        else:
            zi = next(inv)
            out.append((ints[3 * i] * zi % Q_MOD, ints[3 * i + 1] * zi % Q_MOD))
    return out


# --------------------------------------------------------------- chain MSM


def pick_s(per: int, cap: int = 32) -> int:
    """The leaf round's width over `per` leaves per MSM: the largest power of
    two <= cap dividing per (`_pick_S`, which also sets the TPU's projective
    rounds)."""
    s = 1
    while s < cap and per % (s * 2) == 0:
        s *= 2
    return s


def reduce_leaves(ax, ay, digits, n: int):
    """(P, K) digits over the chain (ax, ay) -> projective sums (X, Y, Z),
    each (P, 8): one scan_leaf_reduce round (S = pick_s(K), as
    `_reduce_leaves`), then scan_proj_reduce rounds over fold_tiles(K / S)
    down to one point per MSM (two rounds at K / S = 65,536, the leaf
    round's output at n = 16384).  The TPU's
    projective rounds (running sums of S <= 32) add in another order: the
    sums are the same group elements, their projective limbs differ.  K must
    be a power of two."""
    K = digits.shape[1]
    S = pick_s(K)
    X, Y, Z = scan_leaf_reduce(ax, ay, digits, n, S)
    for w in fold_tiles(K // S):
        X, Y, Z = scan_proj_reduce(X, Y, Z, w)
    return X, Y, Z


def msm_chain(x, y, scalars, bits: int = 256):
    """P MSMs over n affine points with no table kept (`msm_chain`): x, y (n,
    8) Fq Montgomery, n a power of two; scalars (P, n, 8) Fr Montgomery on the
    same device.  Builds the chain 2^k * P_i, k < bits, projective by fb_bases
    (c = 1) and affine by fq_batch_inv and fp_mont_mul, recodes the scalars
    into signed base-4 digits (|d| <= 2: entry 2w + |d| - 1 of point i's chain
    is |d| * 4^w * P_i), then reduce_leaves.  Returns (X, Y, Z), each (P, 8).
    bits = 256 keeps the window count W = 128 a power of two."""
    c = 2
    n, dev = x.shape[0], x.device
    P = scalars.shape[0] if scalars.dim() == 3 else 0
    kernels.check(scalars, "scalars", (P, n, 8), dev)
    if P < 1 or n < 1 or n & (n - 1):
        raise ValueError(f"msm_chain: P = {P}, n = {n}: want P >= 1 and n a power of two")
    W = (bits + c - 1) // c
    ax, ay = build_bases(x, y, 2 * W, 1)
    digits = scalars_to_digits(scalars, c, bits).transpose(1, 2).reshape(P, W * n).contiguous()
    return reduce_leaves(ax, ay, digits, n)


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

    def query(self, scalars):
        """P MSMs over the table (`_msm_affine_impl`): scalars (P, n, 8) Fr
        Montgomery on the table's device -> projective sums (X, Y, Z), each
        (P, 8), on the device.  Any P in one call."""
        P = scalars.shape[0] if scalars.dim() == 3 else 0
        kernels.check(scalars, "scalars", (P, self.n, 8), self.device)
        if P < 1:
            raise ValueError("FixedBaseTable.query: want scalars (P, n, 8) with P >= 1")
        digits = scalars_to_digits(scalars, self.c, self.bits)  # (P, n, W)
        x, y, inf = fb_select(digits.transpose(1, 2).reshape(P, self.W * self.n), self.table)
        Kc = self.W * self.n
        for _ in range(AFFINE_LEVELS):
            if Kc == 1:
                break
            x, y, inf = affine_level(x, y, inf)
            Kc //= 2
        return fold_tail(*to_projective(x, y, inf))

    def msm_mont(self, scalars):
        """scalars (P, n, 8) Fr Montgomery -> a list of P host affine points
        (None = the identity)."""
        return _extract_host(*self.query(scalars))

    def msm_ints(self, rows):
        """P rows of n python-int scalars -> a list of P host affine points."""
        flat = [s % fr.p for row in rows for s in row]
        return self.msm_mont(fr.to_mont_limbs(flat, self.device).reshape(len(rows), self.n, 8))


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
