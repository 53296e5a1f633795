"""Sharded proving over a torch.distributed process group.

Counterpart of `uzkge_tpu/parallel/sharded.py`, whose shard_map programs
become SPMD processes: every rank is handed the full inputs, takes its
contiguous block of the sharded axis (rank r of ws: [r*N/ws, (r+1)*N/ws)),
and returns the replicated result, gathered in rank order.  The collectives
are torch.distributed's (NCCL on the card, gloo on the CPU), called at every
world size, 1 included.

  * MSM over the point axis (`sharded_msm_device_sums`): each rank runs the
    chain MSM (msm/fixed_base.py::msm_chain) on its points; the per-rank
    projective sums are all_gather'd and folded by a log tree of complete
    additions (`fold_device_sums`);
  * MSM over the proof axis (`sharded_msm_batch`): each rank runs msm_chain
    on its block of the P scalar rows; the sums are all_gather'd;
  * `ShardedNTT`: the four-step NTT n = n1 * n2 over n1 = ws ranks, local
    size-n2 NTTs on strided rows, a twiddle, one all_to_all, the size-n1
    column DFT, and an all_gather of the output blocks;
  * `sharded_ntt_batch`: each rank transforms its block of the P polynomials.
"""

import random
from typing import List

import torch
import torch.distributed as dist

from .. import kernels
from ..constants.bn254 import R_MOD
from ..ff.field import fr, lift, lower
from ..ff.host_field import Fr
from ..msm.fixed_base import _extract_host, msm_chain
from ..msm.msm import MSMBases, _padd_w, host_msm
from ..ntt.ntt import get_domain
from . import check_device, group_device


def _block(total: int, group, what: str) -> slice:
    """This rank's contiguous block of `total` items."""
    ws, r = dist.get_world_size(group), dist.get_rank(group)
    if total % ws:
        raise ValueError(f"{what}: {total} does not divide among {ws} ranks")
    b = total // ws
    return slice(r * b, (r + 1) * b)


def _all_gather(group, t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` stacked in rank order, (ws,) + t.shape, on every rank."""
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return torch.stack(out)


# ------------------------------------------------------------- sharded MSM


def fold_device_sums(X, Y, Z):
    """(k, P, 8) projective partial sums each -> (P, 8) each: the log tree of
    `_fold_device_sums`, point j + h added to point j (h = k // 2) and, for
    an odd k, the last point carried to the next level."""
    pts = [lift(t) for t in (X, Y, Z)]  # wide (8, k, P)
    k = X.shape[0]
    while k > 1:
        h = k // 2
        s = _padd_w(*(t[:, :h] for t in pts), *(t[:, h : 2 * h] for t in pts))
        pts = [torch.cat([a, t[:, 2 * h :]], dim=1) for a, t in zip(s, pts)]
        k = h + k % 2
    return tuple(lower(t[:, 0]) for t in pts)


def sharded_msm_device_sums(group, x, y, scalars):
    """P MSMs with the points sharded: x, y (n, 8) affine Fq Montgomery,
    scalars (P, n, 8) Fr Montgomery, n / ws a power of two.  Returns the
    projective sums (X, Y, Z), each (P, 8), on every rank."""
    for t, name in ((x, "x"), (y, "y"), (scalars, "scalars")):
        check_device(group, t, name)
    sl = _block(x.shape[0], group, "sharded_msm_device_sums: points")
    local = torch.stack(msm_chain(x[sl], y[sl], scalars[:, sl].contiguous()))  # (3, P, 8)
    allp = _all_gather(group, local)  # (ws, 3, P, 8)
    return fold_device_sums(allp[:, 0], allp[:, 1], allp[:, 2])


def sharded_msm(group, points: List, scalars):
    """The point-sharded MSM of host scalar rows (or one row) over host
    affine points, on the group's device: host affine points, one per row
    (one point for one row)."""
    rows = scalars if scalars and isinstance(scalars[0], (list, tuple)) else [scalars]
    dev = group_device(group)
    n = len(points)
    sc = fr.to_mont_limbs([s for row in rows for s in row], dev).reshape(len(rows), n, 8)
    b = MSMBases(points, dev)
    pts = _extract_host(*sharded_msm_device_sums(group, b.x, b.y, sc))
    return pts if len(rows) > 1 else pts[0]


def sharded_msm_batch(group, x, y, scalars):
    """P MSMs with the proof axis sharded: every rank holds all n points and
    runs msm_chain on its block of the P scalar rows (P a multiple of ws).
    Returns (X, Y, Z), each (P, 8), on every rank."""
    for t, name in ((x, "x"), (y, "y"), (scalars, "scalars")):
        check_device(group, t, name)
    P = scalars.shape[0]
    local = torch.stack(msm_chain(x, y, scalars[_block(P, group, "sharded_msm_batch: rows")]))
    allp = _all_gather(group, local)  # (ws, 3, P / ws, 8)
    return tuple(allp[:, i].reshape(P, 8) for i in range(3))


def sharded_commit_batch(group, points: List, scalars_rows: List[List[int]]):
    """Host rows committed with the proof axis sharded: host affine points."""
    dev = group_device(group)
    P, n = len(scalars_rows), len(points)
    sc = fr.to_mont_limbs([s for row in scalars_rows for s in row], dev).reshape(P, n, 8)
    b = MSMBases(points, dev)
    return _extract_host(*sharded_msm_batch(group, b.x, b.y, sc))


# ------------------------------------------------------------- sharded NTT


class ShardedNTT:
    """Four-step NTT of size n = n1 * n2 over the n1 = ws ranks of `group`:

      X[k2 + n2*k1] = sum_{j1<n1} w^{j1 k2} W1^{j1 k1}
                         [ sum_{j2<n2} x[j1 + n1*j2] W2^{j2 k2} ]

    (W1 = w^n2, W2 = w^n1).  Rank j1 takes the strided row x[j1::n1]: a
    local size-n2 NTT (NTTDomain on the ntt_pass kernel), the twiddle
    w^{j1 k2}, one all_to_all_single of n2 / ws-element chunks, then the
    size-n1 column DFT as a sum of products; the ranks' (n1, n2 / ws) output
    blocks are all_gather'd into the row-major (k1, k2) result.  The inverse
    runs the same flow over w^-1, with 1/n2 in the local inverse NTT and 1/n1
    in the column matrix."""

    def __init__(self, n: int, group):
        self.n, self.group = n, group
        self.n1 = ws = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        if n % ws or (n // ws) % ws:
            raise ValueError(f"ShardedNTT: n = {n} needs n / ws divisible by ws = {ws}")
        self.n2 = n2 = n // ws
        self.device = dev = group_device(group)
        self.dom2 = get_domain(n2, dev)
        p = R_MOD
        w = Fr.root_of_unity(n)
        w_inv = pow(w, p - 2, p)

        def twiddle(base):  # this rank's row j1: base^(j1 * k2), k2 < n2
            row, cur, step = [], 1, pow(base, self.rank, p)
            for _ in range(n2):
                row.append(cur)
                cur = cur * step % p
            return fr.to_mont_limbs(row, dev)

        def combine(base, scale):  # (j1, k1): base^(j1 k1) * scale
            m = [pow(base, j1 * k1 % n, p) * scale % p for j1 in range(ws) for k1 in range(ws)]
            return fr.to_mont_limbs(m, dev).reshape(ws, ws, 8)

        self.tw_fwd, self.tw_inv = twiddle(w), twiddle(w_inv)
        self.W1_fwd = combine(pow(w, n2, p), 1)
        self.W1_inv = combine(pow(w_inv, n2, p), pow(ws, p - 2, p))

    def _run(self, data, inverse: bool):
        check_device(self.group, data, "data")
        kernels.check(data, "data", (self.n, 8), data.device)
        n1, n2 = self.n1, self.n2
        rows = data.view(n2, n1, 8)[:, self.rank].contiguous()  # x[j1 + n1*j2], j2 < n2
        a = self.dom2.ifft(rows) if inverse else self.dom2.fft(rows)
        a = fr.mul(a, self.tw_inv if inverse else self.tw_fwd)
        recv = torch.empty_like(a)
        dist.all_to_all_single(recv, a, group=self.group)  # chunk j1 from rank j1
        a = recv.view(n1, n2 // n1, 8)
        prod = fr.mul((self.W1_inv if inverse else self.W1_fwd)[:, :, None], a[:, None])
        out = prod[0]
        for j1 in range(1, n1):
            out = fr.add(out, prod[j1])  # (k1, n2 / n1, 8): this rank's block of k2
        full = _all_gather(self.group, out)  # (rank, k1, n2 / n1, 8)
        return full.transpose(0, 1).reshape(self.n, 8)

    def fft(self, coeffs):
        """coeffs (n, 8) Montgomery -> evaluations (n, 8)."""
        return self._run(coeffs, inverse=False)

    def ifft(self, evals):
        """evaluations (n, 8) -> coefficients (n, 8)."""
        return self._run(evals, inverse=True)

    def coset_fft(self, coeffs, k: int):
        return self.fft(fr.mul(coeffs, get_domain(self.n, self.device).power_ladder(k)))

    def coset_ifft(self, evals, k: int):
        k_inv = pow(k, R_MOD - 2, R_MOD)
        return fr.mul(self.ifft(evals), get_domain(self.n, self.device).power_ladder(k_inv))


def sharded_ntt_batch(group, data, inverse: bool = False, coset_k: int = None):
    """P polynomials (P, n, 8), P a multiple of ws, sharded on the batch
    axis: each rank transforms its block with NTTDomain (forward, inverse,
    coset forward or coset inverse); returns (P, n, 8) on every rank."""
    check_device(group, data, "data")
    P, n = data.shape[:2]
    dom = get_domain(n, data.device)
    rows = data[_block(P, group, "sharded_ntt_batch: rows")]
    if coset_k is not None:
        out = dom.coset_ifft_batch(rows, coset_k) if inverse else dom.coset_fft_batch(rows, coset_k)
    else:
        out = dom.ifft_batch(rows) if inverse else dom.fft_batch(rows)
    return _all_gather(group, out).reshape(P, n, 8)


# --------------------------------------------------------------- dry run


def dryrun_multichip(group, prove: bool = False) -> bool:
    """The sharded path at tiny shapes on `group`, every rank the same seeded
    inputs, checked against host math and the single-device NTT: the point-
    and proof-sharded MSMs, ShardedNTT forward, inverse and coset, the
    batch-sharded NTT; with `prove`, a one-card shuffle proof through a KZG
    on the group (`_dryrun_prove_on_mesh`)."""
    from ..curve.bn254 import G1_GEN, g1_mul

    ws, dev = dist.get_world_size(group), group_device(group)
    rng = random.Random(1234)

    n_pts = 8 * ws
    pts = [g1_mul(G1_GEN, rng.randrange(1, R_MOD)) for _ in range(n_pts)]
    rows = [[rng.randrange(R_MOD) for _ in range(n_pts)] for _ in range(2)]
    if sharded_msm(group, pts, rows) != [host_msm(pts, row) for row in rows]:
        raise AssertionError("sharded MSM mismatch")

    n = max(16 * ws, ws * ws)
    n = 1 << (n - 1).bit_length()
    sntt, dom = ShardedNTT(n, group), get_domain(n, dev)
    coefs = [rng.randrange(R_MOD) for _ in range(n)]
    x = fr.to_mont_limbs(coefs, dev)
    ev = sntt.fft(x)
    if not torch.equal(ev, dom.fft(x)):
        raise AssertionError("sharded NTT mismatch")
    if fr.from_mont_limbs(sntt.ifft(ev)) != coefs:
        raise AssertionError("sharded iNTT roundtrip mismatch")
    if not torch.equal(sntt.coset_fft(x, 7), dom.coset_fft(x, 7)):
        raise AssertionError("sharded coset NTT mismatch")

    rows_dp = [[rng.randrange(R_MOD) for _ in range(n_pts)] for _ in range(ws)]
    if sharded_commit_batch(group, pts, rows_dp) != [host_msm(pts, row) for row in rows_dp]:
        raise AssertionError("dp-sharded commit mismatch")
    batch = fr.to_mont_limbs([rng.randrange(R_MOD) for _ in range(ws * n)], dev).reshape(ws, n, 8)
    if not torch.equal(sharded_ntt_batch(group, batch), dom.fft_batch(batch)):
        raise AssertionError("dp-sharded batch NTT mismatch")
    if prove:
        _dryrun_prove_on_mesh(rng, group)
    return True


def _dryrun_prove_on_mesh(rng, group):
    """A one-card shuffle proof through a KZG on `group`, so that every
    Lagrange commit rides the sharded MSM and the batched NTTs ride
    sharded_ntt_batch; verified by the port's verifier."""
    from ..pcs.kzg import KZG
    from ..plonk.indexer import indexer, refresh_prover_params_public_key
    from ..shuffle import app

    joint, deck = app.seeded_game(rng, 1)
    cs, _ = app.build_cs(rng, joint, deck)
    kzg = KZG.setup_insecure(cs.size + 8, 123456789, domain_n=cs.size,
                             device=group_device(group), group=group)
    pp = indexer(cs, kzg, with_shuffle=True)
    refresh_prover_params_public_key(pp, cs, kzg, joint)
    proof, outputs = app.prove_shuffle(rng, joint, deck, pp, kzg)
    if not app.verify_shuffle(pp.verifier_params, kzg, deck, outputs, proof):
        raise AssertionError("mesh-routed shuffle proof failed verification")
