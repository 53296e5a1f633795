"""KZG polynomial commitments over BN254 with commits on torch tensors.

Counterpart of `uzkge_tpu/pcs/kzg.py::KZG`.  Lagrange-basis commits go
through the fixed-base table over the Lagrange basis (`lagrange_fb_table`,
msm/fixed_base.py) where `_fb_enabled` says so, as in the JAX package, and
through the Pippenger of msm/msm.py otherwise; the `fixed_base` argument
overrides the rule.  Coefficient-basis commits use the Pippenger.  Scheme
semantics are the reference's (kzg_poly_commitment.rs / pcs.rs): Lagrange-basis commits plus
`apply_blind_factors`, coefficient-basis commits over the contiguous SRS
prefix, the batch_prove alpha-combination and one multi-pairing check.
Opening arithmetic and pairings stay on the host (native_host, pcs/pairing).

Spans (utils/stagetimer.py), nested in the prover's stages: `kzg_msm` is a
commit's whole MSM on whichever route serves it, from the digit recode
through the read-back to host affine points; `kzg_blind` is
`apply_blind_factors` (native_host.g1_blind); `kzg_open_prepare` is
`batch_prove_multi`'s host phase (`_prepare_open`: transcript, alpha
combination, division).

A KZG given a torch.distributed process group (`group=`, the JAX package's
UZKGE_MESH=1) commits in the Lagrange basis through the sharded chain MSM of
parallel/sharded.py on every rank, before any other route: over the proof
axis when the batch divides among the ranks, else over the point axis.
"""

import threading
from typing import List, Optional

import torch
import torch.distributed as dist

from .. import native_host as nh
from ..constants.bn254 import R_MOD
from ..curve.bn254 import G2_GEN, g1_add, g1_mul, g1_neg, g2_mul
from ..device import resolve
from ..errors import DegreeError
from ..ff.field import fr
from ..ff.host_field import Fr
from ..msm.fixed_base import FixedBaseTable, _extract_host
from ..msm.msm import MSMBases, msm
from ..ntt.ntt import get_domain
from ..parallel.sharded import sharded_msm_batch, sharded_msm_device_sums
from ..utils.stagetimer import stage
from ..utils.transcript import Transcript
from .pairing import multi_pairing_is_one


def _fb_enabled(n: int, device: torch.device) -> bool:
    """Whether Lagrange commits over n bases go through the fixed-base table:
    always on the card, on the CPU only up to n = 512, where the table is
    cheap to build with the plain versions (the JAX package's rule,
    uzkge_tpu/pcs/kzg.py::_fb_enabled, without its environment override)."""
    return device.type == "cuda" or n <= 512


def _fb_window(n: int) -> int:
    """Window width c of the fixed-base table over n bases, the JAX package's
    rule (uzkge_tpu/pcs/kzg.py::_fb_window), kept for parity of the window:
    the larger of 8 and 4 whose table, 2^(c-1) * ceil(254/c) * n rows of
    64 B, fits 4.5 GB; c = 8 through n = 16384 (4.29 GB).  The budget was
    sized for a 16 GB TPU; an 80 GB card would hold a wider window."""
    for c in (8, 4):
        if (1 << (c - 1)) * ((254 + c - 1) // c) * n * 64 <= 4.5e9:
            return c
    return 4


class KZG:
    """SRS container + commitment operations; device structures on `device`
    (the card unless the caller passes another).  `fixed_base` routes the
    Lagrange commits: True through the fixed-base table, False through the
    Pippenger, None (the default) by `_fb_enabled`; a process group `group`
    (its device kind must be `device`'s) routes them through the sharded
    chain MSM instead, whatever `fixed_base` says."""

    def __init__(self, g1_powers: List, g2_powers: List, lagrange_bases: Optional[List] = None,
                 device=None, fixed_base: Optional[bool] = None, group=None):
        self.device = resolve(device)
        self.fixed_base = fixed_base
        self.group = group
        self.g1_powers = g1_powers  # affine points; None marks SRS padding gaps
        self.g2_powers = g2_powers  # [G2, s*G2]
        contig = 0
        while contig < len(g1_powers) and g1_powers[contig] is not None:
            contig += 1
        self.max_contig = contig
        self._coef_bases = None
        self._lagrange = None
        # the lazy table and MSM bases are built once, also when the threads
        # of parallel/batch.py commit through one KZG at once
        self._lazy_lock = threading.Lock()
        if lagrange_bases is not None:
            self.set_lagrange(lagrange_bases)

    @staticmethod
    def setup_insecure(max_degree: int, tau: int, domain_n: Optional[int] = None,
                       device=None, fixed_base: Optional[bool] = None, group=None) -> "KZG":
        """Dev/test SRS with a known tau, optionally with Lagrange bases over a
        size-n domain (reference `KZGCommitmentScheme::new`, kzg:183-204)."""
        g1 = [g1_mul((1, 2), pow(tau, i, R_MOD)) for i in range(max_degree + 1)]
        g2 = [G2_GEN, g2_mul(G2_GEN, tau)]
        lagrange = None
        if domain_n:
            # L_i(tau) * G = (w^i / n) * (tau^n - 1) / (tau - w^i) * G
            n = domain_n
            w = Fr.root_of_unity(n)
            n_inv = pow(n, R_MOD - 2, R_MOD)
            zt = (pow(tau, n, R_MOD) - 1) % R_MOD
            lagrange = []
            wi = 1
            for _ in range(n):
                li = wi * n_inv % R_MOD * zt % R_MOD * pow((tau - wi) % R_MOD, R_MOD - 2, R_MOD) % R_MOD
                lagrange.append(g1_mul((1, 2), li))
                wi = wi * w % R_MOD
        return KZG(g1, g2, lagrange, device=device, fixed_base=fixed_base, group=group)

    def set_lagrange(self, lagrange_bases: List):
        self._lagrange_points = lagrange_bases
        self._lagrange_n = len(lagrange_bases)
        self._lagrange = True
        self._lagrange_vb = None  # MSMBases, built on the first commit
        self._lagrange_fb = None  # FixedBaseTable, built on the first call
        self._lagrange_sh = None  # MSMBases for the sharded MSM, built on the first commit

    @property
    def lagrange_n(self):
        return self._lagrange_n if self._lagrange is not None else 0

    def lagrange_fb_table(self) -> FixedBaseTable:
        """The fixed-base table over the Lagrange basis on this KZG's device,
        with the window of _fb_window; built on the first call, then cached
        (kzg_poly_commitment.rs:290: one table serves every commit)."""
        if self._lagrange is None:
            raise ValueError("this KZG has no Lagrange bases")
        with self._lazy_lock:
            if self._lagrange_fb is None:
                self._lagrange_fb = FixedBaseTable(self._lagrange_points,
                                                   c=_fb_window(self._lagrange_n),
                                                   device=self.device)
        return self._lagrange_fb

    def uses_fixed_base(self) -> bool:
        """Whether Lagrange commits go through lagrange_fb_table()."""
        if self.group is not None:
            return False
        if self.fixed_base is not None:
            return self.fixed_base
        return _fb_enabled(self.lagrange_n, self.device)

    def _coef_msm_bases(self):
        with self._lazy_lock:
            if self._coef_bases is None:
                self._coef_bases = MSMBases(self.g1_powers[: self.max_contig], self.device)
        return self._coef_bases

    def _lagrange_msm_bases(self):
        with self._lazy_lock:
            if self._lagrange_vb is None:
                self._lagrange_vb = MSMBases(self._lagrange_points, self.device)
        return self._lagrange_vb

    # ------------------------------------------------------------ committing

    def commit_coefs(self, coefs: List[int]):
        """Coefficient-basis commit of host scalars."""
        if len(coefs) > self.max_contig:
            raise DegreeError(
                f"degree {len(coefs) - 1} exceeds contiguous SRS prefix {self.max_contig - 1}"
            )
        with stage("kzg_msm"):
            bases = self._coef_msm_bases()
            padded = list(coefs) + [0] * (bases.n - len(coefs))
            return msm(bases, padded)

    def commit_evals_batch(self, evals):
        """Lagrange-basis commits of a (P, n, 8) batch of Montgomery
        evaluations on the device -> list of host affine points."""
        assert self._lagrange is not None
        with stage("kzg_msm"):
            batch = (evals if evals.dim() == 3 else evals[None]).contiguous()
            if self.group is not None:
                return _extract_host(*self._sharded_commit(batch))
            if self.uses_fixed_base():
                return self.lagrange_fb_table().msm_mont(batch)
            return msm(self._lagrange_msm_bases(), batch)

    def _sharded_commit(self, batch):
        """Projective sums of a (P, n, 8) batch through the sharded chain MSM
        (`commit_evals_batch`'s mesh route)."""
        if self._lagrange_sh is None:
            self._lagrange_sh = MSMBases(self._lagrange_points, self.device)
        b = self._lagrange_sh
        if batch.shape[0] % dist.get_world_size(self.group) == 0:
            return sharded_msm_batch(self.group, b.x, b.y, batch)
        return sharded_msm_device_sums(self.group, b.x, b.y, batch)

    def commit_evals(self, evals):
        """Lagrange-basis commit of one (n, 8) vector of evaluations."""
        return self.commit_evals_batch(evals[None] if evals.dim() == 2 else evals)[0]

    def apply_blind_factors(self, cm, blinds: List[int], zeroing_degree: int):
        """cm + sum_i b_i * (G_i - G_{zeroing+i}) (kzg:299-313): the nonzero
        blinds' terms in one call of the native `g1_blind`."""
        with stage("kzg_blind"):
            points, scalars = [], []
            for i, b in enumerate(blinds):
                if b % R_MOD == 0:
                    continue
                points += [self.g1_powers[i], self.g1_powers[zeroing_degree + i]]
                scalars += [b, -b]
            return nh.g1_blind(cm, points, scalars) if points else cm

    # --------------------------------------------------------------- opening

    @staticmethod
    def _transcript_append_params(transcript: Transcript, max_degree: int, point: int):
        transcript.append_message(b"New PCS-Batch-Eval Protocol")
        transcript.append_message(Fr.p.to_bytes(32, "big"))
        transcript.append_u64(max_degree)
        transcript.append_field_elem(point)

    def _prepare_open(self, transcript: Transcript, poly_blobs, point: int,
                      max_degree: int, use_lagrange: bool = True):
        """Host phase of one opening: transcript interaction and quotient
        division.  Returns ("lagrange", head_bytes, blinds, max_pow2) or
        ("coefs", coef_list)."""
        self._transcript_append_params(transcript, max_degree, point)
        alpha = transcript.get_challenge(R_MOD)

        maxlen = max(len(b) // 32 for b in poly_blobs)
        h_blob, _evals = nh.alpha_combine_bytes(poly_blobs, alpha, point, maxlen)
        q_blob, rem = nh.synthetic_div_bytes(h_blob, point)
        assert rem == 0, "batch_prove: nonzero remainder"
        nq = len(q_blob) // 32
        while nq > 1 and q_blob[(nq - 1) * 32 : nq * 32] == b"\x00" * 32:
            nq -= 1
        q_blob = q_blob[: nq * 32]

        degree = nq - 1
        max_pow2 = degree
        for i in range(degree, -1, -1):
            if i & (i - 1) == 0:
                max_pow2 = i
                break
        if use_lagrange and self._lagrange is not None and max_pow2 == self._lagrange_n:
            # commit the low part in the Lagrange basis and shift the high
            # coefficients up with blind factors (reference pcs.rs:138-164)
            blinds = [
                (-int.from_bytes(q_blob[i * 32 : (i + 1) * 32], "little")) % R_MOD
                for i in range(max_pow2, nq)
            ]
            head = bytearray(q_blob[: max_pow2 * 32])
            for i, v in enumerate(blinds):
                c = (int.from_bytes(head[i * 32 : (i + 1) * 32], "little") - v) % R_MOD
                head[i * 32 : (i + 1) * 32] = c.to_bytes(32, "little")
            return ("lagrange", bytes(head), blinds, max_pow2)
        coefs = [int.from_bytes(q_blob[i * 32 : (i + 1) * 32], "little") for i in range(nq)]
        return ("coefs", coefs)

    def _commit_prepared(self, prepared):
        """Commit a list of _prepare_open results; the Lagrange-path entries
        share one batched MSM."""
        out = [None] * len(prepared)
        lag = [(i, p) for i, p in enumerate(prepared) if p[0] == "lagrange"]
        if lag:
            mp = lag[0][1][3]
            assert all(p[3] == mp for _, p in lag)
            heads = torch.stack([fr.to_mont_limbs_from_bytes(p[1], self.device) for _, p in lag])
            evals = get_domain(mp, self.device).fft_batch(heads)
            cms = self.commit_evals_batch(evals)
            for (i, p), cm in zip(lag, cms):
                out[i] = self.apply_blind_factors(cm, p[2], p[3])
        for i, p in enumerate(prepared):
            if p[0] == "coefs":
                out[i] = self.commit_coefs(p[1])
        return out

    def batch_prove_multi(self, transcript: Transcript, opens, max_degree: int):
        """Open several batches of polynomials, each at its own point
        (pcs.rs:107-168); their quotient commitments ride one batched MSM.
        `opens`: list of (poly_blobs, point), the blobs packed 32-byte LE
        coefficients."""
        with stage("kzg_open_prepare"):
            prepared = [
                self._prepare_open(transcript, blobs, point, max_degree)
                for blobs, point in opens
            ]
        return self._commit_prepared(prepared)

    @staticmethod
    def batch_combine(transcript: Transcript, commitments: List, max_degree: int, point: int,
                      evals: List[int]):
        """Verifier-side alpha-combination (pcs.rs:171-191)."""
        KZG._transcript_append_params(transcript, max_degree, point)
        alpha = transcript.get_challenge(R_MOD)
        mult = 1
        cm_comb = None
        ev_comb = 0
        for ev, cm in zip(evals, commitments):
            cm_comb = g1_add(cm_comb, g1_mul(cm, mult))
            ev_comb = (ev_comb + ev * mult) % R_MOD
            mult = mult * alpha % R_MOD
        return cm_comb, ev_comb

    def batch_verify_diff_points(self, cm_vec, point_vec, eval_vec, proofs, challenge: int) -> bool:
        """u-combined two-point check with one multi-pairing (kzg:373-423)."""
        g1_0 = self.g1_powers[0]
        g2_0, g2_1 = self.g2_powers[0], self.g2_powers[1]
        left_first = proofs[0]
        right_first = g1_mul(proofs[0], point_vec[0])
        right_val = eval_vec[0]
        right_comm = cm_vec[0]
        cur = challenge
        for i in range(1, len(proofs)):
            new_comm = g1_mul(proofs[i], cur)
            left_first = g1_add(left_first, new_comm)
            right_first = g1_add(right_first, g1_mul(new_comm, point_vec[i]))
            right_val = (right_val + eval_vec[i] * cur) % R_MOD
            right_comm = g1_add(right_comm, g1_mul(cm_vec[i], cur))
            cur = cur * challenge % R_MOD
        right_first = g1_add(right_first, g1_neg(g1_mul(g1_0, right_val)))
        right_first = g1_add(right_first, right_comm)
        return multi_pairing_is_one([(left_first, g2_1), (g1_neg(right_first), g2_0)])
