"""KZG polynomial commitments over BN254 with commits on torch tensors.

Counterpart of `uzkge_tpu/pcs/kzg.py::KZG`, on its variable-base path:
every commit is the Pippenger of msm/msm.py.  Scheme semantics are the
reference's (kzg_poly_commitment.rs / pcs.rs): Lagrange-basis commits plus
`apply_blind_factors`, coefficient-basis commits over the contiguous SRS
prefix, the batch_prove alpha-combination and one multi-pairing check.
Opening arithmetic and pairings stay on the host (native_host, pcs/pairing).
"""

from typing import List, Optional

import torch

from uzkge_tpu import native_host as nh
from uzkge_tpu.constants.bn254 import R_MOD
from uzkge_tpu.curve.bn254 import G2_GEN, g1_add, g1_mul, g1_neg, g2_mul
from uzkge_tpu.errors import DegreeError
from uzkge_tpu.ff.field import Fr
from uzkge_tpu.pcs.pairing import multi_pairing_is_one
from uzkge_tpu.utils.transcript import Transcript

from ..ff.field import fr
from ..msm.msm import MSMBases, msm
from ..ntt.ntt import get_domain


class KZG:
    """SRS container + commitment operations; device structures on `device`."""

    def __init__(self, g1_powers: List, g2_powers: List, lagrange_bases: Optional[List] = None,
                 device=None):
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.g1_powers = g1_powers  # affine points; None marks SRS padding gaps
        self.g2_powers = g2_powers  # [G2, s*G2]
        contig = 0
        while contig < len(g1_powers) and g1_powers[contig] is not None:
            contig += 1
        self.max_contig = contig
        self._coef_bases = None
        self._lagrange = None
        if lagrange_bases is not None:
            self.set_lagrange(lagrange_bases)

    @staticmethod
    def setup_insecure(max_degree: int, tau: int, domain_n: Optional[int] = None,
                       device=None) -> "KZG":
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
        return KZG(g1, g2, lagrange, device=device)

    def set_lagrange(self, lagrange_bases: List):
        self._lagrange_points = lagrange_bases
        self._lagrange_n = len(lagrange_bases)
        self._lagrange = True
        self._lagrange_vb = None  # MSMBases, built on the first commit

    @property
    def lagrange_n(self):
        return self._lagrange_n if self._lagrange is not None else 0

    def _coef_msm_bases(self):
        if self._coef_bases is None:
            self._coef_bases = MSMBases(self.g1_powers[: self.max_contig], self.device)
        return self._coef_bases

    # ------------------------------------------------------------ committing

    def commit_coefs(self, coefs: List[int]):
        """Coefficient-basis commit of host scalars."""
        if len(coefs) > self.max_contig:
            raise DegreeError(
                f"degree {len(coefs) - 1} exceeds contiguous SRS prefix {self.max_contig - 1}"
            )
        bases = self._coef_msm_bases()
        padded = list(coefs) + [0] * (bases.n - len(coefs))
        return msm(bases, padded)

    def commit_evals_batch(self, evals):
        """Lagrange-basis commits of a (P, n, 8) batch of Montgomery
        evaluations on the device -> list of host affine points."""
        assert self._lagrange is not None
        batch = evals if evals.dim() == 3 else evals[None]
        if self._lagrange_vb is None:
            self._lagrange_vb = MSMBases(self._lagrange_points, self.device)
        return msm(self._lagrange_vb, batch)

    def apply_blind_factors(self, cm, blinds: List[int], zeroing_degree: int):
        """cm + sum_i b_i * (G_i - G_{zeroing+i}) (kzg:299-313)."""
        out = cm
        for i, b in enumerate(blinds):
            if b % R_MOD == 0:
                continue
            out = g1_add(out, g1_mul(self.g1_powers[i], b))
            out = g1_add(out, g1_mul(self.g1_powers[zeroing_degree + i], (-b) % R_MOD))
        return out

    # --------------------------------------------------------------- opening

    @staticmethod
    def _transcript_append_params(transcript: Transcript, max_degree: int, point: int):
        transcript.append_message(b"New PCS-Batch-Eval Protocol")
        transcript.append_message(Fr.p.to_bytes(32, "big"))
        transcript.append_u64(max_degree)
        transcript.append_field_elem(point)

    def _prepare_open(self, transcript: Transcript, poly_blobs, point: int,
                      max_degree: int, use_lagrange: bool = True):
        """Host phase of batch_prove: transcript interaction and quotient
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

    def batch_prove(self, transcript: Transcript, poly_blobs, point: int,
                    max_degree: int, use_lagrange: bool = True):
        """Open several polynomials at one point (pcs.rs:107-168).
        `poly_blobs`: packed 32-byte LE coefficient blobs."""
        prep = self._prepare_open(transcript, poly_blobs, point, max_degree, use_lagrange)
        return self._commit_prepared([prep])[0]

    def batch_prove_multi(self, transcript: Transcript, opens, max_degree: int):
        """Several batch_prove calls whose quotient commitments ride one
        batched MSM.  `opens`: list of (poly_blobs, point)."""
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
