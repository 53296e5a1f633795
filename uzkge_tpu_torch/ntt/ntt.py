"""Radix-2 NTT over BN254 Fr on torch tensors.

Counterpart of `uzkge_tpu/ntt/ntt.py::NTTDomain`, with ark-poly
`Radix2EvaluationDomain` semantics: natural-order evaluations at
[w^0 .. w^{n-1}], the root derived from Fr's 2-adic root of unity.  Every
domain with n >= 2 runs through the four-step plan of ntt/cuda_ntt.py, whose
passes are the ntt_pass kernel on a card and its plain version on the CPU.

Tensors are (n, 8) or (B, n, 8) int32 Montgomery limbs on the domain's
device.  Coset scales (k^j before an fft, n^-1 k^-j after an ifft) ride as
pre / post ladders of the passes; the plain ifft's n^-1 rides as a constant.
"""

import torch

from ..device import resolve
from ..errors import GroupNotFound
from ..ff.field import fr
from ..ff.host_field import Fr
from .cuda_ntt import build_plan, fft_mid


class NTTDomain:
    """A size-n radix-2 evaluation domain with tables on `device`."""

    def __init__(self, n: int, device=None, ctx=fr):
        if n <= 0 or n & (n - 1) or n.bit_length() - 1 > Fr.two_adicity:
            raise GroupNotFound(n)
        self.n = n
        self.ctx = ctx
        self.device = resolve(device)
        p = ctx.p
        self.omega = Fr.root_of_unity(n) if n > 1 else 1
        self.omega_inv = pow(self.omega, p - 2, p)
        self.n_inv = pow(n, p - 2, p)
        pows = [1]
        for _ in range(n - 1):
            pows.append(pows[-1] * self.omega % p)
        self._pows_int = pows
        self.master = ctx.to_mont_limbs(pows, self.device).reshape(n, 8)
        self.n_inv_arr = ctx.to_mont_limbs(self.n_inv, self.device)
        if n > 1:
            self._plan_fwd = build_plan(self.master, n, n, 1, inverse=False)
            self._plan_inv = build_plan(self.master, n, n, 1, inverse=True)
        self._ladders = {}
        self._post_ladders = {}

    def _run(self, x, inverse: bool, pre=None, post=None):
        """x: (B, n, 8) -> (B, n, 8) natural-order (i)NTT."""
        if self.n == 1:
            out = x
            for lad in (pre, post):
                if lad is not None:
                    out = self.ctx.mul(out, lad)
            return self.ctx.mul(out, self.n_inv_arr) if inverse and post is None else out
        plan = self._plan_inv if inverse else self._plan_fwd
        const = self.n_inv_arr if inverse and post is None else None
        out = fft_mid(x[:, :, None, :].contiguous(), plan, pre=pre, post=post, const=const)
        return out.reshape(x.shape)

    def _pad(self, x):
        """Zero-pad axis -2 up to n."""
        m = x.shape[-2]
        assert m <= self.n
        if m < self.n:
            pad = torch.zeros(x.shape[:-2] + (self.n - m, 8), dtype=x.dtype, device=x.device)
            x = torch.cat([x, pad], dim=-2)
        return x

    def fft(self, coeffs):
        """coeffs (m <= n, 8) -> evaluations (n, 8) at [w^0 .. w^{n-1}]."""
        return self._run(self._pad(coeffs)[None], inverse=False)[0]

    def ifft(self, evals):
        """evaluations (n, 8) -> coefficients (n, 8)."""
        return self._run(evals[None], inverse=True)[0]

    def fft_batch(self, coeffs):
        """(B, m <= n, 8) -> (B, n, 8)."""
        return self._run(self._pad(coeffs), inverse=False)

    def ifft_batch(self, evals):
        return self._run(evals, inverse=True)

    def power_ladder(self, k: int):
        """(n, 8) Montgomery limbs of k^j, j < n (cached per k)."""
        key = k % self.ctx.p
        got = self._ladders.get(key)
        if got is None:
            p = self.ctx.p
            out = [1]
            for _ in range(self.n - 1):
                out.append(out[-1] * key % p)
            got = self.ctx.to_mont_limbs(out, self.device)
            self._ladders[key] = got
        return got

    def coset_fft_batch(self, coeffs, k: int):
        """(B, m <= n, 8) coefficients -> evaluations on the coset k*H."""
        return self._run(self._pad(coeffs), inverse=False, pre=self.power_ladder(k))

    def coset_fft(self, coeffs, k: int):
        return self.coset_fft_batch(self._pad(coeffs)[None], k)[0]

    def _coset_post_ladder(self, k: int):
        """(n, 8) ladder of n^-1 * k^-j (the fused coset_ifft post scale)."""
        key = k % self.ctx.p
        got = self._post_ladders.get(key)
        if got is None:
            p = self.ctx.p
            k_inv = pow(key, p - 2, p)
            got = self.ctx.mul(self.power_ladder(k_inv), self.n_inv_arr)
            self._post_ladders[key] = got
        return got

    def coset_ifft_batch(self, evals, k: int):
        """Inverse of coset_fft_batch: (B, n, 8) -> (B, n, 8), each ifft'd with
        coefficient j scaled by k^-j."""
        return self._run(evals, inverse=True, post=self._coset_post_ladder(k))

    def coset_ifft(self, evals, k: int):
        """Inverse of coset_fft: ifft, then scale coefficient j by k^-j."""
        return self.coset_ifft_batch(evals[None], k)[0]

    def elements(self):
        """Host-side domain elements [1, w, w^2, ...] as python ints."""
        return list(self._pows_int)


_DOMAINS = {}


def get_domain(n: int, device=None) -> NTTDomain:
    """The cached size-n domain on `device`."""
    dev = resolve(device)
    key = (n, str(dev))
    dom = _DOMAINS.get(key)
    if dom is None:
        dom = NTTDomain(n, dev)
        _DOMAINS[key] = dom
    return dom
