"""Recursive four-step NTT over the ntt_pass kernel.

Counterpart of `uzkge_tpu/ntt/pallas_ntt.py`: the same plan tree and
recursion, with the on-chip pass done by the hand-written CUDA kernel
`csrc/ntt.cu::ntt_pass_kernel` (which replaces `_direct_kernel`).

Arrays are (OUT, S, IN, 8) int32 Montgomery limbs; the FFT runs over axis 1.

    FFT_S, root w^stride:
      S <= SMAX: one ntt_pass.
      S > SMAX: split S = S2*S1 -> recurse over S2 (IN' = S1*IN) with the
        inter-factor twiddle T[k2, j1] = w^(stride*j1*k2) as the post ladder,
        transpose S1 <-> S2, recurse over S1, flatten (k1, S2).

The outer pre ladder rides down the left branch and the outer post ladder
and constant ride down the right branch: ladders are flat (S*IN, 8) tensors
in input / output enumeration, which the recursion preserves.  A ladder
given as None is skipped (no multiply), as in pallas_ntt.fft_mid.
"""

import numpy as np
import torch

from .. import kernels
from ..ff.field import W, fr, lift, lower
from .stockham import stage_twiddles_strided

SMAX = 1024  # largest single-pass sub-FFT: S elements of 32 bytes in shared memory


def build_plan(master_mont: torch.Tensor, n_total: int, size: int, stride: int,
               inverse: bool) -> dict:
    """Plan tree for a size-`size` sub-FFT with root master^stride."""
    if size <= SMAX:
        tws = stage_twiddles_strided(master_mont, n_total, size, stride, inverse)
        return {"S": size, "tws": tws}
    S1 = min(SMAX, size // 2)
    S2 = size // S1
    plan2 = build_plan(master_mont, n_total, S2, stride * S1, inverse)
    plan1 = build_plan(master_mont, n_total, S1, stride * S2, inverse)
    idx = (np.outer(np.arange(S2), np.arange(S1)) * stride) % n_total
    if inverse:
        idx = (-idx) % n_total
    T = master_mont[torch.from_numpy(idx.reshape(-1)).to(master_mont.device)]
    return {"S": size, "S2": S2, "S1": S1, "plan2": plan2, "plan1": plan1,
            "T": T.reshape(S2, S1, 8)}


def ntt_pass_plain(x, tw, pre=None, post=None, const=None):
    """Torch-op version of the ntt_pass kernel (same arguments, same result)."""
    OUT, S, IN, _ = x.shape
    w = lift(x)  # (W, OUT, S, IN)
    if pre is not None:
        w = fr.wmul(w, lift(pre)[:, None])
    tw_w = lift(tw)  # (W, S/2)
    m, l, t = S // 2, 1, 0
    while m >= 1:
        a, b = w[:, :, : S // 2], w[:, :, S // 2 :]
        s = fr.wadd(a, b)
        d = fr.wsub(a, b)
        if m > 1:
            e = (torch.arange(S // 2, device=x.device) >> t) << t
            d = fr.wmul(d, tw_w[:, e][:, None, :, None])
        s = s.reshape(W, OUT, m, 1, l, IN)
        d = d.reshape(W, OUT, m, 1, l, IN)
        w = torch.cat([s, d], dim=3).reshape(W, OUT, S, IN)
        m, l, t = m // 2, l * 2, t + 1
    if post is not None:
        w = fr.wmul(w, lift(post)[:, None])
    if const is not None:
        w = fr.wmul(w, lift(const).reshape(W, 1, 1, 1))
    return lower(w)


def ntt_pass(x, tw, pre=None, post=None, const=None):
    """Natural-order radix-2 FFT of size S over axis 1 of a contiguous
    (OUT, S, IN, 8) Fr tensor.  tw: (S/2, 8) stage-0 twiddles; pre / post:
    None or (S, IN, 8) ladders multiplied in on load / on store; const: None
    or (8,) multiplied in on store.  CPU tensors take the plain version, CUDA
    tensors the kernel."""
    OUT, S, IN, _ = x.shape
    dev = x.device
    kernels.check(x, "x", (OUT, S, IN, 8), dev)
    kernels.check(tw, "tw", (S // 2, 8), dev)
    for lad, name in ((pre, "pre"), (post, "post")):
        if lad is not None:
            kernels.check(lad, name, (S, IN, 8), dev)
    if const is not None:
        kernels.check(const, "const", (8,), dev)
    if dev.type == "cpu":
        return ntt_pass_plain(x, tw, pre, post, const)
    if dev.type != "cuda":
        raise ValueError(f"ntt_pass: unsupported device {dev}")
    if S < 2 or S > SMAX or S & (S - 1):
        raise ValueError(f"ntt_pass: S = {S} outside the kernel's [2, {SMAX}] powers of two")
    y = torch.empty_like(x)
    kernels.launch("ntt_pass_launch", x.data_ptr(), y.data_ptr(), tw.data_ptr(),
                   kernels.ptr(pre), kernels.ptr(post), kernels.ptr(const),
                   OUT, S, IN, kernels.stream_of(x))
    kernels.LAUNCHES["ntt_pass"] += 1
    return y


def _direct_pass(x, plan, pre, post, const):
    """x: (OUT, S, IN, 8) -> same shape, FFT over axis 1.
    pre / post: None or flat (S*IN, 8) ladders."""
    OUT, S, IN, _ = x.shape
    pre = None if pre is None else pre.reshape(S, IN, 8)
    post = None if post is None else post.reshape(S, IN, 8)
    return ntt_pass(x.contiguous(), plan["tws"][0], pre, post, const)


def _expand_T(plan, IN: int):
    """(S2, S1, 8) inter-factor twiddle -> flat (S2*S1*IN, 8) post ladder,
    cached per lane width."""
    cache = plan.setdefault("_Texp", {})
    if IN not in cache:
        T = plan["T"]
        cache[IN] = T[:, :, None, :].expand(T.shape[0], T.shape[1], IN, 8).reshape(-1, 8).contiguous()
    return cache[IN]


def fft_mid(x, plan, pre=None, post=None, const=None):
    """FFT over axis 1 of (OUT, S, IN, 8) per `plan`; natural order."""
    if "tws" in plan:
        return _direct_pass(x, plan, pre, post, const)
    S2, S1 = plan["S2"], plan["S1"]
    OUT, S, IN, _ = x.shape
    a = x.reshape(OUT, S2, S1 * IN, 8)
    a = fft_mid(a, plan["plan2"], pre=pre, post=_expand_T(plan, IN))
    a = a.reshape(OUT, S2, S1, IN, 8).transpose(1, 2).contiguous().reshape(OUT, S1, S2 * IN, 8)
    a = fft_mid(a, plan["plan1"], post=post, const=const)
    return a.reshape(OUT, S, IN, 8)
