"""Elementwise Montgomery product on the card: the fp_mont_mul kernel.

Counterpart of `uzkge_tpu/ff/pallas_field.py::pmul` (through `_pmul_flat`
and the Pallas `_mul_kernel`): a * b * R^-1 mod p for Fr or Fq, element by
element.  The kernel is csrc/mont_mul.cu; its plain version is the torch-op
product of ff/field.py.  A CPU tensor takes the plain version, a CUDA tensor
the kernel.
"""

import torch

from .. import kernels
from .field import MontField, fq, fr


def fp_mont_mul_plain(ctx: MontField, a, b):
    """Torch-op version of the fp_mont_mul kernel."""
    return ctx.mul(a, b)


def fp_mont_mul(ctx: MontField, a, b):
    """a * b * R^-1 mod p elementwise; ctx is ff.field.fr or ff.field.fq, a and
    b contiguous int32 tensors of one shape (..., 8) on one device."""
    if ctx is not fr and ctx is not fq:
        raise ValueError("fp_mont_mul: ctx must be ff.field.fr or ff.field.fq")
    shape, dev = tuple(a.shape), a.device
    if not shape or shape[-1] != 8:
        raise ValueError(f"fp_mont_mul: shape {shape}, want (..., 8)")
    kernels.check(a, "a", shape, dev)
    kernels.check(b, "b", shape, dev)
    if not kernels.use_kernel(dev, "fp_mont_mul"):
        return fp_mont_mul_plain(ctx, a, b)
    out = torch.empty_like(a)
    if out.numel():
        kernels.launch("fp_mont_mul_launch", a.data_ptr(), b.data_ptr(), out.data_ptr(),
                       a.numel() // 8, 0 if ctx is fr else 1, kernels.stream_of(a))
        kernels.count("fp_mont_mul")
    return out


CHAINS = 4  # independent chains per thread of fp_mul_chain (csrc/mont_mul.cu FP_CHAINS)


def fp_mul_chain_plain(ctx: MontField, a, b, iters: int):
    """Torch-op version of the fp_mul_chain kernel."""
    out = a
    for _ in range(iters):
        out = ctx.mul(out, b.expand_as(a))
    return out


def fp_mul_chain(ctx: MontField, a, b, iters: int):
    """a * b^iters * R^-iters: `iters` Montgomery products in a row on each of
    the CHAINS chains of a (CHAINS, N, 8), b (N, 8).  The kernel measures the
    product rate of the card (one thread per n runs its CHAINS chains side by
    side); it is no part of the prover."""
    if ctx is not fr and ctx is not fq:
        raise ValueError("fp_mul_chain: ctx must be ff.field.fr or ff.field.fq")
    if a.dim() != 3 or a.shape[0] != CHAINS or iters < 0:
        raise ValueError(f"fp_mul_chain: a of shape {tuple(a.shape)}, iters {iters}: want "
                         f"({CHAINS}, N, 8) and iters >= 0")
    N, dev = a.shape[1], a.device
    kernels.check(a, "a", (CHAINS, N, 8), dev)
    kernels.check(b, "b", (N, 8), dev)
    if not kernels.use_kernel(dev, "fp_mul_chain"):
        return fp_mul_chain_plain(ctx, a, b, iters)
    out = torch.empty_like(a)
    kernels.launch("fp_mul_chain_launch", a.data_ptr(), b.data_ptr(), out.data_ptr(), N, iters,
                   0 if ctx is fr else 1, kernels.stream_of(a))
    kernels.count("fp_mul_chain")
    return out
