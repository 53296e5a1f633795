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
        kernels.LAUNCHES["fp_mont_mul"] += 1
    return out
