"""Per-stage twiddle tables of a radix-2 Stockham sub-FFT.

Counterpart of the table builders of `uzkge_tpu/ntt/stockham.py`.  The
butterflies themselves run in the ntt_pass kernel and its plain version
(ntt/cuda_ntt.py)."""

from typing import List

import numpy as np
import torch


def stage_twiddles_strided(master_mont: torch.Tensor, n: int, size: int, stride: int,
                           inverse: bool) -> List[torch.Tensor]:
    """Twiddles for a length-`size` sub-FFT whose root is w^stride (w = the
    order-n master root, `master_mont` its (n, 8) power table): stage t
    needs (w^stride)^(j*2^t) for j < size/2^(t+1), as an (m, 8) tensor.
    Stage t's table is stage 0's table taken every 2^t entries."""
    out = []
    m, l = size // 2, 1
    while m >= 1:
        idx = (np.arange(m) * l * stride) % n
        if inverse:
            idx = (-idx) % n
        out.append(master_mont[torch.from_numpy(idx).to(master_mont.device)].contiguous())
        m //= 2
        l *= 2
    return out
