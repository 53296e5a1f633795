"""Time uzkge_tpu_torch's fq_batch_inv on the card under several cuts of its
product tree: the measurement that chose INV_GROUP and INV_ROOTS in
uzkge_tpu_torch/msm/fixed_base.py.

At the P = 8 query's three level sizes (2^21, 2^20, 2^19) and the table
build's 2^23, each cut of CUTS (G elements per strided group, at most `roots`
groups in the last level) is timed with CUDA events (mean of 5 after a
warm-up) and its output held equal, limb for limb, to the module's cut.
Needs one NVIDIA card; from the root of the repo:

    python3 tools/tune_batch_inv.py
"""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from uzkge_tpu_torch.msm import fixed_base as fb  # noqa: E402

# (group size, most groups in the last level)
CUTS = ((16, 1 << 17), (16, 1 << 13), (32, 1 << 16), (32, 1 << 12), (8, 1 << 18), (16, 4096))


def main():
    if not torch.cuda.is_available():
        sys.exit("tune_batch_inv: needs an NVIDIA card (CUDA)")
    dev = torch.device("cuda:0")
    torch.manual_seed(0)
    print(cs.card_line(), flush=True)
    for N in (1 << 21, 1 << 20, 1 << 19, 1 << 23):
        a = cs.random_fr(N, dev)  # below 2^252 < q; nonzero with overwhelming probability
        want = fb.fq_batch_inv(a)
        row = []
        for group, roots in CUTS:
            levels = fb.batch_inv_levels(N, group, roots)
            ms, got = cs.cuda_ms(lambda: fb._batch_inv_launches(a, levels))
            if not torch.equal(got, want):
                raise AssertionError(f"fq_batch_inv N={N} cut ({group}, {roots}) disagrees")
            row.append(f"G={group} roots={roots} ({2 * len(levels) - 1} launches) {ms:.4f} ms")
        print(f"fq_batch_inv N={N} by cut: " + "; ".join(row), flush=True)


if __name__ == "__main__":
    main()
