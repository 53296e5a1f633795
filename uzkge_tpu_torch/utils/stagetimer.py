"""Named wall-clock stages for the prover hot path.

Counterpart of `uzkge_tpu/utils/stagetimer.py`, with the same API.  Stage
times accumulate in a process-wide dict that `snapshot()` reads (chip_smoke.py
prints it as the stage breakdown).

    with stage("r3_t_kernel", block=t_evals):
        ...

`block` (optional) is a tensor: on exit the stage waits for its device
(torch.cuda.synchronize) so that work launched asynchronously is charged to
the stage that launched it, not to the next host sync.
"""

import time
from collections import defaultdict
from contextlib import contextmanager

import torch

_acc = defaultdict(float)


def reset():
    _acc.clear()


def snapshot(round_to: int = 4):
    return {k: round(v, round_to) for k, v in sorted(_acc.items(), key=lambda kv: -kv[1])}


def total():
    return sum(_acc.values())


@contextmanager
def stage(name: str, block=None):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if isinstance(block, torch.Tensor) and block.is_cuda:
            torch.cuda.synchronize(block.device)
        dt = time.perf_counter() - t0
        _acc[name] += dt
