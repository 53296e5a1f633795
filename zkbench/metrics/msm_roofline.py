"""The variable-base Pippenger's share of its roofline, in %: the least time
of every call of the traced window (yardstick.msm_bounds.msm_s, from its
scalars' nonzero 8-bit digits) over the device time of the accumulate's and
the reduce's kernels.  The calls are those the Groth16 prover made in the
window's requests, as the reveal app observed them (kept in the run's
configuration under `apps/reveal.py`'s `OBSERVED`).  None, and why on
standard error, where the calls observed differ from the program's count of
`msm_bucket_reduce` launches, or a call went to the host Pippenger."""

import sys

from ..apps import reveal
from ..yardstick.msm_bounds import msm_s, nonzero_digits

KERNELS = ("msm_bucket_accumulate_sort_kernel", "msm_bucket_accumulate_piece_kernel",
           "msm_bucket_accumulate_merge_kernel", "msm_bucket_reduce_kernel")


def _skip(why):
    print(f"msm_roofline: {why}; left out", file=sys.stderr, flush=True)


def read(run):
    t, served = run.trace, run.config.get(reveal.OBSERVED, [])
    if t is None or not run.stages or len(served) < len(run.stages):
        return None
    window = served[-len(run.stages):]
    calls = [c for req in window for c in req["calls"]]
    launched = sum(req["reduce_launches"] for req in window)
    if not calls:
        return None
    if any(host for *_, host in calls):
        _skip("a call went to the host Pippenger (HOST_MSM_MAX)")
        return None
    if len(calls) != launched:
        _skip(f"{len(calls)} calls observed but {launched} msm_bucket_reduce launches counted "
              "by the program")
        return None
    device_s = t.kernel_seconds(KERNELS)
    if not device_s:
        return None
    bound = sum(msm_s(P, n, nonzero_digits(scalars), run.rate) for P, n, scalars, _ in calls)
    return 100.0 * bound / device_s
