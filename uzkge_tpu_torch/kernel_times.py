"""Times ntt_pass and fb_pair_combine at the shapes of the 52-card proof on
one CUDA card, with fb_fold and fq_batch_inv at a P = 8 query's shapes
beside them, and prints one JSON line.

    python3 uzkge_tpu_torch/kernel_times.py [--root DIR] [--reps N]

--root imports the `uzkge_tpu_torch` package under DIR instead of this one,
so that two checkouts (say a parent commit unpacked into a git-ignored
directory, and this one) can be timed in turns within one run on the same
card; each builds its own kernels.  The shapes:
  * ntt_pass: every (OUT, S, IN, pre, post, const) of the proof's 22
    launches, with their counts (as chip_smoke.py records them during the
    fixed-base proof), summed per proof;
  * fb_pair_combine: the three levels (H = 2^18, 2^17, 2^16) of the queries
    at P = 8, 1, 5, 2 (r1, r2, r3's t split, r5), 12 launches per proof;
  * fb_fold over a P = 8 query's tail (Kc = 65,536 to 1) and fq_batch_inv
    at N = 2^21, its top level.
Times are CUDA-event means over --reps launches after a warm-up (for a small
launch they include the host's time between launches), and beside them the
kernels' device time from torch.profiler (keys *_device); inputs are
canonical random values made on the card (the kernels' times do not depend
on the values, but the NTT's twiddles are a genuine table).
"""

import argparse
import json
import os
import subprocess
import sys

# (OUT, S, IN, pre, post, const): launches per 52-card proof
NTT_SHAPES = {
    (1, 16, 1024, 0, 1, 0): 2, (1, 128, 1024, 0, 1, 0): 1, (1, 128, 1024, 1, 1, 0): 2,
    (1, 1024, 16, 0, 0, 1): 2, (1, 1024, 128, 0, 0, 0): 2, (1, 1024, 128, 0, 1, 0): 1,
    (2, 16, 1024, 0, 1, 0): 1, (2, 1024, 16, 0, 0, 0): 1, (3, 16, 1024, 0, 1, 0): 1,
    (3, 128, 1024, 1, 1, 0): 1, (3, 1024, 16, 0, 0, 1): 1, (3, 1024, 128, 0, 0, 0): 1,
    (5, 16, 1024, 0, 1, 0): 2, (5, 128, 1024, 1, 1, 0): 1, (5, 1024, 16, 0, 0, 0): 1,
    (5, 1024, 16, 0, 0, 1): 1, (5, 1024, 128, 0, 0, 0): 1,
}
QUERY_BATCHES = (8, 1, 5, 2)
LEVELS = (1 << 18, 1 << 17, 1 << 16)


def rand(dev, *shape):
    """Random canonical elements (values below 2^252 < r, q) on `dev`."""
    import torch

    t = torch.randint(-(1 << 31), 1 << 31, (*shape, 8), dtype=torch.int32, device=dev)
    t[..., 7] &= 0x0FFFFFFF
    return t


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of fn() over `reps` calls after one warm-up (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, name: str, reps: int) -> float:
    """Mean device time (ms) of the kernels named `name` that `reps` calls of
    fn() launch, from torch.profiler's device events: what the card spends,
    without the host's time between back-to-back launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [ev.time_range.end - ev.time_range.start for ev in prof.events()
          if ev.device_type == DeviceType.CUDA and name in ev.name]
    return sum(us) / 1e3 / reps if us else float("nan")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("kernel_times: needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.root))
    from uzkge_tpu_torch import kernels
    from uzkge_tpu_torch.msm import fixed_base as fb
    from uzkge_tpu_torch.ntt import cuda_ntt
    from uzkge_tpu_torch.ntt.ntt import NTTDomain
    from uzkge_tpu_torch.ntt.stockham import stage_twiddles_strided

    if not kernels.__file__.startswith(os.path.abspath(args.root)):
        sys.exit(f"kernel_times: imported {kernels.__file__}, not from {args.root}")
    kernels.library()
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()

    def ms(fn):
        return cuda_ms(fn, args.reps)

    out = {"root": os.path.abspath(args.root), "card": card, "ntt_pass": {}, "fb_pair_combine": {},
           "ntt_pass_device": {}, "fb_pair_combine_device": {}}
    master = NTTDomain(2048, dev).master
    total = dtotal = 0.0
    for (OUT, S, IN, pre, post, const), count in NTT_SHAPES.items():
        x = rand(dev, OUT, S, IN)
        tw = stage_twiddles_strided(master, 2048, S, 2048 // S, False)[0]
        lads = (rand(dev, S, IN) if pre else None, rand(dev, S, IN) if post else None,
                rand(dev) if const else None)
        key = f"{OUT},{S},{IN},{pre}{post}{const} x{count}"
        t = ms(lambda: cuda_ntt.ntt_pass(x, tw, *lads))
        d = device_ms(lambda: cuda_ntt.ntt_pass(x, tw, *lads), "ntt_pass_kernel", args.reps)
        out["ntt_pass"][key], out["ntt_pass_device"][key] = t, d
        total += count * t
        dtotal += count * d
    out["ntt_pass_per_proof"], out["ntt_pass_device_per_proof"] = total, dtotal
    total = dtotal = 0.0
    for P in QUERY_BATCHES:
        for H in LEVELS:
            x, y, dinv = rand(dev, P, 2 * H), rand(dev, P, 2 * H), rand(dev, P, H)
            flags = torch.randint(0, 8, (P, H), dtype=torch.int32, device=dev)
            t = ms(lambda: fb.fb_pair_combine(x, y, dinv, flags))
            d = device_ms(lambda: fb.fb_pair_combine(x, y, dinv, flags), "fb_pair_combine_kernel",
                          args.reps)
            out["fb_pair_combine"][f"P={P} H={H}"], out["fb_pair_combine_device"][f"P={P} H={H}"] = t, d
            total += t
            dtotal += d
    out["fb_pair_combine_per_proof"], out["fb_pair_combine_device_per_proof"] = total, dtotal
    pts = tuple(rand(dev, 8, 65536) for _ in range(3))
    out["fb_fold_tail_P8"] = ms(lambda: fb.fold_tail(*pts))
    a = rand(dev, 1 << 21)
    out["fq_batch_inv_2^21"] = ms(lambda: fb.fq_batch_inv(a))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
