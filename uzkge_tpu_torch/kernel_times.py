"""Times ntt_pass and fb_pair_combine at the shapes of the 52-card proof on
one CUDA card, with fb_fold and fq_batch_inv at a P = 8 query's shapes
beside them, the table build's curve kernels, the table build and
msm_chain, msm_bucket_reduce, scan_leaf_reduce, the chain's projective
rounds and msm_bucket_accumulate at the proof's batches, and prints one JSON
line.

    python3 uzkge_tpu_torch/kernel_times.py [--root DIR] [--reps N] [--only GROUPS]

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
    at N = 2^21, its top level;
  * fb_bases at the table build's (n 16384, W 32, c 8) and at msm_chain's
    chain build (n 16384, W 256, c 1), fb_mult_chunk at the table build's
    (K 524,288, CH 16), and the whole chain build (build_bases at W 256,
    c = 1: fb_bases, fq_batch_inv, fp_mont_mul);
  * KZG.lagrange_fb_table() at n = 16384 (c = 8, 4.29 GB), synchronised:
    wall seconds (mean of 3 builds) and, in one more build under
    torch.profiler, the device's busy seconds (the union of its events'
    intervals) and each kernel's device seconds; msm_chain at P = 8 (n =
    16384, seeded random scalars, the 52-card Lagrange bases), events and
    the device's busy time in one profiled call;
  * msm_bucket_reduce at the variable-base proof's four batches (P = 8, 1,
    5, 2 at n = 16384, the chunks the package's accumulate hands it: one
    here, a parent's pick_chunks 64, 512, 128, 256), summed per proof, on
    random canonical buckets; scan_leaf_reduce at P = 8, 5, 2, 1 (n =
    16384, K = 2^21 leaves, S = 32) on a random chain and the signed base-4
    digits of seeded random scalars (a quarter of them zero, as in
    msm_chain), summed over P = 8, 1, 5, 2 as the group proof calls it;
  * proj: msm_chain's projective rounds, as the package's reduce_leaves
    runs them (here fold_tiles: 512, 128; a parent's pick_s: 32, 32, 32,
    2), on random points of the leaf round's output size (P * 65,536), at
    P = 8, 1, 5, 2, summed per group proof;
  * acc: msm_bucket_accumulate (here at pick_piece's L, a parent's at
    pick_chunks' K) and msm_bucket_reduce on its buckets, at P = 8, 1, 5, 2
    (n = 16384, random bases), on dense random scalars (per proof sums) and
    on skewed rows (all ones, all zero, below 2^16, one scalar repeated,
    mostly zero, in turn), with the peak device memory of the two beyond
    their inputs (the Pippenger's scratch);
  * accsweep (this package only, not in the default): msm_bucket_accumulate
    at P = 8, 1, 5, 2 on dense scalars and at P = 8 on skewed rows, at piece
    lengths L of 4 .. 62, and the device time of its sort, piece and merge
    kernels apart at pick_piece's L (how ACC_PIECE_MAX was chosen).
--only takes a comma list of the groups ntt, combine, query, table, reduce,
leaf, proj, acc, accsweep (default: all but accsweep).
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


def device_busy(fn):
    """fn() once under torch.profiler (device events): (busy seconds, the
    union of the events' intervals; {kernel name: summed device seconds})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            spans.append((ev.time_range.start, ev.time_range.end))
            by_name[ev.name] = by_name.get(ev.name, 0.0) + (ev.time_range.end - ev.time_range.start) / 1e6
    busy, end = 0, None
    for lo, hi in sorted(spans):
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    return busy / 1e6, by_name


def table_and_chain(out, dev, reps):
    """The table build's curve kernels, the table build and msm_chain (the
    module docstring's last two items) into `out`."""
    import time

    import torch

    from uzkge_tpu_torch.ff.field import fq
    from uzkge_tpu_torch.gen_params import load_srs
    from uzkge_tpu_torch.msm import fixed_base as fb

    n = 16384
    for W, c in ((32, 8), (256, 1)):
        x, y = rand(dev, n), rand(dev, n)
        key = f"n={n} W={W} c={c}"
        out["fb_bases"][key] = cuda_ms(lambda: fb.fb_bases(x, y, W, c), reps)
        out["fb_bases_device"][key] = device_ms(lambda: fb.fb_bases(x, y, W, c),
                                                "fb_bases_kernel", reps)
    out["chain_build"] = cuda_ms(lambda: fb.build_bases(x, y, 256, 1), reps)
    K, CH = 32 * n, 16
    T = tuple(rand(dev, K) for _ in range(5))
    key = f"K={K} CH={CH}"
    out["fb_mult_chunk"][key] = cuda_ms(lambda: fb.fb_mult_chunk(*T, CH), reps)
    out["fb_mult_chunk_device"][key] = device_ms(lambda: fb.fb_mult_chunk(*T, CH),
                                                 "fb_mult_chunk_kernel", reps)
    del T
    kzg = load_srs(n, dev)

    def build():
        kzg._lagrange_fb = None
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        kzg.lagrange_fb_table()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    build()  # warm-up
    walls = [build() for _ in range(3)]
    out["table_build_s"] = sum(walls) / len(walls)
    out["table_build_walls_s"] = walls
    busy, by_name = device_busy(build)
    out["table_build_device_busy_s"] = busy
    out["table_build_device_s"] = {
        k.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]: v
        for k, v in by_name.items() if any(t in k for t in ("fb_", "fq_inv_", "fp_mont_mul"))}
    kzg._lagrange_fb = None
    torch.cuda.empty_cache()
    pts = kzg._lagrange_points
    x = fq.to_mont_limbs([p[0] for p in pts], dev).reshape(n, 8)
    y = fq.to_mont_limbs([p[1] for p in pts], dev).reshape(n, 8)
    g = torch.Generator(device=dev).manual_seed(8)
    sc = torch.randint(-(1 << 31), 1 << 31, (8, n, 8), dtype=torch.int32, device=dev, generator=g)
    sc[..., 7] &= 0x0FFFFFFF
    out["msm_chain_P8_ms"] = cuda_ms(lambda: fb.msm_chain(x, y, sc), reps)
    out["msm_chain_P8_device_busy_ms"] = device_busy(lambda: fb.msm_chain(x, y, sc))[0] * 1e3


def reduce_and_leaf(out, dev, reps, groups):
    """msm_bucket_reduce and scan_leaf_reduce (the module docstring's last
    item) into `out`, the groups among ("reduce", "leaf") in `groups`."""
    import torch

    from uzkge_tpu_torch.msm import fixed_base as fb
    from uzkge_tpu_torch.msm import msm as M

    n = 16384
    if "reduce" in groups:
        out["msm_bucket_reduce"], out["msm_bucket_reduce_device"] = {}, {}
        total = dtotal = 0.0
        for P in QUERY_BATCHES:
            K = M.pick_chunks(n, P, dev) if hasattr(M, "pick_chunks") else 1
            buckets = rand(dev, P, K, M.N_WINDOWS, M.N_BUCKETS, 3)
            key = f"P={P} K={K}"
            t = cuda_ms(lambda: M.msm_bucket_reduce(buckets), reps)
            d = device_ms(lambda: M.msm_bucket_reduce(buckets), "msm_bucket_reduce_kernel", reps)
            out["msm_bucket_reduce"][key], out["msm_bucket_reduce_device"][key] = t, d
            total += t
            dtotal += d
            del buckets
        out["msm_bucket_reduce_per_proof"] = total
        out["msm_bucket_reduce_device_per_proof"] = dtotal
    if "leaf" in groups:
        out["scan_leaf_reduce"], out["scan_leaf_reduce_device"] = {}, {}
        W = 128  # msm_chain: c = 2, bits = 256
        K = W * n
        S = fb.pick_s(K)
        ax, ay = rand(dev, 2 * K), rand(dev, 2 * K)
        g = torch.Generator(device=dev).manual_seed(7)
        total = dtotal = 0.0
        for P in (8, 5, 2, 1):
            sc = torch.randint(-(1 << 31), 1 << 31, (P, n, 8), dtype=torch.int32, device=dev,
                               generator=g)
            sc[..., 7] &= 0x0FFFFFFF
            d = fb.scalars_to_digits(sc, 2, 256).transpose(1, 2).reshape(P, K).contiguous()
            key = f"P={P} K={K} S={S}"
            t = cuda_ms(lambda: fb.scan_leaf_reduce(ax, ay, d, n, S), reps)
            dd = device_ms(lambda: fb.scan_leaf_reduce(ax, ay, d, n, S), "scan_leaf_reduce_kernel",
                           reps)
            out["scan_leaf_reduce"][key], out["scan_leaf_reduce_device"][key] = t, dd
            out.setdefault("scan_leaf_zero_share", {})[key] = float((d == 0).float().mean())
            total += t
            dtotal += dd
        out["scan_leaf_reduce_per_proof"] = total
        out["scan_leaf_reduce_device_per_proof"] = dtotal


def skewed_std(dev, P: int, n: int, g):
    """(P, n, 8) standard-form scalars, rows of five skewed kinds in turn:
    all ones, all zero, below 2^16, one scalar repeated, mostly zero (a tenth
    below 16)."""
    import torch

    std = torch.zeros((P, n, 8), dtype=torch.int32, device=dev)
    for p in range(P):
        kind = p % 5
        if kind == 0:
            std[p, :, 0] = 1
        elif kind == 2:
            std[p, :, 0] = torch.randint(0, 1 << 16, (n,), device=dev, generator=g)
        elif kind == 3:
            std[p] = rand(dev, 1)[0]
        elif kind == 4:
            small = torch.randint(0, 16, (n,), device=dev, generator=g)
            keep = torch.rand(n, device=dev, generator=g) < 0.1
            std[p, :, 0] = torch.where(keep, small, 0).to(torch.int32)
    return std


def proj_and_acc(out, dev, reps, groups):
    """The proj and acc groups (the module docstring's last two items) into
    `out`, those among ("proj", "acc") in `groups`."""
    import torch

    from uzkge_tpu_torch.msm import fixed_base as fb
    from uzkge_tpu_torch.msm import msm as M

    n = 16384
    if "proj" in groups:
        K = 128 * n  # msm_chain's leaves per MSM (c = 2, bits = 256)
        per = K // fb.pick_s(K)
        if "fold_tiles" in fb.reduce_leaves.__code__.co_names:
            widths = fb.fold_tiles(per)
        else:  # a parent's rounds of pick_s
            widths, left = [], per
            while left > 1:
                widths.append(fb.pick_s(left))
                left //= widths[-1]
        out["proj_widths"] = widths
        out["scan_proj_rounds"], out["scan_proj_rounds_device"] = {}, {}
        total = dtotal = 0.0
        for P in QUERY_BATCHES:
            pts = tuple(rand(dev, P * per) for _ in range(3))

            def rounds(pts=pts):
                X, Y, Z = pts
                for S in widths:
                    X, Y, Z = fb.scan_proj_reduce(X, Y, Z, S)
                return X

            t = cuda_ms(rounds, reps)
            d = device_ms(rounds, "scan_proj_reduce_kernel", reps)
            out["scan_proj_rounds"][f"P={P}"], out["scan_proj_rounds_device"][f"P={P}"] = t, d
            total += t
            dtotal += d
            del pts
        out["scan_proj_rounds_per_proof"] = total
        out["scan_proj_rounds_device_per_proof"] = dtotal
    if "acc" in groups:
        bx, by = rand(dev, n), rand(dev, n)
        g = torch.Generator(device=dev).manual_seed(12)
        for kind in ("dense", "skewed"):
            acc, accd, red, redd, scratch = {}, {}, {}, {}, {}
            for P in QUERY_BATCHES:
                if kind == "dense":
                    std = torch.randint(-(1 << 31), 1 << 31, (P, n, 8), dtype=torch.int32,
                                        device=dev, generator=g)
                    std[..., 7] &= 0x0FFFFFFF
                else:
                    std = skewed_std(dev, P, n, g)
                if hasattr(M, "pick_piece"):
                    arg, key = M.pick_piece(n, P, dev), f"P={P} L={M.pick_piece(n, P, dev)}"
                else:
                    arg, key = M.pick_chunks(n, P, dev), f"P={P} K={M.pick_chunks(n, P, dev)}"

                def accumulate(std=std, arg=arg):
                    return M.msm_bucket_accumulate(bx, by, std, arg)

                acc[key] = cuda_ms(accumulate, reps)
                accd[key] = device_ms(accumulate, "msm_bucket_accumulate", reps)
                buckets = accumulate()
                red[key] = cuda_ms(lambda: M.msm_bucket_reduce(buckets), reps)
                redd[key] = device_ms(lambda: M.msm_bucket_reduce(buckets),
                                      "msm_bucket_reduce_kernel", reps)
                del buckets
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                M.msm_bucket_reduce(accumulate())
                torch.cuda.synchronize()
                scratch[key] = torch.cuda.max_memory_allocated() - held
            out[f"acc_{kind}"], out[f"acc_{kind}_device"] = acc, accd
            out[f"acc_{kind}_reduce"], out[f"acc_{kind}_reduce_device"] = red, redd
            out[f"acc_{kind}_scratch_bytes"] = scratch
            for name, vals in (("acc", acc), ("acc_device", accd), ("reduce", red),
                               ("reduce_device", redd)):
                out[f"acc_{kind}_{name}_per_proof"] = sum(vals.values())


def acc_sweep(out, dev, reps):
    """The accsweep group (the module docstring's last item) into `out`."""
    import torch

    from uzkge_tpu_torch.msm import msm as M

    n = 16384
    bx, by = rand(dev, n), rand(dev, n)
    g = torch.Generator(device=dev).manual_seed(13)
    rows = {}
    for P in QUERY_BATCHES:
        std = torch.randint(-(1 << 31), 1 << 31, (P, n, 8), dtype=torch.int32, device=dev,
                            generator=g)
        std[..., 7] &= 0x0FFFFFFF
        rows[f"dense P={P}"] = std
    rows["skewed P=8"] = skewed_std(dev, 8, n, g)
    sweep, split = {}, {}
    for label, std in rows.items():
        P = std.shape[0]
        L0 = M.pick_piece(n, P, dev)
        for L in sorted({4, 8, 12, 16, 24, 32, 62, L0}):
            sweep[f"{label} L={L}"] = device_ms(lambda: M.msm_bucket_accumulate(bx, by, std, L),
                                                "msm_bucket_accumulate", reps)
        for part in ("sort", "piece", "merge"):
            split[f"{label} L={L0} {part}"] = device_ms(
                lambda: M.msm_bucket_accumulate(bx, by, std, L0),
                f"msm_bucket_accumulate_{part}_kernel", reps)
    out["acc_sweep_device"], out["acc_split_device"] = sweep, split


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="ntt,combine,query,table,reduce,leaf,proj,acc")
    args = ap.parse_args()
    groups = set(args.only.split(","))
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
           "ntt_pass_device": {}, "fb_pair_combine_device": {}, "fb_bases": {},
           "fb_bases_device": {}, "fb_mult_chunk": {}, "fb_mult_chunk_device": {}}
    master = NTTDomain(2048, dev).master
    total = dtotal = 0.0
    for (OUT, S, IN, pre, post, const), count in NTT_SHAPES.items() if "ntt" in groups else ():
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
    if "ntt" in groups:
        out["ntt_pass_per_proof"], out["ntt_pass_device_per_proof"] = total, dtotal
    total = dtotal = 0.0
    for P in QUERY_BATCHES if "combine" in groups else ():
        for H in LEVELS:
            x, y, dinv = rand(dev, P, 2 * H), rand(dev, P, 2 * H), rand(dev, P, H)
            flags = torch.randint(0, 8, (P, H), dtype=torch.int32, device=dev)
            t = ms(lambda: fb.fb_pair_combine(x, y, dinv, flags))
            d = device_ms(lambda: fb.fb_pair_combine(x, y, dinv, flags), "fb_pair_combine_kernel",
                          args.reps)
            out["fb_pair_combine"][f"P={P} H={H}"], out["fb_pair_combine_device"][f"P={P} H={H}"] = t, d
            total += t
            dtotal += d
    if "combine" in groups:
        out["fb_pair_combine_per_proof"], out["fb_pair_combine_device_per_proof"] = total, dtotal
    if "query" in groups:
        pts = tuple(rand(dev, 8, 65536) for _ in range(3))
        out["fb_fold_tail_P8"] = ms(lambda: fb.fold_tail(*pts))
        a = rand(dev, 1 << 21)
        out["fq_batch_inv_2^21"] = ms(lambda: fb.fq_batch_inv(a))
        del pts, a
    if "table" in groups:
        table_and_chain(out, dev, args.reps)
    reduce_and_leaf(out, dev, args.reps, groups)
    proj_and_acc(out, dev, args.reps, groups)
    if "accsweep" in groups:
        acc_sweep(out, dev, args.reps)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
