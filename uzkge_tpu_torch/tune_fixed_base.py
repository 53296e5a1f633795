"""Builds the table build's two curve kernels, fb_bases and fb_mult_chunk
(csrc/fixed_base.cu), in variants on one CUDA card, times each one held
equal to its plain version, and prints one JSON line.

    python3 uzkge_tpu_torch/tune_fixed_base.py [--parent DIR] [--sass DIR] [--reps N] [--rounds R]

A variant of VARIANTS is csrc/ copied into uzkge_tpu_torch/build/
tune_fixed_base/<name>/ with a few text edits: the lockstep width of
fb_bases' doubling (g1_dbl_ls<G>) and of fb_mult_chunk's mixed addition
(g1_madd_ls<G>), squarings or products a * a in the doubling's first stage,
fb_bases' widest block, fb_mult_chunk's block and its minimum of resident
blocks per SM.  The first variant, `this`, is the source as it stands;
`w1` is the same at lockstep width 1 (each formula's products one at a
time).  --parent adds the fixed_base.cu of another checkout (the parent
commit unpacked into a git-ignored directory) as `parent`, built from its
own csrc/.  One nvcc per variant, all started together.  For each variant:
  * ptxas's registers, stack and spill bytes of both kernels (-Xptxas -v);
  * SASS counts of both kernels (cuobjdump -sass): instructions, integer
    multiply-adds (IMAD*), and the share of multiply-adds that read a
    register written by the instruction just before them (a serial carry
    chain issues almost nothing else); --sass DIR writes the SASS there;
  * the times (CUDA events, mean of --reps launches after a warm-up) of
    fb_bases at the table's (n 16384, W 32, c 8) and at msm_chain's (n
    16384, W 256, c 1), and of fb_mult_chunk at the table's (K 524,288,
    CH 16), on random canonical inputs made on the card, every output equal
    limb for limb to the plain torch version's: all variants forward, then
    backward, the two means averaged;
  * the issue rate: warp instructions per clock on each SM that holds a
    block, counting the kernel's SASS instructions once per doubling or
    mixed addition (the kernels' loop bodies), at the card's maximum clock.
Last, `this`, `w1` and `parent` in turns at each shape, --rounds rounds of
(this, w1, parent, parent, w1, this), every sample kept, so that the
lockstep width and the redesign are each read as pairs on one card.
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
OUT = os.path.join(_PKG, "build", "tune_fixed_base")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
KERNELS = ("fb_bases_kernel", "fb_mult_chunk_kernel")

# name: (doubling's width, squarings, fb_bases' widest block; mixed addition's
# width, fb_mult_chunk's block, its minimum blocks per SM or 0)
VARIANTS = {
    "this": (2, True, 128, 2, 256, 0),
    "w1": (1, True, 128, 1, 256, 0),
    "w3": (3, True, 128, 3, 256, 0),
    "w6": (6, True, 128, 6, 256, 0),
    "w2_products_b128": (2, False, 128, 2, 128, 0),
    "w1_products_b128min2": (1, False, 128, 2, 128, 2),
}


def edit(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"tune_fixed_base: {old!r} occurs {src.count(old)} times, not once")
    return src.replace(old, new)


def write_variant(name, spec):
    """csrc/ copied to OUT/name/ with spec's edits; returns the copy."""
    dbl, sqr, bthreads, madd, cthreads, cmin = spec
    d = os.path.join(OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    for fname, pairs in (
            ("fixed_base.cuh", [("g1_dbl_ls<2>(T, T)", f"g1_dbl_ls<{dbl}>(T, T)"),
                                ("g1_madd_ls<2>(T, T, Bx, By)", f"g1_madd_ls<{madd}>(T, T, Bx, By)")]),
            ("field.cuh", [] if sqr else [("fp_sqr_groups<Fq, 6, G>(q, s);",
                                           "fp_mul_groups<Fq, 6, G>(q, s, s);")]),
            ("fixed_base.cu", [("constexpr int BASES_THREADS = 128;",
                                f"constexpr int BASES_THREADS = {bthreads};"),
                               ("constexpr int CHUNK_THREADS = 256;",
                                f"constexpr int CHUNK_THREADS = {cthreads};"),
                               ("__launch_bounds__(CHUNK_THREADS)",
                                f"__launch_bounds__(CHUNK_THREADS, {cmin})" if cmin
                                else "__launch_bounds__(CHUNK_THREADS)")])):
        path = os.path.join(d, fname)
        with open(path) as f:
            src = f.read()
        for old, new in pairs:
            src = edit(src, old, new)
        with open(path, "w") as f:
            f.write(src)
    return d


def build_all(parent):
    """One nvcc per variant (and the parent's), all started together;
    returns {name: (library, ptxas report, csrc dir)}."""
    os.makedirs(OUT, exist_ok=True)
    jobs = [(name, write_variant(name, spec)) for name, spec in VARIANTS.items()]
    if parent:
        jobs.append(("parent", os.path.join(parent, "uzkge_tpu_torch", "csrc")))
    procs = {}
    for name, csrc in jobs:
        so = os.path.join(OUT, f"{name}.so")
        cmd = [NVCC, *ARCH, "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC", "-I", csrc, "-o", so,
               os.path.join(csrc, "fixed_base.cu")]
        procs[name] = (so, csrc, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.PIPE, text=True))
    built = {}
    for name, (so, csrc, p) in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc {name} failed ({p.returncode}):\n{err[-4000:]}")
        built[name] = (so, err, csrc)
    return built


def launch_bounds(csrc: str) -> dict:
    """{kernel: the thread count of its __launch_bounds__} in csrc's
    fixed_base.cu, written out or as a constexpr int."""
    with open(os.path.join(csrc, "fixed_base.cu")) as f:
        src = f.read()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    out = {}
    for arg, kern in re.findall(r"__launch_bounds__\((\w+)[^)]*\)\s*(\w+)", src):
        out[kern] = int(consts.get(arg, arg))
    return out


def ptxas_info(err: str, kernels=KERNELS) -> dict:
    """{kernel: {registers, stack, spill_stores, spill_loads}} for `kernels`
    from ptxas -v's report."""
    info, fn = {}, None
    for line in err.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?: for|$)",
                      line)
        if m:
            fn = next((k for k in kernels if k in m.group(1)), None)
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            info.setdefault(fn, {}).update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            info.setdefault(fn, {})["registers"] = int(m.group(1))
    return info


_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")


def sass_stats(sass: str) -> dict:
    """{kernel: {instructions, imad, imad_after_writer}} for KERNELS:
    imad_after_writer is the share of IMAD* whose nearest earlier writer of
    one of their source registers is the instruction just before
    (straight-line order; a register pair of a .WIDE counts whole)."""
    stats, fn, insns = {}, None, []

    def close():
        if fn is None:
            return
        last, n_imad, near = {}, 0, 0
        for i, (op, args) in enumerate(insns):
            regs = re.findall(r"\bR(\d+)\b", args)
            if op.startswith("IMAD") and len(regs) > 1:
                n_imad += 1
                near += any(last.get(int(r)) == i - 1 for r in regs[1:])
            if regs and not op.startswith(("ST", "BRA", "EXIT", "BAR", "RED", "ATOM")):
                dst = int(regs[0])
                last[dst] = i
                if ".WIDE" in op or op.startswith(("LDG.E.64", "LDG.E.128")):
                    last[dst + 1] = i
        stats[fn] = {"instructions": len(insns), "imad": n_imad,
                     "imad_after_writer": near / n_imad if n_imad else None}

    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            close()
            fn = next((k for k in KERNELS if k in m.group(1)), None)
            insns = []
            continue
        m = _INSN.search(line)
        if m and fn and not m.group(1).startswith("NOP"):
            insns.append((m.group(1), m.group(2)))
    close()
    return stats


def load(so: str):
    lib = ctypes.CDLL(so)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fb_bases_launch.argtypes = [P] * 5 + [I] * 3 + [P]
    lib.fb_mult_chunk_launch.argtypes = [P] * 11 + [L, I, P]
    for fn in (lib.fb_bases_launch, lib.fb_mult_chunk_launch):
        fn.restype = I
    return lib


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="root of another checkout: its fixed_base.cu as a variant")
    ap.add_argument("--sass", help="directory to write each variant's SASS into")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("tune_fixed_base: needs a CUDA card")
    sys.path.insert(0, os.path.dirname(_PKG))
    from uzkge_tpu_torch.kernel_times import cuda_ms, rand
    from uzkge_tpu_torch.msm import fixed_base as fb

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60).stdout.split()[0])
    print(card, flush=True)
    built = build_all(args.parent)
    out = {"card": card, "max_sm_mhz": mhz, "variants": {}}
    cuobjdump = os.path.join(os.path.dirname(NVCC), "cuobjdump")
    for name, (so, err, csrc) in built.items():
        sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True).stdout
        if args.sass:
            os.makedirs(args.sass, exist_ok=True)
            with open(os.path.join(args.sass, f"fixed_base_{name}.sass"), "w") as f:
                f.write(sass)
        out["variants"][name] = {"spec": VARIANTS.get(name), "bounds": launch_bounds(csrc),
                                 "ptxas": ptxas_info(err), "sass": sass_stats(sass)}
        print(name, json.dumps(out["variants"][name]), flush=True)
    libs = {name: load(so) for name, (so, _, _) in built.items()}

    dev = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    n = 16384
    x, y = rand(dev, n), rand(dev, n)
    cases = []  # (label, kernel, run, plain outputs, lanes, loop passes, threads of a variant)
    for W, c in ((32, 8), (256, 1)):
        outs = tuple(torch.empty((W * n, 8), dtype=torch.int32, device=dev) for _ in range(3))

        def run(lib, W=W, c=c, outs=outs):
            rc = lib.fb_bases_launch(x.data_ptr(), y.data_ptr(), *(o.data_ptr() for o in outs),
                                     n, W, c, stream)
            if rc:
                raise RuntimeError(f"fb_bases_launch: CUDA error {rc}")
            return outs

        # the launcher's block: the narrowest whole-warp one with no more blocks than SMs
        cases.append((f"fb_bases n={n} W={W} c={c}", "fb_bases_kernel", run,
                      fb.fb_bases_plain(x, y, W, c), n, (W - 1) * c,
                      lambda b: min(b, (-(-n // sms) + 31) // 32 * 32)))
    K, CH = 524288, 16
    T = tuple(rand(dev, K) for _ in range(5))
    outs = tuple(torch.empty((CH, K, 8), dtype=torch.int32, device=dev) for _ in range(3)) + \
        tuple(torch.empty((K, 8), dtype=torch.int32, device=dev) for _ in range(3))

    def run_chunk(lib):
        rc = lib.fb_mult_chunk_launch(*(t.data_ptr() for t in T), *(o.data_ptr() for o in outs),
                                      K, CH, stream)
        if rc:
            raise RuntimeError(f"fb_mult_chunk_launch: CUDA error {rc}")
        return outs

    cases.append((f"fb_mult_chunk K={K} CH={CH}", "fb_mult_chunk_kernel", run_chunk,
                  fb.fb_mult_chunk_plain(*T, CH), K, CH, lambda b: b))
    names = list(libs)
    pair = [v for v in ("this", "w1", "parent") if v in libs]
    out["ms"], out["issue_rate"], out["turns"] = {}, {}, {}
    for label, kern, run, want, lanes, passes, threads in cases:
        times = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                times[name].append(cuda_ms(lambda: run(libs[name]), args.reps))
                got = run(libs[name])
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"{label}: variant {name} disagrees with the plain version")
        out["ms"][label] = {name: sum(t) / len(t) for name, t in times.items()}
        out["issue_rate"][label] = {}
        for name, ms in out["ms"][label].items():
            v = out["variants"][name]
            blk = threads(v["bounds"][kern])
            busy = min(sms, -(-lanes // blk))
            out["issue_rate"][label][name] = (lanes / 32 * passes * v["sass"][kern]["instructions"]
                                              / (busy * ms * 1e-3 * mhz * 1e6))
        turns = {name: [] for name in pair}
        for _ in range(args.rounds):
            for name in pair + pair[::-1]:
                turns[name].append(cuda_ms(lambda: run(libs[name]), args.reps))
        out["turns"][label] = turns
        print(label, json.dumps({"ms": out["ms"][label], "turns": turns}), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
