"""Builds msm_bucket_reduce (csrc/msm.cu) and scan_leaf_reduce
(csrc/scan_reduce.cu) in variants on one CUDA card, times each one held
equal to its plain version, and prints one JSON line.

    python3 uzkge_tpu_torch/tune_reduce.py [--reps N] [--rounds R]

A variant is csrc/ copied into uzkge_tpu_torch/build/tune_reduce/<name>/
with text edits (each target must occur once).  `this` is the source as it
stands.  REDUCE_VARIANTS change msm_bucket_reduce: its additions' products
in lockstep pairs (`padd_ls2`: a lockstep g1_padd added to the copy's
field.cuh).  LEAF_VARIANTS change
scan_leaf_reduce: its block (LEAF_THREADS), its mixed addition in lockstep
form at width 1 or 2 (g1_madd_ls), the next nonzero leaf's digit and row
loaded before the current addition (`prefetch`), or the walk over all S
leaves that skips zero digits and adds into sum 0 and sum 1 in turn, with
no mask and no selects (`all_leaves`, the earlier lane with 32-bit rows; at
512 and 256 threads).  One nvcc per variant, all started together.
For each variant:
  * ptxas's registers, stack and spill bytes of both kernels (-Xptxas -v);
  * the times (CUDA events, mean of --reps launches after a warm-up) of
    msm_bucket_reduce at n = 16384's four batches P = 8, 1, 5, 2 on the
    accumulate kernels' buckets of random scalars over the 52-card Lagrange
    bases (one chunk, K = 1, since the accumulate sums each bucket itself), each variant's window sums
    equal to the plain version's as affine points (`this` and the reduce
    variants); and of scan_leaf_reduce at P = 8, 5, 2, 1 (n = 16384, K =
    2^21, S = 32) on a random chain and the signed base-4 digits of random
    scalars, every output equal limb for limb to the plain version's (`this`
    and the leaf variants): the variants forward, then backward, the two
    means averaged;
then --rounds rounds of those variants in turns, forward and backward,
every sample kept.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
OUT = os.path.join(_PKG, "build", "tune_reduce")
KERNELS = ("msm_bucket_reduce_kernel", "scan_leaf_reduce_kernel")

# RCB Alg. 7 with its six first-stage products in lockstep groups of G, put
# into field.cuh before g1_madd_ls (it reuses g1_rcb_tail_ls)
_PADD_LS = """template <int G>
ZK_HD void g1_padd_ls(G1Proj &out, const G1Proj &p, const G1Proj &q) {
  uint32_t a[6][8], b[6][8], m[6][8];
  fp_copy(a[0], p.x); fp_copy(b[0], q.x);
  fp_copy(a[1], p.y); fp_copy(b[1], q.y);
  fp_copy(a[2], p.z); fp_copy(b[2], q.z);
  fp_add<Fq>(a[3], p.x, p.y); fp_add<Fq>(b[3], q.x, q.y);
  fp_add<Fq>(a[4], p.y, p.z); fp_add<Fq>(b[4], q.y, q.z);
  fp_add<Fq>(a[5], p.x, p.z); fp_add<Fq>(b[5], q.x, q.z);
  fp_mul_groups<Fq, 6, G>(m, a, b);
  uint32_t t0[8], t1[8], t2[8], t3[8], t4[8], u[8], Y3[8], Z3[8];
  fp_add<Fq>(u, m[0], m[1]);
  fp_sub<Fq>(t3, m[3], u);
  fp_add<Fq>(u, m[1], m[2]);
  fp_sub<Fq>(t4, m[4], u);
  fp_add<Fq>(u, m[0], m[2]);
  fp_sub<Fq>(Y3, m[5], u);
  fp_add<Fq>(u, m[0], m[0]);
  fp_add<Fq>(t0, u, m[0]);
  fp_mul9<Fq>(t2, m[2]);
  fp_add<Fq>(Z3, m[1], t2);
  fp_sub<Fq>(t1, m[1], t2);
  fp_mul9<Fq>(Y3, Y3);
  g1_rcb_tail_ls<G>(out, t0, t1, t3, t4, Y3, Z3);
}

"""
_MADD_LS = "// RCB Alg. 8 (projective + affine (x2, y2)), equal to g1_madd limb for limb"

# the lane's loads of a nonzero leaf, then the same loads done one leaf ahead
_LOADS = """  for (; mask; mask &= mask - 1) {
    const int s = scan_low_bit(mask), d = drow[s];
    const size_t row = scan_leaf_row(k0 + s, d, lg_n);
    uint32_t x[8], y[8];
    ld_fp(x, ax + row * 8);
    ld_fp(y, ay + row * 8);
    if (d < 0) fp_neg<Fq>(y, y);
    const bool odd = s & 1;
"""
_PREFETCH = """  int s = 0, d = 0;
  uint32_t nx[8], ny[8];
  auto fetch = [&]() {
    s = scan_low_bit(mask);
    d = drow[s];
    const size_t row = scan_leaf_row(k0 + s, d, lg_n);
    ld_fp(nx, ax + row * 8);
    ld_fp(ny, ay + row * 8);
  };
  if (mask) fetch();
  while (mask) {
    const bool odd = s & 1, neg = d < 0;
    uint32_t x[8], y[8];
    fp_copy(x, nx);
    fp_copy(y, ny);
    mask &= mask - 1;
    if (mask) fetch();
    if (neg) fp_neg<Fq>(y, y);
"""
# every leaf in turn, zero digits skipped, even ones into sum 0 and odd ones
# into sum 1
_ALL_LEAVES = """ZK_HD void scan_leaf_add(G1Proj &acc, const uint32_t *ax, const uint32_t *ay,
                         const int32_t *drow, int k0, int s, int lg_n) {
  const int d = drow[s];
  if (d == 0) return;
  const size_t row = scan_leaf_row(k0 + s, d, lg_n);
  uint32_t x[8], y[8];
  ld_fp(x, ax + row * 8);
  ld_fp(y, ay + row * 8);
  if (d < 0) fp_neg<Fq>(y, y);
  g1_madd(acc, acc, x, y);
}

ZK_HD void scan_leaf_lane(const uint32_t *ax, const uint32_t *ay, const int32_t *digits,
                          uint32_t *ox, uint32_t *oy, uint32_t *oz, int t, int K, int lg_n,
                          int S) {
  const int J = K / S, k0 = (t % J) * S;
  const int32_t *drow = digits + (size_t)(t / J) * K + k0;
  G1Proj a0, a1;
  g1_set_identity(a0);
  g1_set_identity(a1);
  for (int s = 0; s < S; s += 2) {
    scan_leaf_add(a0, ax, ay, drow, k0, s, lg_n);
    if (S > 1) scan_leaf_add(a1, ax, ay, drow, k0, s + 1, lg_n);
  }
  if (S > 1) g1_padd(a0, a0, a1);
  st_fp(ox + (size_t)t * 8, a0.x);
  st_fp(oy + (size_t)t * 8, a0.y);
  st_fp(oz + (size_t)t * 8, a0.z);
}
"""


def _lane_def(src: str) -> str:
    """scan_leaf_lane's definition in scan_reduce.cuh's text."""
    a = src.index("ZK_HD void scan_leaf_lane(")
    return src[a:src.index("\n}\n", a) + 3]


def _threads(t: int):
    return ("scan_reduce.cu", "LEAF_THREADS = 512;", f"LEAF_THREADS = {t};")


# name: text edits (file, old or a function of the file's text giving it, new)
REDUCE_VARIANTS = {
    "padd_ls2": [("field.cuh", _MADD_LS, _PADD_LS + _MADD_LS),
                 ("msm.cuh", "g1_padd(r, r, q)", "g1_padd_ls<2>(r, r, q)")],
}
LEAF_VARIANTS = {
    "all_leaves": [("scan_reduce.cuh", _lane_def, _ALL_LEAVES)],
    "all_leaves_b256": [("scan_reduce.cuh", _lane_def, _ALL_LEAVES), _threads(256)],
    "b256": [_threads(256)],
    "b384": [_threads(384)],
    "madd_ls1": [("scan_reduce.cuh", "g1_madd(acc, acc, x, y)", "g1_madd_ls<1>(acc, acc, x, y)")],
    "madd_ls2": [("scan_reduce.cuh", "g1_madd(acc, acc, x, y)", "g1_madd_ls<2>(acc, acc, x, y)")],
    "prefetch": [("scan_reduce.cuh", _LOADS, _PREFETCH)],
}
VARIANTS = {"this": [], **REDUCE_VARIANTS, **LEAF_VARIANTS}


def write_variant(name, edits):
    """csrc/ copied to OUT/name/ with its edits; returns the copy."""
    from uzkge_tpu_torch.tune_fixed_base import edit

    d = os.path.join(OUT, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    for fname, old, new in edits:
        path = os.path.join(d, fname)
        with open(path) as f:
            src = f.read()
        with open(path, "w") as f:
            f.write(edit(src, old(src) if callable(old) else old, new))
    return d


def build_all():
    """One nvcc per variant, all started together; returns {name: (library,
    ptxas report)}."""
    from uzkge_tpu_torch.tune_fixed_base import ARCH, NVCC

    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        csrc = write_variant(name, edits)
        so = os.path.join(OUT, f"{name}.so")
        cmd = [NVCC, *ARCH, "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC", "-I", csrc, "-o", so,
               os.path.join(csrc, "msm.cu"), os.path.join(csrc, "scan_reduce.cu")]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True))
    built = {}
    for name, (so, p) in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc {name} failed ({p.returncode}):\n{err[-4000:]}")
        built[name] = (so, err)
    return built


def load(so: str):
    lib = ctypes.CDLL(so)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.msm_bucket_reduce_launch.argtypes = [P] * 4 + [I, I, P]
    lib.msm_bucket_reduce_parts.argtypes = [I]
    lib.scan_leaf_reduce_launch.argtypes = [P] * 6 + [L, L, L, I, P]
    for fn in (lib.msm_bucket_reduce_launch, lib.msm_bucket_reduce_parts,
               lib.scan_leaf_reduce_launch):
        fn.restype = I
    return lib


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("tune_reduce: needs a CUDA card")
    sys.path.insert(0, os.path.dirname(_PKG))
    from uzkge_tpu_torch.ff.field import fr
    from uzkge_tpu_torch.gen_params import load_srs
    from uzkge_tpu_torch.kernel_times import cuda_ms, rand
    from uzkge_tpu_torch.msm import fixed_base as fb
    from uzkge_tpu_torch.msm import msm as M
    from uzkge_tpu_torch.tune_fixed_base import ptxas_info

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    built = build_all()
    out = {"card": card, "variants": {}}
    for name, (so, err) in built.items():
        out["variants"][name] = {"ptxas": ptxas_info(err, KERNELS)}
        print(name, json.dumps(out["variants"][name]), flush=True)
    libs = {name: load(so) for name, (so, _) in built.items()}

    dev = torch.device("cuda:0")
    stream = torch.cuda.current_stream().cuda_stream
    n = 16384
    g = torch.Generator(device=dev).manual_seed(11)

    def scalars(P):
        sc = torch.randint(-(1 << 31), 1 << 31, (P, n, 8), dtype=torch.int32, device=dev,
                           generator=g)
        sc[..., 7] &= 0x0FFFFFFF
        return sc

    cases = []  # (label, variants, run(lib) -> outputs, check(outputs) -> bool)
    bases = M.MSMBases(load_srs(n, dev)._lagrange_points, dev)
    for P in (8, 1, 5, 2):
        buckets = M.msm_bucket_accumulate(bases.x, bases.y, fr.from_mont(scalars(P)),
                                          M.pick_piece(n, P, dev))
        K = buckets.shape[1]
        want = M._window_sums_to_points(
            M.msm_bucket_reduce_plain(buckets).cpu().reshape(-1, 1, 3, 8))
        res = torch.empty((P, M.N_WINDOWS, 3, 8), dtype=torch.int32, device=dev)

        def run(lib, buckets=buckets, res=res, P=P, K=K):
            part = torch.empty((P * M.N_WINDOWS * lib.msm_bucket_reduce_parts(K), 3, 8),
                               dtype=torch.int32, device=dev)
            done = torch.zeros(P * M.N_WINDOWS, dtype=torch.int32, device=dev)
            rc = lib.msm_bucket_reduce_launch(buckets.data_ptr(), res.data_ptr(),
                                              part.data_ptr(), done.data_ptr(), P, K, stream)
            if rc:
                raise RuntimeError(f"msm_bucket_reduce_launch: CUDA error {rc}")
            return res

        def check(got, want=want):
            return M._window_sums_to_points(got.cpu().reshape(-1, 1, 3, 8)) == want

        cases.append((f"msm_bucket_reduce P={P} K={K}", ["this", *REDUCE_VARIANTS], run, check))
    W = 128
    K = W * n
    S = fb.pick_s(K)
    ax, ay = rand(dev, 2 * K), rand(dev, 2 * K)
    for P in (8, 5, 2, 1):
        d = fb.scalars_to_digits(scalars(P), 2, 256).transpose(1, 2).reshape(P, K).contiguous()
        want = fb.scan_leaf_reduce_plain(ax, ay, d, n, S)
        res = tuple(torch.empty((P * (K // S), 8), dtype=torch.int32, device=dev)
                    for _ in range(3))

        def run(lib, d=d, res=res, P=P):
            rc = lib.scan_leaf_reduce_launch(ax.data_ptr(), ay.data_ptr(), d.data_ptr(),
                                             *(o.data_ptr() for o in res), P, K, n, S, stream)
            if rc:
                raise RuntimeError(f"scan_leaf_reduce_launch: CUDA error {rc}")
            return res

        def check(got, want=want):
            return all(torch.equal(a, b) for a, b in zip(got, want))

        cases.append((f"scan_leaf_reduce P={P} K={K} S={S}", ["this", *LEAF_VARIANTS], run,
                      check))

    out["ms"], out["turns"] = {}, {}
    for label, names, run, check in cases:
        times = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                times[name].append(cuda_ms(lambda: run(libs[name]), args.reps))
                got = run(libs[name])
                torch.cuda.synchronize()
                if not check(got):
                    raise AssertionError(f"{label}: variant {name} disagrees with the plain "
                                         "version")
        out["ms"][label] = {name: sum(t) / len(t) for name, t in times.items()}
        turns = {name: [] for name in names}
        for _ in range(args.rounds):
            for name in names + names[::-1]:
                turns[name].append(cuda_ms(lambda: run(libs[name]), args.reps))
        out["turns"][label] = turns
        print(label, json.dumps({"ms": out["ms"][label], "turns": turns}), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
