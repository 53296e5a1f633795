"""Smoke run of the PyTorch/CUDA port (uzkge_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

The seed is the one the golden digest was made with
(tests/data/torch_golden.json, key "52").

Phases, any failure exits nonzero:
  1. device check: a CUDA card is required (never falls back to the CPU);
     prints `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`;
  2. build of the kernels in uzkge_tpu_torch/csrc/ with nvcc for sm_90a, timed;
  3. each kernel against its plain torch version on the same inputs, exactly
     (field arithmetic has no rounding: tolerance 0):
       ntt_pass through NTTDomain: fft / ifft at n = 16384 (batch 8) and
       coset fft / ifft at m = 131072, against the plain passes on the CPU;
       the MSM kernels against the plain Pippenger at n = 2048, P = 3, and at
       n = 16384, P = 8 against host curve arithmetic on scalars nonzero at
       64 seeded positions; and at that shape on dense scalars, where each
       kernel's time is taken beside its plain version's and the outputs of
       the timed calls are compared;
  4. the main path: gen_shuffle_prover_params(52), the public-key refresh for
     a seeded joint key, prove_shuffle with random.Random(seed) on a seeded
     52-card deck; the proof must verify, a tampered deck must not, its sha256
     must equal the JAX package's (tests/data/torch_golden.json), and every
     kernel must have been launched by that run; then one more proof under
     torch.profiler gives the device's busy time (device events only) and
     its idle share of the profiled proof;
  5. a kernels JSON line, the card line, and last the contract line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import hashlib
import json
import os
import random
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden.json")


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5):
    """Mean milliseconds of fn() on the card over `reps` calls after one
    warm-up call (reps = 0: one cold call, timed), and the last result."""
    out = fn() if reps else None
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(max(reps, 1)):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / max(reps, 1), out


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |difference| of the 32-bit limbs of two Montgomery tensors."""
    a = a.cpu().to(torch.int64) & 0xFFFFFFFF
    b = b.cpu().to(torch.int64) & 0xFFFFFFFF
    return int((a - b).abs().max())


def point_err(got, want) -> int:
    """Largest coordinate difference of two lists of affine points."""
    err = 0
    for g, w in zip(got, want):
        if (g is None) != (w is None):
            return -1
        if g is not None:
            err = max(err, abs(g[0] - w[0]), abs(g[1] - w[1]))
    return err


def check_ntt(dev, rng):
    from uzkge_tpu.constants.bn254 import R_MOD
    from uzkge_tpu_torch.ff.field import fr
    from uzkge_tpu_torch.ntt import cuda_ntt
    from uzkge_tpu_torch.ntt.ntt import NTTDomain

    err = 0
    for n, B in ((16384, 8), (131072, 1)):
        vals = [rng.randrange(R_MOD) for _ in range(B * n)]
        x = fr.to_mont_limbs(vals).reshape(B, n, 8)
        gd, cd = NTTDomain(n, dev), NTTDomain(n, "cpu")
        xg = x.to(dev)
        k = 7
        if n == 16384:
            pairs = [(gd.fft_batch(xg), cd.fft_batch(x)), (gd.ifft_batch(xg), cd.ifft_batch(x))]
        else:
            pairs = [(gd.coset_fft_batch(xg, k), cd.coset_fft_batch(x, k)),
                     (gd.coset_ifft(xg[0], k), cd.coset_ifft(x[0], k))]
        torch.cuda.synchronize()
        for g, c in pairs:
            e = max_abs_err(g, c)
            err = max(err, e)
            if e != 0:
                raise AssertionError(f"ntt_pass disagrees with the plain passes at n = {n}")
        log(f"ntt n={n} batch={B}: kernel == plain")

    # timing at the main path's largest pass: the right branch of the
    # 5-row coset fft at m = 131072 (S = 1024, IN = 128)
    OUT, S, IN = 5, 1024, 128
    xs = torch.randint(0, 1 << 30, (OUT, S, IN, 8), dtype=torch.int32, device=dev)
    xs = fr.mul(xs, fr.const(1, dev))  # canonical values
    tw = NTTDomain(131072, dev)._plan_fwd["plan1"]["tws"][0]
    ms, got = cuda_ms(lambda: cuda_ntt.ntt_pass(xs, tw))
    plain_ms, want = cuda_ms(lambda: cuda_ntt.ntt_pass_plain(xs, tw), reps=0)
    e = max_abs_err(got, want)
    if e != 0:
        raise AssertionError("ntt_pass disagrees with ntt_pass_plain on the card")
    log(f"ntt_pass (OUT={OUT}, S={S}, IN={IN}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": max(err, e), "ms": ms, "plain_ms": plain_ms,
            "shape": f"OUT={OUT} S={S} IN={IN}"}


def check_msm(dev, rng):
    from uzkge_tpu.constants.bn254 import R_MOD
    from uzkge_tpu.curve.bn254 import G1_GEN, g1_add, g1_mul
    from uzkge_tpu_torch.ff.field import fr
    from uzkge_tpu_torch.gen_params import load_srs
    from uzkge_tpu_torch.msm import msm as M

    # n = 2048, P = 3: each kernel against the plain versions, same inputs
    n, P = 2048, 3
    base = [g1_mul(G1_GEN, rng.randrange(1, R_MOD)) for _ in range(64)]
    points = [base[i % 64] for i in range(n)]
    rows = [[rng.randrange(R_MOD) for _ in range(n)] for _ in range(P)]
    rows[0][:5] = [0] * 5
    bases = M.MSMBases(points, dev)
    std = fr.from_mont(torch.stack([fr.to_mont_limbs(r) for r in rows]).to(dev))
    K = M.pick_chunks(n, P, dev)
    kb = M.msm_bucket_accumulate(bases.x, bases.y, std, K)
    pb = M.msm_bucket_accumulate_plain(bases.x, bases.y, std, K)
    ks = M.msm_bucket_reduce(kb)
    host = [M.host_msm(points, r) for r in rows]
    res = {
        "kernel buckets, kernel reduce": M._window_sums_to_points(ks.cpu()),
        "kernel buckets, plain reduce": M._window_sums_to_points(M.msm_bucket_reduce_plain(kb).cpu()),
        "plain buckets, kernel reduce": M._window_sums_to_points(M.msm_bucket_reduce(pb).cpu()),
        "plain buckets, plain reduce": M._window_sums_to_points(M.msm_bucket_reduce_plain(pb).cpu()),
    }
    err_acc = err_red = 0
    for name, got in res.items():
        e = point_err(got, host)
        if e != 0:
            raise AssertionError(f"msm n={n} P={P}: {name} disagrees with the host Pippenger")
        if "plain reduce" in name:
            err_acc = max(err_acc, e)
        else:
            err_red = max(err_red, e)
    log(f"msm n={n} P={P} K={K}: kernels == plain == host")

    # n = 16384, P = 8 on the Lagrange SRS bases, 64 nonzero scalars per row
    n, P = 16384, 8
    pts = load_srs(n)._lagrange_points
    bases = M.MSMBases(pts, dev)
    rows = []
    for _ in range(P):
        row = [0] * n
        for i in rng.sample(range(n), 64):
            row[i] = rng.randrange(1, R_MOD)
        rows.append(row)
    sc = torch.stack([fr.to_mont_limbs(r) for r in rows]).to(dev)
    got = M.msm(bases, sc)
    want = []
    for row in rows:
        acc = None
        for i, s in enumerate(row):
            if s:
                acc = g1_add(acc, g1_mul(pts[i], s))
        want.append(acc)
    e = point_err(got, want)
    if e != 0:
        raise AssertionError("msm n=16384 P=8 disagrees with host curve arithmetic")
    log(f"msm n={n} P={P}: kernels == host bn254")

    # the main path's commit shape (n = 16384, P = 8, r1_commit), dense
    # scalars: each kernel timed beside its plain version, and the outputs
    # of those timed calls held against each other as affine points
    sc = torch.stack([fr.to_mont_limbs([rng.randrange(R_MOD) for _ in range(n)])
                      for _ in range(P)]).to(dev)
    std = fr.from_mont(sc)
    K = M.pick_chunks(n, P, dev)
    acc_ms, kb = cuda_ms(lambda: M.msm_bucket_accumulate(bases.x, bases.y, std, K))
    acc_plain_ms, pb = cuda_ms(lambda: M.msm_bucket_accumulate_plain(bases.x, bases.y, std, K),
                               reps=0)
    red_ms, ks = cuda_ms(lambda: M.msm_bucket_reduce(kb))
    red_plain_ms, kp = cuda_ms(lambda: M.msm_bucket_reduce_plain(kb), reps=0)
    want = M._window_sums_to_points(M.msm_bucket_reduce_plain(pb).cpu())
    e_acc = point_err(M._window_sums_to_points(kp.cpu()), want)  # kernel vs plain buckets
    e_red = point_err(M._window_sums_to_points(ks.cpu()), want)  # both kernels vs plain
    if e_acc != 0 or e_red != 0 or None in want:
        raise AssertionError(f"msm n={n} P={P} dense: kernels disagree with the plain versions")
    log(f"msm n={n} P={P} K={K} dense: kernels == plain")
    log(f"msm_bucket_accumulate (n={n}, P={P}, K={K}): kernel {acc_ms:.4f} ms, "
        f"plain {acc_plain_ms:.4f} ms")
    log(f"msm_bucket_reduce (P={P}, K={K}): kernel {red_ms:.4f} ms, plain {red_plain_ms:.4f} ms")
    shape = f"n={n} P={P} K={K}"
    return ({"max_abs_err": max(err_acc, e, e_acc), "ms": acc_ms, "plain_ms": acc_plain_ms,
             "shape": shape},
            {"max_abs_err": max(err_red, e, e_red), "ms": red_ms, "plain_ms": red_plain_ms,
             "shape": shape})


def profile_prove(seed, pp, kzg, joint, deck, latency):
    """One more proof under torch.profiler.  Device busy time is the union of
    the intervals of the device-side events alone (kernels, memcpys,
    memsets), so an operator and the kernel it launched count once.  The
    idle share is taken against the profiled proof's wall time (profiler
    on); busy time over the unprofiled latency is printed beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from uzkge_tpu_torch.shuffle import app

    rng = random.Random(seed + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        app.prove_shuffle(rng, joint, deck, pp, kzg)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False):
            continue
        lo, hi = ev.time_range.start, ev.time_range.end
        spans.append((lo, hi))
        us, count = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (us + hi - lo, count + 1)
    if not spans:
        log("profiled prove52: the profiler recorded no device events (busy time not measured)")
        return
    busy_us, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    busy_s = busy_us / 1e6
    log(f"profiled prove52: wall {wall:.3f} s (profiler on), {len(spans)} device events, "
        f"device busy {busy_s:.4f} s, idle share of the profiled wall {1 - busy_s / wall:.4f}; "
        f"busy / unprofiled latency {busy_s / latency:.4f}")
    rows = sorted(((us, c, name) for name, (us, c) in by_name.items()), reverse=True)
    for us, count, name in rows[:15]:
        log(f"  device {us / 1e3:10.3f} ms  x{count:<6d} {name[:90]}")


def main_path(dev, golden):
    """The seeded 52-card proof; `golden` is its record in torch_golden.json
    (the seed the JAX package used and its proof's sha256)."""
    from uzkge_tpu.plonk.proof_io import proof_from_bytes_be, proof_to_bytes_be
    from uzkge_tpu_torch import kernels
    from uzkge_tpu_torch.plonk.indexer import refresh_prover_params_public_key
    from uzkge_tpu_torch.shuffle import app
    from uzkge_tpu_torch.utils import stagetimer

    n_cards, seed = 52, golden["seed"]
    t0 = time.perf_counter()
    pp, cs, kzg = app.gen_shuffle_prover_params(n_cards, dev)
    rng = random.Random(seed)
    joint, deck = app.seeded_game(rng, n_cards)
    refresh_prover_params_public_key(pp, cs, kzg, joint)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    log(f"prover params (n = {pp.n}, m = {pp.m}) and key refresh: {setup_s:.3f} s")

    stagetimer.reset()
    kernels.reset_launches()
    t0 = time.perf_counter()
    proof, outputs = app.prove_shuffle(rng, joint, deck, pp, kzg)
    torch.cuda.synchronize()
    latency = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    log(f"prove52 latency: {latency:.3f} s")
    log("stage breakdown (s): " + json.dumps(stagetimer.snapshot()))
    log("main-path launches: " + json.dumps(launches))
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}")

    blob = proof_to_bytes_be(proof)
    digest = hashlib.sha256(blob).hexdigest()
    if digest != golden["sha256"]:
        raise AssertionError(f"proof sha256 {digest} != golden {golden['sha256']}")
    log(f"proof sha256 {digest} == golden (JAX package, same seeds)")
    proof2 = proof_from_bytes_be(blob)
    if len(blob) != 1632 or not app.verify_shuffle(pp.verifier_params, kzg, deck, outputs, proof2):
        raise AssertionError("the port's verifier rejects the proof")
    bad = list(outputs)
    bad[0], bad[1] = bad[1], bad[0]
    if app.verify_shuffle(pp.verifier_params, kzg, deck, bad, proof2):
        raise AssertionError("the verifier accepts a tampered public input")
    log("verifier: proof accepted, tampered deck rejected")
    profile_prove(seed, pp, kzg, joint, deck, latency)
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this smoke run needs one", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    from uzkge_tpu_torch import kernels  # fails outside a checkout of the repo

    dev = torch.device("cuda:0")
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    kernels.build(verbose=True)
    kernels.library()
    log(f"kernel build + load: {time.perf_counter() - t0:.3f} s")

    with open(GOLDEN) as f:
        golden = json.load(f)["52"]
    rng = random.Random(golden["seed"])
    ntt = check_ntt(dev, rng)
    acc, red = check_msm(dev, rng)

    launches = main_path(dev, golden)

    rows = [
        ("ntt_pass", "uzkge_tpu_torch/csrc/ntt.cu", "uzkge_tpu/ntt/pallas_ntt.py:87", ntt),
        ("msm_bucket_accumulate", "uzkge_tpu_torch/csrc/msm.cu", "uzkge_tpu/msm/msm.py:184", acc),
        ("msm_bucket_reduce", "uzkge_tpu_torch/csrc/msm.cu", "uzkge_tpu/msm/msm.py:197", red),
    ]
    out = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **res}
        for name, src, rep, res in rows
    ]}
    log(json.dumps(out))
    log(card_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
