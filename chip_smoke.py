"""Smoke run of the PyTorch/CUDA port (uzkge_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

The seeds are the ones the golden digests were made with
(tests/data/torch_golden.json, keys "52", "mm50", "reveal" and "g16toy").

Phases, any failure exits nonzero:
  1. device check: a CUDA card is required (never falls back to the CPU);
     prints `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`;
  2. build of the kernels in uzkge_tpu_torch/csrc/ with nvcc for sm_90a, timed;
     the product rate of field.cuh's fp_mul (fp_mul_chain: 4 independent
     chains a thread, 2048 threads per SM, Fr and Fq), checked against its
     plain version on a small input, beside the bounds' assumed rate;
  3. each kernel against its plain torch version on the same inputs, exactly
     (field arithmetic has no rounding: tolerance 0):
       ntt_pass through NTTDomain: fft / ifft at n = 16384 (batch 8) and
       coset fft / ifft at m = 131072, against the plain passes on the CPU;
       the MSM kernels against the plain Pippenger at n = 2048, P = 3 (and
       msm_bucket_reduce on a copy of the buckets with empty buckets and a
       point in bucket 0), and at n = 16384, P = 8 against host curve
       arithmetic on scalars nonzero at 64 seeded positions;
       msm_bucket_accumulate at n = 16384 on dense scalars at every batch of
       the variable-base proof, P = 8, 1, 5, 2, limb for limb against its
       plain version and timed beside it, with the Pippenger's scratch
       bytes, and at P = 8 on skewed rows (all ones, all zero, below 2^16,
       one scalar repeated, mostly zero); msm_bucket_reduce (whose
       projective limbs differ from the plain version's: it adds in another
       order) on those dense buckets (one chunk each), against its plain
       version as affine window sums, timed beside it (phases 7 and 9 report
       these plain times for their buckets of the same shapes), and at
       P = 8 on a copy with identities;
     the fixed-base table build's four kernels (fp_mont_mul for Fr and Fq,
     fb_bases, fb_mult_chunk, fq_batch_inv) at n = 256, c = 8, bits = 254
     (W = 32, K = 8192, D = 128) on the 52-card Lagrange basis, each against
     its plain version, then the whole table built by the kernels against the
     one the plain versions build; on that table the query's kernels for P =
     3 MSMs (fb_select, fb_pair_den and fb_pair_combine with identity and
     x1 == x2 pairs planted, fq_batch_inv at the level's size, fb_fold over
     the level's whole tail and at width 2), each against its plain version,
     and a whole msm_mont against the host Pippenger (the whole plain table
     reuses the plain outputs of those comparisons); on the same 256 points
     the chain MSM's kernels for P = 3 rows (an all-zero row and a run of
     zero digits planted): scan_leaf_reduce and every scan_proj_reduce
     round, each against its plain version (the chain build, fb_bases at
     W = 256, c = 1, fq_batch_inv and fp_mont_mul, is held at full size in
     phase 5), and msm_chain's points against the host Pippenger's and the
     table query's;
  4. the main path: gen_shuffle_prover_params(52), whose set-up now builds
     the fixed-base table (fb_bases and fb_mult_chunk must be launched), the
     public-key refresh for a seeded joint key, prove_shuffle with
     random.Random(seed) on a seeded 52-card deck, every Lagrange commit
     through the table; the proof must verify, a tampered deck must not, its
     sha256 must equal the JAX package's (tests/data/torch_golden.json), and
     every kernel of the proof must have been launched by that run, and the
     shape of each of its ntt_pass calls is recorded; one more
     proof under torch.profiler gives the device's busy time (device events
     only), its idle share of the profiled proof, and the summed device time
     and count of every kernel of csrc/ by name; then the same proof on
     the same prover params through a KZG with fixed_base=False (the
     variable-base Pippenger), from the same rng state: the same sha256,
     both Pippenger kernels launched; both proofs' stage times side by side;
     that proof profiled too (device busy, idle share, every kernel's device
     time, launches and time a launch);
 4b. the proof batch (parallel/batch.py) on phase 4's prover params, table,
     joint key and rng state: prove_shuffle_batch of three proofs on two
     worker threads of the one card (devices=[dev, dev]): phase 4's proof
     twice from its rng state (both sha256 the golden one) and, between
     them, the reshuffle of phase 4's output deck with Random(seed + 1), as
     the next player would, accepted by verify_shuffle and rejected with two
     of its outputs swapped; the proof kernels launched; its wall time
     beside three times phase 4's latency (a record only); then one proof
     through replicate(pp, kzg, dev): its tensors sharing no storage with
     pp's, its own table built (fb_bases and fb_mult_chunk launched; time
     and peak device memory), its sha256 the golden one; the replica freed;
  5. the fixed-base path: the proof's table is dropped, and a fresh
     KZG.lagrange_fb_table() over the 16384 Lagrange bases (c = 8: 67,108,864
     rows, 4.29 GB) is timed, with its peak device memory; sampled rows
     against host scalar multiples; each of its four kernels launched by
     that build; then each kernel at that build's shapes against its plain
     version, timed beside it; then the query at r1_commit's batch (P = 8,
     n = 16384, K = 524,288 leaves per MSM), every kernel at every level
     against its plain version, timed beside it (fb_select also beside
     PyTorch's own gather of the same rows; fb_fold launch by launch and
     over the whole tail), and the whole query's points against the
     variable-base Pippenger's on the same scalars; fq_batch_inv,
     fb_pair_combine (level by level) and fb_fold at the proof's other
     batches (P = 1, 5, 2), against their plain versions (fq_batch_inv, on
     the one-launch path the P = 8 levels hold, by a * a^-1 == 1), timed;
     ntt_pass at
     every shape the proof launched, against its plain version, timed; then
     msm_chain at the same shape (P = 8 dense rows, n = 16384: 2^21 leaves
     per MSM; one leaf round with S = 32, projective rounds with S = 512,
     128), fb_bases at the chain's shape (W = 256, c = 1), the chain
     build (its plain version from fb_bases' plain output) and every round
     against its plain version, timed beside it, its
     points against the query's, its whole call timed beside the query's;
  6. the sharded path (parallel/), this slice's main path: an NCCL process
     group of world size 1 over a FileStore in a temporary directory (the
     collectives run on the card at that size); sharded_msm_device_sums and
     sharded_msm_batch at n = 16384, P = 8 against msm_chain's points,
     sharded_ntt_batch on the prover's coset batch (5 x 131072) and
     ShardedNTT at n = 2^17 (fft, ifft, coset fft / ifft) against NTTDomain,
     dryrun_multichip with its one-card shuffle proof through the group; then the 52-card proof of phase 4 again, on its
     prover params and rng state, through a KZG on the group: every Lagrange
     commit through the sharded msm_chain, the batched NTTs through
     sharded_ntt_batch; the same sha256, both scan kernels launched, neither
     the table nor the Pippenger used; its stage times beside the
     fixed-base proof's; that proof profiled too;
  7. the matchmaking path: zmatchmaking's 50-player proof, the generic
     TurboPLONK shape (n = 8192, m = 65536), through its entry points:
     gen_matchmaking_prover_params(50) on the card, where the embedded vk
     must be refused as stale (8 selector commitments) and the circuit
     re-indexed, and the n = 8192 table built (fb_bases and fb_mult_chunk
     launched), timed; prove_matchmaking with random.Random(seed) on
     seeded_match's players, committed seed and random number: the outputs a
     permutation of the inputs, verify_matchmaking accepts the proof and
     rejects it with two outputs swapped, its sha256 the JAX package's
     (key "mm50"), every fixed-base proof kernel launched; a profiled proof;
     the same proof through a fixed_base=False KZG from the same rng state,
     the same sha256, both Pippenger kernels launched, profiled too; both
     routes' stages side by side; ntt_pass at every shape the proof launched
     (those new to it logged) against its plain version, timed; sampled rows
     of the n = 8192 table against host multiples; the table build's four
     kernels at its shapes (n = 8192, W = 32, K = 262,144, CH = 16) against
     their plain versions, timed, with their bounds, and a second build
     profiled (each kernel's device time); the query's kernels and
     the Pippenger's at the proof's batches (P = 5, 1, 2 at n = 8192) against
     their plain versions (fq_batch_inv by a * a^-1 == 1; msm_bucket_reduce,
     whose buckets have phase 3's shapes, timed beside phase 3's plain
     times), timed, with their bounds summed over one proof;
     the params cache's round trip of the matchmaking params on the card;
  8. the SDK's hex game flow for 52 cards and four players on phase 4's
     prover params (handed over through the SDK's params table: no second
     set-up), from keypairs to unmask_card, every check of the flow passing
     and the revealed indices the deck's 52; its per-card host arithmetic in
     8 spawned processes;
  9. the Groth16 phase: the embedded reveal proving key (groth16_pk.bin,
     domain 8192) and the own-shape setup of a 700-product chain (domain
     1024) are made on the host in 2 spawned worker processes started
     before the kernel build; prove_reveal_onchain for the seeded sk and
     masked e1 (key "reveal") on the card, its witness map's six ntt_pass
     launches and four G1 MSMs (n = 2823, 4094, 4862, 8191, P = 1) and its
     G2 MSM (msm_g2.py: 4096 bases with beta_g2 and delta_g2) on the card,
     with its stage times: the sha256 of its Solidity words and reveal
     point must equal the JAX package's, verify_reveal_onchain must accept
     it and reject the reveal point changed by one, ntt_pass and both
     Pippenger kernels must have been launched and each G2 kernel once; a
     second reveal profiled (device busy, idle share, device time by
     kernel); sdk.reveal_card_with_snark on the card, its proof verified;
     msm_bucket_accumulate and msm_bucket_reduce at each of the reveal's
     four MSMs on its own bases and scalars, timed, the accumulate against
     its plain version (the reduce's buckets have phase 3's P = 1 shape; at
     n = 2823 and 8191 the result against the host Pippenger);
     g2_bucket_accumulate and g2_bucket_reduce on the reveal's own G2 bases
     (the key's cached host limbs) and scalars (the assignment, 1, s), each
     timed beside its plain version and equal to it limb for limb; and
     ntt_pass at each of its passes; then groth16.prove of the chain on the
     card (key "g16toy"), which must launch the reveal's kernels and no
     other, each G2 kernel once, verified, a wrong public input rejected;
 10. a kernels JSON line (per kernel: launches on its path, ms, plain ms, the
     bound worked out from this run's shapes and what bounds it, and the time
     of one PyTorch call computing the same function where there is one:
     only fb_select's gather; no PyTorch call computes a BN254 NTT, MSM,
     table or group addition); fb_bases has two rows, the table build's
     (c = 8, one launch per build) and the chain's (fb_bases_chain: W = 256,
     c = 1, its launches the group proof's, one per msm_chain call);
     ntt_pass and fb_pair_combine also give their
     per-proof device time in the profiled proof (proof_ms), the sum over
     the proof's launches of their timed shapes (proof_events_ms) and the
     per-proof bound summed likewise (proof_bound_ms); the Pippenger's two
     likewise over its four batches (the accumulate with its scratch bytes); the Pippenger's kernels give their
     proof_ms from the variable-base proof's profile, the scan kernels from
     the group proof's; per kernel too its numbers on the matchmaking proof:
     mm_launches, mm_setup_launches, mm_proof_ms (its profile) and, at the
     proof's shapes, mm_events_ms, mm_plain_ms, mm_bound_ms (fb_bases and
     fb_mult_chunk: at the n = 8192 table build's, their only use there);
     the four build kernels also mm_setup_ms, their device time in the
     profiled n = 8192 build, and fp_mont_mul and fq_batch_inv
     mm_setup_events_ms, mm_setup_plain_ms, mm_setup_bound_ms at the build's
     shapes; ntt_pass, the Pippenger's two and the G2 Pippenger's two also
     their numbers on the reveal: g16_launches, g16_proof_ms (its profile)
     and, summed over the reveal's shapes, g16_events_ms, g16_plain_ms,
     g16_bound_ms; the card
     line,
     and last the contract line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

The scan kernels' times are per msm_chain call of P = 8 MSMs, scan_proj_reduce
summed over its two rounds; their launches are the group proof's.
msm_bucket_accumulate's time is one wrapper call (its sort, piece and merge
launches), its proof_ms the three kernels' device time in the profile.
The query kernels' times are per query of P = 8 MSMs, summed over its
levels (each level's time is logged): AFFINE_LEVELS batch-affine levels
(fb_pair_den, fq_batch_inv, fb_pair_combine); fb_fold's is the whole tail
(Kc = 65,536 to 1 in two launches, each also timed alone).  fp_mont_mul and
fq_batch_inv run on both the proof and the table build; their JSON rows
give the proof's launches and the query's shapes, and phase 5 logs their
times at the build's.

Bounds: the larger of the bytes the function must move (each input read
once, each output written once) over 3.35 TB/s, and its 32-bit integer
multiplies over the card's multiply rate, 64 per SM per clock (the CUDA C
Programming Guide's throughput for compute capability 9.0) at the SMs and
the maximum SM clock the card reports.  A Montgomery product (field.cuh
fp_mul, 8 x 32-bit limbs) is 264 multiplies: 64 limb products a_j * b_i and
64 products m * p_j, each a low and a high half, plus the 8 digits m.  The
group operations count the products of the complete formulas of Renes,
Costello and Batina for a = 0 (RCB): a mixed addition (Alg. 8) 11, a
projective addition (Alg. 7) 12, a doubling (Alg. 9) 8.  Their products by
b3 = 3 * 3 = 9 cost no multiply (three doublings and an addition, as
field.cuh's g1_madd and g1_padd do them); the kernels double with Alg. 7
(g1_padd, or g1_dbl_ls in fb_bases: 12 products), so a doubling's bound
counts fewer products than they run.
Over G2 (csrc/g2.cuh) an Fq2 product counts 3 Montgomery products
(Karatsuba) and a square 2, and the products by b3 = 9 / (9 + u) are full
Fq2 products: a mixed addition 13 Fq2 products (39), a projective addition
14 (42), a doubling 2 squares and 7 products (25).
A batch inversion of N elements needs 3 (N - 1) products and one Fermat
inversion: the yardstick stays that, though fq_batch_inv inverts its group
products by safegcd.  An affine pair addition given the inverse needs 3
products; a negation, a select or a difference none.
"""

import gc
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

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
IMUL_PER_SM_CLOCK = 64  # 32-bit integer multiplies, compute capability 9.0
MULS_PER_PRODUCT = 264  # 32-bit multiplies in one Montgomery product
MADD_PRODUCTS, PADD_PRODUCTS, DBL_PRODUCTS = 11, 12, 8  # RCB Alg. 8, 7, 9


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def imul_rate() -> float:
    """32-bit integer multiplies per second of the card at its maximum SM
    clock."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * IMUL_PER_SM_CLOCK * float(mhz) * 1e6


def bound(nbytes: int, products: int, rate: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    Montgomery products over the multiply rate, whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = products * MULS_PER_PRODUCT / rate
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def cuda_ms(fn, reps: int = 5):
    """Mean milliseconds of fn() on the card over `reps` calls after two
    warm-up calls (reps = 0: one cold call, timed), and the last result.
    Each timed call runs while the last one's outputs are alive, so it
    needs a second set of output memory: the first warm-up's outputs are
    held through the second, which leaves two sets in the caching allocator
    and no cudaMalloc inside the timed calls (with one warm-up, the first
    timed call allocated the second set: 805 MB for fb_mult_chunk at the
    table build's shape)."""
    out = None
    if reps:
        held = fn()
        out = fn()
        del held
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(max(reps, 1)):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / max(reps, 1), out


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |difference| of the 32-bit limbs of two Montgomery tensors,
    taken on the device of `a`."""
    a = a.to(torch.int64) & 0xFFFFFFFF
    b = b.to(a.device).to(torch.int64) & 0xFFFFFFFF
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


def check_ntt(dev, rng, rate):
    from uzkge_tpu_torch.constants.bn254 import R_MOD
    from uzkge_tpu_torch.ff.field import fr
    from uzkge_tpu_torch.ntt import cuda_ntt
    from uzkge_tpu_torch.ntt.ntt import NTTDomain

    err = 0
    for n, B in ((16384, 8), (131072, 1)):
        vals = [rng.randrange(R_MOD) for _ in range(B * n)]
        x = fr.to_mont_limbs(vals, "cpu").reshape(B, n, 8)
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
    xs = random_fr(OUT * S * IN, dev).view(OUT, S, IN, 8)
    tw = NTTDomain(131072, dev)._plan_fwd["plan1"]["tws"][0]
    ms, got = cuda_ms(lambda: cuda_ntt.ntt_pass(xs, tw), reps=50)  # enough to lift the clocks
    plain_ms, want = cuda_ms(lambda: cuda_ntt.ntt_pass_plain(xs, tw), reps=0)
    e = max_abs_err(got, want)
    if e != 0:
        raise AssertionError("ntt_pass disagrees with ntt_pass_plain on the card")
    log(f"ntt_pass (OUT={OUT}, S={S}, IN={IN}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": max(err, e), "ms": ms, "plain_ms": plain_ms,
            "shape": f"OUT={OUT} S={S} IN={IN}", **ntt_bound(OUT, S, IN, False, False, False, rate)}


def ntt_bound(OUT, S, IN, pre, post, const, rate) -> dict:
    """ntt_pass's bound at one shape: every radix-2 stage but the last
    multiplies each butterfly by its twiddle, each ladder or constant one
    product per element; x and the ladders read once, y written once."""
    elems = OUT * S * IN
    products = OUT * IN * (S // 2) * (S.bit_length() - 2) + elems * (pre + post + const)
    nbytes = 2 * elems * 32 + (S // 2) * 32 + (pre + post) * S * IN * 32 + const * 32
    return bound(nbytes, products, rate)


class NttShapes:
    """Counts the (OUT, S, IN, pre, post, const) shape of every ntt_pass call
    while active (a wrapper around cuda_ntt.ntt_pass; it launches nothing)."""

    def __init__(self):
        self.counts = {}

    def __enter__(self):
        from uzkge_tpu_torch.ntt import cuda_ntt

        self._orig = cuda_ntt.ntt_pass

        def record(x, tw, pre=None, post=None, const=None):
            key = (*x.shape[:3], pre is not None, post is not None, const is not None)
            self.counts[key] = self.counts.get(key, 0) + 1
            return self._orig(x, tw, pre, post, const)

        cuda_ntt.ntt_pass = record
        return self

    def __exit__(self, *exc):
        from uzkge_tpu_torch.ntt import cuda_ntt

        cuda_ntt.ntt_pass = self._orig


def time_ntt_shapes(dev, counts, rate, errs):
    """ntt_pass at every shape the proof launched (`counts`: NttShapes.counts)
    against its plain version on the same inputs, timed beside it (mean of 5,
    CUDA events); returns the per-proof sums over the launches: kernel ms,
    plain ms and bound ms."""
    from uzkge_tpu_torch.ntt import cuda_ntt
    from uzkge_tpu_torch.ntt.ntt import NTTDomain
    from uzkge_tpu_torch.ntt.stockham import stage_twiddles_strided

    master = NTTDomain(2048, dev).master
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "launches": 0}
    for (OUT, S, IN, pre, post, const), count in sorted(counts.items()):
        x = random_fr(OUT * S * IN, dev).view(OUT, S, IN, 8)
        tw = stage_twiddles_strided(master, 2048, S, 2048 // S, False)[0]
        lads = [random_fr(S * IN, dev).view(S, IN, 8) if pre else None,
                random_fr(S * IN, dev).view(S, IN, 8) if post else None,
                random_fr(1, dev).view(8) if const else None]
        shape = (f"OUT={OUT} S={S} IN={IN} pre={int(pre)} post={int(post)} "
                 f"const={int(const)} x{count}")
        _, ms, pms = compare(errs, "ntt_pass", shape, lambda: cuda_ntt.ntt_pass(x, tw, *lads),
                             lambda: cuda_ntt.ntt_pass_plain(x, tw, *lads), reps=5)
        b = ntt_bound(OUT, S, IN, pre, post, const, rate)
        log(f"  ntt_pass {shape}: bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        tot["ms"] += count * ms
        tot["plain_ms"] += count * pms
        tot["bound_ms"] += count * b["bound_ms"]
        tot["launches"] += count
    log(f"ntt_pass per proof ({tot['launches']} launches, CUDA events): kernel {tot['ms']:.4f} ms, "
        f"plain {tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms")
    return tot


def check_product_rate(dev):
    """The product rate of field.cuh's fp_mul on the card: fp_mul_chain with
    4 independent chains per thread, 2048 threads per SM, 512 products per
    chain, Fr and Fq (mean of 3 after a warm-up), beside the bounds' assumed
    rate (the multiply rate over MULS_PER_PRODUCT); the kernel's output on a
    small input against its plain version first."""
    from uzkge_tpu_torch.ff.cuda_field import CHAINS, fp_mul_chain, fp_mul_chain_plain
    from uzkge_tpu_torch.ff.field import fq, fr

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    N, iters = 2048 * sms, 512
    assumed = imul_rate() / MULS_PER_PRODUCT
    for name, ctx in (("Fr", fr), ("Fq", fq)):
        a, b = random_fr(CHAINS * 512, dev).view(CHAINS, 512, 8), random_fr(512, dev)
        if not torch.equal(fp_mul_chain(ctx, a, b, 8), fp_mul_chain_plain(ctx, a, b, 8)):
            raise AssertionError(f"fp_mul_chain ({name}) disagrees with its plain version")
        a, b = random_fr(CHAINS * N, dev).view(CHAINS, N, 8), random_fr(N, dev)
        ms, _ = cuda_ms(lambda: fp_mul_chain(ctx, a, b, iters), reps=3)
        rate = CHAINS * N * iters / (ms * 1e-3)
        log(f"product rate {name}: {rate:.4e} products/s ({CHAINS} chains x {N} threads x "
            f"{iters}, {ms:.4f} ms), {rate / assumed:.4f} of the bounds' assumed {assumed:.4e}/s")


def check_msm(dev, rng, rate):
    from uzkge_tpu_torch.constants.bn254 import R_MOD
    from uzkge_tpu_torch.curve.bn254 import G1_GEN, g1_add, g1_mul
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
    std = fr.from_mont(torch.stack([fr.to_mont_limbs(r, dev) for r in rows]))
    L = M.pick_piece(n, P, dev)
    kb = M.msm_bucket_accumulate(bases.x, bases.y, std, L)
    pb = M.msm_bucket_accumulate_plain(bases.x, bases.y, std, L)
    if not torch.equal(kb, pb):
        raise AssertionError(f"msm n={n} P={P}: msm_bucket_accumulate disagrees with its plain "
                             "version")
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
    eb = identity_buckets(kb)
    if point_err(window_points(M.msm_bucket_reduce(eb)),
                 window_points(M.msm_bucket_reduce_plain(eb))) != 0:
        raise AssertionError(f"msm n={n} P={P}: msm_bucket_reduce disagrees with its plain "
                             "version on buckets with identities")
    log(f"msm n={n} P={P} L={L}: kernels == plain == host (the accumulate's buckets limb for "
        "limb); msm_bucket_reduce == plain with empty buckets")

    # n = 16384, P = 8 on the Lagrange SRS bases, 64 nonzero scalars per row
    n, P = 16384, 8
    pts = load_srs(n, dev)._lagrange_points
    bases = M.MSMBases(pts, dev)
    rows = []
    for _ in range(P):
        row = [0] * n
        for i in rng.sample(range(n), 64):
            row[i] = rng.randrange(1, R_MOD)
        rows.append(row)
    sc = torch.stack([fr.to_mont_limbs(r, dev) for r in rows])
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

    acc = check_accumulate(dev, rng, bases, rate)
    red = check_reduce_batches(dev, acc.pop("buckets"), rate)
    e_red = red.pop("max_abs_err")
    return ({**acc, "max_abs_err": max(err_acc, e, acc["max_abs_err"])},
            {"max_abs_err": max(err_red, e, e_red), **red})


def skewed_rows(n: int, P: int, rng):
    """P rows of n scalars as a proof's witness columns make them, the
    accumulate's hard cases: all ones (every point in bucket 1 of window 0),
    all zero, values below 2^16 (two windows used), one scalar repeated at
    every point (one bucket a window), mostly zero with small values, and
    dense rows after them."""
    from uzkge_tpu_torch.constants.bn254 import R_MOD

    s = rng.randrange(R_MOD)
    kinds = [[1] * n, [0] * n, [rng.randrange(1 << 16) for _ in range(n)], [s] * n,
             [rng.randrange(16) if rng.random() < 0.1 else 0 for _ in range(n)]]
    while len(kinds) < P:
        kinds.append([rng.randrange(R_MOD) for _ in range(n)])
    return kinds[:P]


def acc_bound(std, n: int, rate) -> dict:
    """msm_bucket_accumulate's bound: a mixed addition per nonzero digit; the
    bases and the scalars read once, the (P, 1, 32, 256) buckets written
    once."""
    from uzkge_tpu_torch.msm import msm as M

    P = std.shape[0]
    nonzero = int((M._digits(std) != 0).sum())
    return bound(2 * n * 32 + P * n * 32 + P * M.N_WINDOWS * M.N_BUCKETS * 96,
                 nonzero * MADD_PRODUCTS, rate)


def check_accumulate(dev, rng, bases, rate):
    """msm_bucket_accumulate at n = 16384 against its plain version on the
    same inputs, limb for limb: on dense rows at the variable-base proof's
    four batches P = 8, 1, 5, 2 (r1, r2, r3's t split, r5), each timed
    beside the plain version (CUDA events, mean of 5; the plain one cold),
    with the Pippenger's scratch (peak device memory of an accumulate and
    its reduce, beyond their inputs); then at P = 8 on skewed_rows.  Returns
    the P = 8 row with the per-proof sums, and the dense buckets by P (the
    reduce's inputs)."""
    from uzkge_tpu_torch.constants.bn254 import R_MOD
    from uzkge_tpu_torch.ff.field import fr
    from uzkge_tpu_torch.msm import msm as M

    n = bases.n
    tot = {"proof_events_ms": 0.0, "proof_plain_ms": 0.0, "proof_bound_ms": 0.0}
    row, buckets = None, {}
    for P in (8, 1, 5, 2):
        sc = torch.stack([fr.to_mont_limbs([rng.randrange(R_MOD) for _ in range(n)], dev)
                          for _ in range(P)])
        std = fr.from_mont(sc)
        L = M.pick_piece(n, P, dev)
        ms, kb = cuda_ms(lambda: M.msm_bucket_accumulate(bases.x, bases.y, std, L))
        plain_ms, pb = cuda_ms(lambda: M.msm_bucket_accumulate_plain(bases.x, bases.y, std, L),
                               reps=0)
        if not torch.equal(kb, pb):
            raise AssertionError(f"msm_bucket_accumulate (n={n}, P={P}, L={L}) disagrees with "
                                 "its plain version")
        del pb
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        M.msm_bucket_reduce(M.msm_bucket_accumulate(bases.x, bases.y, std, L))
        torch.cuda.synchronize()
        scratch = torch.cuda.max_memory_allocated() - held
        b = acc_bound(std, n, rate)
        log(f"msm_bucket_accumulate (n={n}, P={P}, L={L}): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}), equal limb for "
            f"limb; Pippenger scratch (accumulate + reduce) {scratch} B")
        tot["proof_events_ms"] += ms
        tot["proof_plain_ms"] += plain_ms
        tot["proof_bound_ms"] += b["bound_ms"]
        buckets[P] = kb
        if P == 8:
            row = {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
                   "shape": f"n={n} P={P} L={L}", "scratch_bytes": scratch, **b}
    P = 8
    std = fr.from_mont(torch.stack([fr.to_mont_limbs(r, dev) for r in skewed_rows(n, P, rng)]))
    L = M.pick_piece(n, P, dev)
    kb = M.msm_bucket_accumulate(bases.x, bases.y, std, L)
    pb = M.msm_bucket_accumulate_plain(bases.x, bases.y, std, L)
    if not torch.equal(kb, pb):
        raise AssertionError(f"msm_bucket_accumulate (n={n}, P={P}, L={L}) disagrees with its "
                             "plain version on skewed rows")
    if point_err(window_points(M.msm_bucket_reduce(kb)),
                 window_points(M.msm_bucket_reduce_plain(pb))) != 0:
        raise AssertionError("msm_bucket_reduce disagrees with its plain version on the skewed "
                             "rows' buckets")
    log(f"msm_bucket_accumulate (n={n}, P={P}, L={L}) on skewed rows (all ones, all zero, below "
        "2^16, one scalar repeated, mostly zero, dense): equal limb for limb")
    log("msm_bucket_accumulate per proof (P = 8, 1, 5, 2): " + json.dumps(tot))
    return {**row, **tot, "buckets": buckets}


# msm_bucket_reduce_plain's ms at (P, 1, 32, 256) buckets, timed in phase 3: the
# reduce's input has that shape at every n, so phases 7 and 9 hold the kernel
# at those shapes through their proofs' digests and report these plain times
REDUCE_PLAIN_MS = {}


def reduce_bound(P: int, K: int, rate) -> dict:
    """msm_bucket_reduce's bound at (P, K): per (p, w) the fold of 256 buckets
    over K chunks, 16 segments of 15 buckets (two additions each) plus 15
    segment heads, and the combine of 47 additions and 4 doublings (the
    running-sum weighted sum's count, whatever order the kernel adds in); the
    buckets read once, the window sums written once."""
    from uzkge_tpu_torch.msm import msm as M

    adds = P * M.N_WINDOWS * (M.N_BUCKETS * (K - 1) + 16 * 30 + 15 + 47)
    return bound(P * K * M.N_WINDOWS * M.N_BUCKETS * 96 + P * M.N_WINDOWS * 96,
                 adds * PADD_PRODUCTS + P * M.N_WINDOWS * 4 * DBL_PRODUCTS, rate)


def window_points(wsums):
    """(P, 32, 3, 8) window sums -> one affine host point per window."""
    from uzkge_tpu_torch.msm import msm as M

    return M._window_sums_to_points(wsums.cpu().reshape(-1, 1, 3, 8))


def identity_buckets(kb):
    """A copy of the accumulate's (P, 1, 32, 256, 3, 8) buckets with a third
    of them and one whole window the identity (0 : 1 : 0), and bucket 0 of
    every window a point (the reduce must ignore it)."""
    from uzkge_tpu_torch.ff.field import fq

    out = kb.clone()
    g = torch.Generator(device=out.device).manual_seed(9)
    empty = torch.rand(out.shape[:4], generator=g, device=out.device) < 1 / 3
    empty[:, :, 3] = True
    out[empty] = torch.stack([torch.zeros(8, dtype=torch.int32, device=out.device),
                              fq.const(1, out.device),
                              torch.zeros(8, dtype=torch.int32, device=out.device)])
    out[:, :, :, 0] = kb[:, :, :, 1]
    return out


def check_reduce_batches(dev, buckets, rate):
    """msm_bucket_reduce against msm_bucket_reduce_plain as affine window sums
    (their projective limbs differ: the kernel adds in another order) at every
    batch the proof's commits use, P = 8, 1, 5, 2 at n = 16384, each on the
    accumulate kernel's buckets of dense random scalars (check_accumulate's,
    `buckets` by P: one chunk, K = 1), timed beside the plain version (CUDA
    events, mean of 5; the plain one cold), and on a copy with empty buckets
    and whole windows of them.  Returns the P = 8 row with the per-proof
    sums of the times and bounds."""
    from uzkge_tpu_torch.msm import msm as M

    n = 16384
    tot = {"proof_events_ms": 0.0, "proof_plain_ms": 0.0, "proof_bound_ms": 0.0}
    row = None
    for P in (8, 1, 5, 2):
        kb = buckets.pop(P)
        K = kb.shape[1]
        ms, ks = cuda_ms(lambda: M.msm_bucket_reduce(kb))
        plain_ms, kp = cuda_ms(lambda: M.msm_bucket_reduce_plain(kb), reps=0)
        want = window_points(kp)
        if point_err(window_points(ks), want) != 0 or None in want:
            raise AssertionError(f"msm_bucket_reduce (P={P}, K={K}) disagrees with its plain "
                                 "version")
        REDUCE_PLAIN_MS[P] = plain_ms
        also = ""
        if P == 8:  # the kernel's path does not depend on P: identities at one batch
            eb = identity_buckets(kb)
            if point_err(window_points(M.msm_bucket_reduce(eb)),
                         window_points(M.msm_bucket_reduce_plain(eb))) != 0:
                raise AssertionError(f"msm_bucket_reduce (P={P}, K={K}) disagrees with its plain "
                                     "version on buckets with identities")
            also = ", also with empty buckets"
            del eb
        b = reduce_bound(P, K, rate)
        log(f"msm_bucket_reduce (P={P}, K={K}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}); equal as affine window sums{also}")
        tot["proof_events_ms"] += ms
        tot["proof_plain_ms"] += plain_ms
        tot["proof_bound_ms"] += b["bound_ms"]
        if P == 8:
            row = {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, "shape": f"n={n} P={P} K={K}",
                   **b}
        del kb, ks, kp
    log("msm_bucket_reduce per proof (P = 8, 1, 5, 2): " + json.dumps(tot))
    return {**row, **tot}


# ---------------------------------------------------------------- fixed base

PROOF_KERNELS = ("ntt_pass", "fp_mont_mul", "fb_select", "fb_pair_den", "fq_batch_inv",
                 "fb_pair_combine", "fb_fold")
VB_KERNELS = ("msm_bucket_accumulate", "msm_bucket_reduce")  # the fixed_base=False proof
ACC_KERNELS = ("msm_bucket_accumulate_sort_kernel", "msm_bucket_accumulate_piece_kernel",
               "msm_bucket_accumulate_merge_kernel")  # msm_bucket_accumulate's launches
SETUP_KERNELS = ("fb_bases", "fb_mult_chunk")  # the table build in the proof's set-up
FB_KERNELS = ("fp_mont_mul", "fb_bases", "fb_mult_chunk", "fq_batch_inv")
STAGES = ("r1_commit", "r2_commit", "r3_t_split_commit", "r5_openings")


def fq_rows(points, dev):
    """Affine points -> (x, y), each (n, 8) Fq Montgomery on `dev`."""
    from uzkge_tpu_torch.ff.field import fq

    n = len(points)
    return (fq.to_mont_limbs([p[0] for p in points], dev).reshape(n, 8),
            fq.to_mont_limbs([p[1] for p in points], dev).reshape(n, 8))


def fermat_products() -> int:
    """Montgomery products of one Fermat inversion x^(q-2) by left-to-right
    square and multiply: a squaring per bit below the top one, a multiply per
    set bit among them."""
    from uzkge_tpu_torch.constants.bn254 import Q_MOD

    e = Q_MOD - 2
    return e.bit_length() - 1 + bin(e).count("1") - 1


def batch_inv_products(N: int) -> int:
    """Montgomery products a batch inversion of N elements needs: one
    forward and two backward products per element but the first, and one
    Fermat inversion (fq_batch_inv itself inverts up to INV_ROOTS group
    products by safegcd)."""
    return 3 * (N - 1) + fermat_products()


def compare(errs, name, shape, kernel, plain, reps=3):
    """Time kernel() and plain() on the same inputs, raise unless their
    outputs agree limb for limb, record the error under `name`; returns the
    kernel's outputs (a tuple), its ms and the plain version's ms."""
    ms, got = cuda_ms(kernel, reps)
    plain_ms, want = cuda_ms(plain, reps=0)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    e = max(max_abs_err(g, w) for g, w in zip(got, want))
    if e != 0 or len(got) != len(want):
        raise AssertionError(f"{name} ({shape}) disagrees with its plain version")
    errs[name] = max(errs.get(name, 0), e)
    log(f"{name} ({shape}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, equal")
    return got, ms, plain_ms


def inverse_checked(shape, flat):
    """fq_batch_inv on `flat` (N, 8), timed (mean of 3), its output checked
    by a * a^-1 == 1 (fp_mont_mul) instead of against its plain version: at
    N <= 2^21 it runs its one-launch path, held against the plain version at
    the P = 8 query's levels (N = 2^19 .. 2^21) and at N = 8192, 12288 and
    131072.  Returns the inverse and the ms."""
    from uzkge_tpu_torch.ff.cuda_field import fp_mont_mul
    from uzkge_tpu_torch.ff.field import fq
    from uzkge_tpu_torch.msm import fixed_base as fb

    if flat.shape[0] > 1 << 21:
        raise ValueError(f"fq_batch_inv ({shape}): above 2^21 it runs another path")
    ms, inv = cuda_ms(lambda: fb.fq_batch_inv(flat), reps=3)
    if not torch.equal(fp_mont_mul(fq, flat, inv), fq.const(1, flat.device).expand_as(flat)):
        raise AssertionError(f"fq_batch_inv ({shape}): a * a^-1 != 1")
    log(f"fq_batch_inv ({shape}): kernel {ms:.4f} ms, a * a^-1 == 1")
    return inv, ms


def plain_table(x, y, W: int, c: int, done=None):
    """FixedBaseTable's table, built by the plain versions alone on the
    device of x (there the wrappers would launch the kernels).  `done` holds
    plain outputs already computed on the same inputs (check_fixed_base_small's
    comparisons), which are not computed again: "bases", "zinv", "bax",
    "chunk0" (the first fb_mult_chunk_plain) and "zinv0" (its inverse)."""
    from uzkge_tpu_torch.ff.cuda_field import fp_mont_mul_plain
    from uzkge_tpu_torch.ff.field import fq
    from uzkge_tpu_torch.msm import fixed_base as fb

    done = done or {}
    D, K = 1 << (c - 1), W * x.shape[0]
    CH = min(16, D)
    BX, BY, BZ = done.get("bases") or fb.fb_bases_plain(x, y, W, c)
    zinv = done["zinv"] if "zinv" in done else fb.fq_batch_inv_plain(BZ)
    bax = done["bax"] if "bax" in done else fp_mont_mul_plain(fq, BX, zinv)
    bay = fp_mont_mul_plain(fq, BY, zinv)
    T = (bax, bay, fq.const(1, x.device).expand(K, 8).contiguous())
    table = torch.empty((K, D, 16), dtype=torch.int32, device=x.device)
    for d0 in range(0, D, CH):
        if d0 == 0 and "chunk0" in done:
            (EX, EY, EZ, *T), zinv = done["chunk0"], done["zinv0"]
        else:
            EX, EY, EZ, *T = fb.fb_mult_chunk_plain(*T, bax, bay, CH)
            zinv = fb.fq_batch_inv_plain(EZ.view(CH * K, 8))
        for E, half in ((EX, slice(0, 8)), (EY, slice(8, 16))):
            table[:, d0 : d0 + CH, half] = fp_mont_mul_plain(
                fq, E.view(CH * K, 8), zinv).view(CH, K, 8).transpose(0, 1)
    return table


def cuda_launches(fn, prefix: str) -> int:
    """The CUDA launches of one fn() through the C entry points whose names
    start with `prefix`, as kernels.launch counts them (kernels.CALLS)."""
    from uzkge_tpu_torch import kernels

    def count():
        return sum(v for k, v in kernels.CALLS.items() if k.startswith(prefix))

    before = count()
    fn()
    return count() - before


def random_fr(N: int, dev):
    """N canonical Fr elements (values below 2^252 < r) made on the card."""
    a = torch.randint(-(1 << 31), 1 << 31, (N, 8), dtype=torch.int32, device=dev)
    a[:, 7] &= 0x0FFFFFFF
    return a


def check_fixed_base_small(dev, points, errs):
    """The fixed-base kernels at n = 256, c = 8, bits = 254 (W = 32, K = 8192,
    D = 128, eight chunks) on the first 256 Lagrange bases, each against its
    plain version, then the whole table against plain_table."""
    from uzkge_tpu_torch.ff.cuda_field import fp_mont_mul, fp_mont_mul_plain
    from uzkge_tpu_torch.ff.field import fq, fr
    from uzkge_tpu_torch.msm import fixed_base as fb

    n, c, bits = 256, 8, 254
    W, CH = 32, 16
    K = W * n
    x, y = fq_rows(points[:n], dev)
    done = {}  # the plain outputs, equal to the kernels': plain_table does not recompute them

    def keep(key, fn):
        def plain():
            done[key] = fn()
            return done[key]
        return plain

    B, _, _ = compare(errs, "fb_bases", f"n={n} W={W} c={c}",
                      lambda: fb.fb_bases(x, y, W, c),
                      keep("bases", lambda: fb.fb_bases_plain(x, y, W, c)))
    (zinv,), _, _ = compare(errs, "fq_batch_inv", f"N={K}", lambda: fb.fq_batch_inv(B[2]),
                            keep("zinv", lambda: fb.fq_batch_inv_plain(B[2])))
    (bax,), _, _ = compare(errs, "fp_mont_mul", f"Fq N={K}", lambda: fp_mont_mul(fq, B[0], zinv),
                           keep("bax", lambda: fp_mont_mul_plain(fq, B[0], zinv)))
    bay = fp_mont_mul(fq, B[1], zinv)
    one = fq.const(1, dev).expand(K, 8).contiguous()
    E, _, _ = compare(errs, "fb_mult_chunk", f"K={K} CH={CH}",
                      lambda: fb.fb_mult_chunk(bax, bay, one, bax, bay, CH),
                      keep("chunk0", lambda: fb.fb_mult_chunk_plain(bax, bay, one, bax, bay, CH)))
    EZ = E[2].view(CH * K, 8)
    compare(errs, "fq_batch_inv", f"N={CH * K}", lambda: fb.fq_batch_inv(EZ),
            keep("zinv0", lambda: fb.fq_batch_inv_plain(EZ)))
    a, b = random_fr(CH * K, dev), random_fr(CH * K, dev)
    compare(errs, "fp_mont_mul", f"Fr N={CH * K}", lambda: fp_mont_mul(fr, a, b),
            lambda: fp_mont_mul_plain(fr, a, b))

    t0 = time.perf_counter()
    tbl = fb.FixedBaseTable(points[:n], c=c, bits=bits, device=dev)
    table = tbl.table
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want = plain_table(x, y, W, c, done)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    e = max_abs_err(table, want)
    if e != 0:
        raise AssertionError(f"fixed-base table n={n}: the kernels' table differs from the plain one")
    log(f"fixed-base table n={n} c={c} bits={bits} ({tuple(table.shape)}): kernels {t1 - t0:.3f} s "
        f"== plain versions {t2 - t1:.3f} s (beyond the comparisons above, whose plain outputs "
        "it reuses)")
    return tbl


def check_query_small(dev, tbl, errs, rng):
    """The query's kernels on the n = 256, c = 8 table for P = 3 MSMs, each
    against its plain version on the same inputs: fb_select, a level with
    identity and x1 == x2 pairs planted (fb_pair_den, fq_batch_inv at the
    level's size, fb_pair_combine), fb_fold over the level's whole tail
    (4096 points per MSM: tiles of 512, then 8) and at width 2; then a
    whole msm_mont against the host Pippenger."""
    from uzkge_tpu_torch.constants.bn254 import R_MOD
    from uzkge_tpu_torch.ff.field import fr
    from uzkge_tpu_torch.msm import fixed_base as fb
    from uzkge_tpu_torch.msm.msm import host_msm

    P, n, K = 3, tbl.n, tbl.W * tbl.n
    H = K // 2
    rows = [[rng.randrange(R_MOD) for _ in range(n)] for _ in range(P)]
    rows[1] = [0] * n
    rows[1][7] = rng.randrange(R_MOD)
    sc = fr.to_mont_limbs([v for row in rows for v in row], dev).reshape(P, n, 8)
    d = fb.scalars_to_digits(sc, tbl.c, tbl.bits).transpose(1, 2).reshape(P, K).contiguous()
    x, y, inf = compare(errs, "fb_select", f"P={P} K={K}", lambda: fb.fb_select(d, tbl.table),
                        lambda: fb.fb_select_plain(d, tbl.table))[0]
    x, inf = x.clone(), inf.clone()
    inf[0, [0, H, 1, 2 + H]] = 1  # pairs 0, 1, 2 of MSM 0: both, first, second the identity
    inf[0, [1 + H, 2]] = 0
    x[2, 3 + H] = x[2, 3]  # pair 3 of MSM 2: x1 == x2
    inf[2, [3, 3 + H]] = 0
    den, flags = compare(errs, "fb_pair_den", f"P={P} H={H}", lambda: fb.fb_pair_den(x, inf),
                         lambda: fb.fb_pair_den_plain(x, inf))[0]
    if flags[0, :3].tolist() != [3, 1, 2] or int(flags[2, 3]) != 4:
        raise AssertionError("fb_pair_den: the planted pairs' flags are wrong")
    flat = den.view(P * H, 8)
    (dinv,) = compare(errs, "fq_batch_inv", f"N={P * H}", lambda: fb.fq_batch_inv(flat),
                      lambda: fb.fq_batch_inv_plain(flat))[0]
    dinv = dinv.view(P, H, 8)
    xo, yo, io = compare(errs, "fb_pair_combine", f"P={P} H={H}",
                         lambda: fb.fb_pair_combine(x, y, dinv, flags),
                         lambda: fb.fb_pair_combine_plain(x, y, dinv, flags))[0]
    if io[0, :3].tolist() != [1, 0, 0] or int(io[2, 3]) != 1:
        raise AssertionError("fb_pair_combine: the planted pairs' identity flags are wrong")
    pts = fb.to_projective(xo, yo, io)
    compare(errs, "fb_fold", f"P={P} Kc={H} tail", lambda: fb.fold_tail(*pts),
            lambda: fb.fold_tail_plain(*pts))
    two = tuple(t[:, :64].contiguous() for t in pts)
    compare(errs, "fb_fold", f"P={P} Kc=64 w=2", lambda: fb.fb_fold(*two, 2),
            lambda: fb.fb_fold_plain(*two, 2))
    got = tbl.msm_mont(sc)
    if got != [host_msm(tbl.points, row) for row in rows] or got[0] is None:
        raise AssertionError("msm_mont (n = 256, P = 3) disagrees with the host Pippenger")
    log(f"fixed-base query n={n} P={P}: kernels == plain, msm_mont == host Pippenger")


def check_table_rows(tbl, rng) -> int:
    """64 seeded (w, i, d) rows of the table and the 8 corner rows (w, i, d
    each at its minimum or maximum) against host d * 2^(c*w) * P_i."""
    from uzkge_tpu_torch.curve.bn254 import g1_mul
    from uzkge_tpu_torch.ff.field import fq

    n, W, D, c = tbl.n, tbl.W, tbl.D, tbl.c
    picks = [(rng.randrange(W), rng.randrange(n), rng.randrange(1, D + 1)) for _ in range(64)]
    picks += [(w, i, d) for w in (0, W - 1) for i in (0, n - 1) for d in (1, D)]
    leaf = torch.tensor([w * n + i for w, i, _ in picks], device=tbl.table.device)
    digit = torch.tensor([d - 1 for _, _, d in picks], device=tbl.table.device)
    rows = tbl.table[leaf, digit].cpu()
    for (w, i, dd), row in zip(picks, rows):
        got = (fq.from_mont_limbs(row[:8]), fq.from_mont_limbs(row[8:]))
        if got != g1_mul(tbl.points[i], dd << (c * w)):
            raise AssertionError(f"fixed-base table row (w={w}, i={i}, d={dd}) is wrong")
    return len(picks)


def fixed_base_path(dev, rng):
    """The fixed-base path: a fresh KZG.lagrange_fb_table() over the 52-card
    Lagrange basis, with the launch counts set to 0 just before it.  The
    proof's KZG built its table at set-up; that table is dropped first (the
    KZG's cache of it cleared, the allocator's cache emptied), so that
    "before" is what the rest of the run holds and the peak is this build's
    own; the new table then serves the query measurements."""
    from uzkge_tpu_torch import kernels
    from uzkge_tpu_torch.gen_params import load_srs

    kzg = load_srs(16384, dev)
    kzg._lagrange_fb = None
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    tbl = kzg.lagrange_fb_table()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches = {k: kernels.LAUNCHES[k] for k in FB_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    t = tbl.table
    log(f"lagrange_fb_table: n={tbl.n} c={tbl.c} W={tbl.W} D={tbl.D}, table {tuple(t.shape)} = "
        f"{t.numel() * 4} B, build {build_s:.4f} s; device memory before {before} B, "
        f"peak during the build {peak} B")
    log("fixed-base launches: " + json.dumps(launches))
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"the table build launched no {missing}")
    log(f"fixed-base table: {check_table_rows(tbl, rng)} sampled rows == host bn254 multiples")
    profile_table_build(tbl, dev)
    torch.cuda.empty_cache()
    return tbl, launches


def check_fixed_base_full(dev, tbl, rate, errs):
    """Each fixed-base kernel at the shapes of tbl's build (phase 5: n =
    16384, W = 32, K = 524288, CH = 16; phase 7: n = 8192, K = 262144)
    against its plain version, timed beside it; the build's launches are
    already counted, so these are not."""
    from uzkge_tpu_torch.ff.cuda_field import fp_mont_mul, fp_mont_mul_plain
    from uzkge_tpu_torch.ff.field import fq, fr
    from uzkge_tpu_torch.msm import fixed_base as fb

    n, W, c = tbl.n, tbl.W, tbl.c
    K, CH = W * n, min(16, tbl.D)
    N = CH * K
    x, y = fq_rows(tbl.points, dev)
    res = {}
    shape = f"n={n} W={W} c={c}"
    B, ms, pms = compare(errs, "fb_bases", shape, lambda: fb.fb_bases(x, y, W, c),
                         lambda: fb.fb_bases_plain(x, y, W, c))
    res["fb_bases"] = {"ms": ms, "plain_ms": pms, "shape": shape,
                       **bound(64 * n + 96 * K, DBL_PRODUCTS * n * (W - 1) * c, rate)}
    zinv = fb.fq_batch_inv(B[2])
    bax, bay = fp_mont_mul(fq, B[0], zinv), fp_mont_mul(fq, B[1], zinv)
    one = fq.const(1, dev).expand(K, 8).contiguous()
    shape = f"K={K} CH={CH}"
    E, ms, pms = compare(errs, "fb_mult_chunk", shape,
                         lambda: fb.fb_mult_chunk(bax, bay, one, bax, bay, CH),
                         lambda: fb.fb_mult_chunk_plain(bax, bay, one, bax, bay, CH))
    res["fb_mult_chunk"] = {"ms": ms, "plain_ms": pms, "shape": shape,
                            **bound(5 * 32 * K + 96 * K * (CH + 1), MADD_PRODUCTS * K * CH, rate)}
    EX, EZ = E[0].view(N, 8), E[2].view(N, 8)
    shape = f"N={N}"
    (zinv,), ms, pms = compare(errs, "fq_batch_inv", shape, lambda: fb.fq_batch_inv(EZ),
                               lambda: fb.fq_batch_inv_plain(EZ))
    res["fq_batch_inv"] = {"ms": ms, "plain_ms": pms, "shape": shape,
                           **bound(64 * N, batch_inv_products(N), rate)}
    shape = f"Fq N={N}"
    _, ms, pms = compare(errs, "fp_mont_mul", shape, lambda: fp_mont_mul(fq, EX, zinv),
                         lambda: fp_mont_mul_plain(fq, EX, zinv))
    res["fp_mont_mul"] = {"ms": ms, "plain_ms": pms, "shape": shape, **bound(96 * N, N, rate)}
    a, b = random_fr(N, dev), random_fr(N, dev)
    compare(errs, "fp_mont_mul", f"Fr N={N}", lambda: fp_mont_mul(fr, a, b),
            lambda: fp_mont_mul_plain(fr, a, b))
    for name in FB_KERNELS:
        res[name]["max_abs_err"] = errs[name]
    return res


def device_profile(fn, warm=None):
    """fn() once under torch.profiler.  Returns the wall seconds of fn
    (profiler on), the device-side events (kernels, memcpys, memsets) and the
    busy seconds, the union of their intervals, so that an operator and the
    kernel it launched count once; None for the events and busy time when
    the profiler recorded no device event.  A one-element kernel and a pause
    come first, outside the wall (its microseconds count as busy): in one
    run on the card, a profile taken after an earlier one in the same
    process lost its first few device events.  Given `warm`, warm() runs
    first under the profiler, then a spin kernel as a marker, and only the
    events that start after the marker are kept: in the smoke run the
    profiled table build, whose device work starts at once, lost its first
    ~10 ms of events (fb_bases never showed), which a standalone run of the
    same build did not."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        if warm is not None:
            warm()
            torch.cuda.synchronize()
            torch.cuda._sleep(1_000_000)  # the marker, ~0.5 ms
            torch.cuda.synchronize()
        time.sleep(0.1)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [(ev.time_range.start, ev.time_range.end, ev.name) for ev in prof.events()
              if ev.device_type == DeviceType.CUDA
              and not getattr(ev, "is_user_annotation", False)]
    if warm is not None:
        marks = [hi for _, hi, name in events if "spin_kernel" in name]
        if not marks:
            return wall, None, None
        events = [e for e in events if e[0] >= marks[-1]]
    if not events:
        return wall, None, None
    busy_us, end = 0.0, float("-inf")
    for lo, hi, _ in sorted(events):
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    return wall, events, busy_us / 1e6


def port_kernel_names():
    """The __global__ functions of uzkge_tpu_torch/csrc/*.cu."""
    import glob
    import re

    names = set()
    for path in glob.glob(os.path.join(ROOT, "uzkge_tpu_torch", "csrc", "*.cu")):
        with open(path) as f:
            names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
                                    f.read()))
    return sorted(names)


def log_port_kernels(events):
    """Summed device time, count and device time per launch of every kernel
    of csrc/ among the events, by name, those that never ran included;
    returns {name: (ms, count)}."""
    import re

    names = port_kernel_names()
    sums = {k: [0.0, 0] for k in names}
    for lo, hi, name in events:
        for k in names:
            if re.search(rf"\b{k}\b", name):
                sums[k][0] += hi - lo
                sums[k][1] += 1
    for k in names:
        ms, count = sums[k][0] / 1e3, sums[k][1]
        per = f"{ms / count:.4f} ms a launch" if count else "not launched"
        log(f"  port kernel {k:30s} device {ms:10.4f} ms  x{count:<4d} {per}")
    return {k: (us / 1e3, count) for k, (us, count) in sums.items()}


def log_device_time(events, top: int):
    """The `top` names of device events by summed time."""
    by_name = {}
    for lo, hi, name in events:
        us, count = by_name.get(name, (0.0, 0))
        by_name[name] = (us + hi - lo, count + 1)
    rows = sorted(((us, c, name) for name, (us, c) in by_name.items()), reverse=True)
    for us, count, name in rows[:top]:
        log(f"  device {us / 1e3:10.3f} ms  x{count:<6d} {name[:90]}")


def profile_prove(seed, pp, kzg, joint, deck, latency, name):
    """One more 52-card proof through `kzg` (the route `name`) under
    torch.profiler (profile_fn)."""
    from uzkge_tpu_torch.shuffle import app

    rng = random.Random(seed + 1)
    return profile_fn(lambda: app.prove_shuffle(rng, joint, deck, pp, kzg), latency,
                      f"prove52 ({name})")


def profile_fn(fn, latency, label):
    """fn(), one proof, under torch.profiler.  The idle share is taken
    against the profiled proof's wall time (profiler on); busy time over the
    unprofiled latency is printed beside it.  Returns log_port_kernels'
    sums, or {} when the profiler recorded no device event."""
    wall, events, busy_s = device_profile(fn)
    if events is None:
        log(f"profiled {label}: the profiler recorded no device events (busy time not measured)")
        return {}
    log(f"profiled {label}: wall {wall:.3f} s (profiler on), {len(events)} device "
        f"events, device busy {busy_s:.4f} s, idle share of the profiled wall "
        f"{1 - busy_s / wall:.4f}; busy / unprofiled latency {busy_s / latency:.4f}")
    log_device_time(events, 15)
    return log_port_kernels(events)


BUILD_EVENT_NAMES = {"fp_mont_mul": "mont_mul", "fb_bases": "fb_bases",
                     "fb_mult_chunk": "fb_mult_chunk", "fq_batch_inv": "fq_inv_"}


def profile_table_build(tbl, dev):
    """A second build of the same table under torch.profiler: the device
    time of the four kernels apart from the rest (the strided copies of each
    chunk into the table, fills, host-to-device copies) and the host's
    share of the wall.  A third build runs first under the profiler and is
    dropped (device_profile's warm).  Returns {wrapper: (device ms, kernel
    launches)} for the four wrappers, (None, count) for one whose kernel
    count in the profile differs from its launches (fq_batch_inv: one
    fq_inv_root_kernel a call), or {} when the profiler recorded no device
    event."""
    from uzkge_tpu_torch import kernels
    from uzkge_tpu_torch.msm.fixed_base import FixedBaseTable

    def build():
        FixedBaseTable(tbl.points, c=tbl.c, bits=tbl.bits, device=dev)

    before = dict(kernels.LAUNCHES)
    wall, events, busy_s = device_profile(build, warm=build)
    if events is None:
        log(f"profiled table build (n={tbl.n}): the profiler recorded no device events "
            "(not measured)")
        return {}
    launched = {k: (kernels.LAUNCHES[k] - before.get(k, 0)) // 2 for k in BUILD_EVENT_NAMES}
    per = {}
    for k, sub in BUILD_EVENT_NAMES.items():
        ms = sum(hi - lo for lo, hi, name in events if sub in name) / 1e3
        count = sum(sub in name for _, _, name in events)
        seen = (sum("fq_inv_root" in name for _, _, name in events) if k == "fq_batch_inv"
                else count)
        if seen != launched[k]:
            log(f"profiled table build (n={tbl.n}): {k} shows {seen} kernels for "
                f"{launched[k]} launches: its device time not measured")
            ms = None
        per[k] = (ms, count)
    kern_ms = sum(hi - lo for lo, hi, name in events
                  if any(sub in name for sub in BUILD_EVENT_NAMES.values())) / 1e3
    other_ms = sum(hi - lo for lo, hi, name in events) / 1e3 - kern_ms
    log(f"profiled table build (n={tbl.n}): wall {wall:.4f} s (profiler on), {len(events)} "
        f"device events, device busy {busy_s:.4f} s: the four kernels {kern_ms / 1e3:.4f} s, "
        f"other device events {other_ms / 1e3:.4f} s; not busy {wall - busy_s:.4f} s")
    log("  the four kernels' device ms and launches in the build: " + json.dumps(per))
    log_device_time(events, 10)
    return per


def prove_timed(app, rng, joint, deck, pp, kzg, name):
    """One prove_shuffle (run_timed); returns (proof, outputs, latency s,
    launches, stages)."""
    (proof, outputs), latency, launches, stages = run_timed(
        lambda: app.prove_shuffle(rng, joint, deck, pp, kzg), f"prove52 ({name})")
    return proof, outputs, latency, launches, stages


def run_timed(fn, label):
    """fn(), one proof, with the stage timer and the launch counts set to 0
    just before it; returns (its result, latency s, launches, stages)."""
    from uzkge_tpu_torch import kernels
    from uzkge_tpu_torch.utils import stagetimer

    stagetimer.reset()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    latency = time.perf_counter() - t0
    launches, stages = dict(kernels.LAUNCHES), stagetimer.snapshot()
    log(f"{label} latency: {latency:.3f} s")
    log(f"stage breakdown ({label}, s): " + json.dumps(stages))
    log(f"launches ({label}): " + json.dumps(launches))
    return out, latency, launches, stages


def check_digest(blob, golden, name):
    digest = hashlib.sha256(blob).hexdigest()
    if digest != golden["sha256"]:
        raise AssertionError(f"proof sha256 ({name}) {digest} != golden {golden['sha256']}")
    log(f"proof sha256 ({name}) {digest} == golden (JAX package, same seeds)")


def main_path(dev, golden):
    """The seeded 52-card proof, on the fixed-base route (the card's
    default), then again on the same prover params through a fixed_base=False
    KZG; `golden` is its record in torch_golden.json (the seed the JAX
    package used and its proof's sha256).  Returns the launches of the
    fixed-base proof and of the variable-base proof, and what group_proof
    needs to repeat the proof (prover params, table, rng state, stages)."""
    from uzkge_tpu_torch import kernels
    from uzkge_tpu_torch.gen_params import load_srs
    from uzkge_tpu_torch.plonk.indexer import refresh_prover_params_public_key
    from uzkge_tpu_torch.plonk.proof_io import proof_from_bytes_be, proof_to_bytes_be
    from uzkge_tpu_torch.shuffle import app

    n_cards, seed = 52, golden["seed"]
    kernels.reset_launches()
    t0 = time.perf_counter()
    pp, cs, kzg = app.gen_shuffle_prover_params(n_cards, dev)
    rng = random.Random(seed)
    joint, deck = app.seeded_game(rng, n_cards)
    refresh_prover_params_public_key(pp, cs, kzg, joint)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup = {k: kernels.LAUNCHES[k] for k in SETUP_KERNELS + ("fb_select",)}
    log(f"prover params (n = {pp.n}, m = {pp.m}) and key refresh: {setup_s:.3f} s; "
        f"set-up launches {json.dumps(setup)}")
    if not kzg.uses_fixed_base() or min(setup.values()) <= 0:
        raise AssertionError("the set-up did not build the fixed-base table and commit through it")
    state = rng.getstate()

    with NttShapes() as shapes:
        proof, outputs, latency, launches, stages = prove_timed(app, rng, joint, deck, pp, kzg,
                                                                "fixed-base")
    log("ntt_pass shapes of the proof (OUT, S, IN, pre, post, const): launches " +
        json.dumps({str(k): v for k, v in sorted(shapes.counts.items())}))
    missing = [k for k in PROOF_KERNELS if launches[k] <= 0]
    if missing or kzg._lagrange_vb is not None:
        raise AssertionError(f"the fixed-base proof launched no {missing} or used the Pippenger")
    blob = proof_to_bytes_be(proof)
    check_digest(blob, golden, "fixed-base")
    proof2 = proof_from_bytes_be(blob)
    if len(blob) != 1632 or not app.verify_shuffle(pp.verifier_params, kzg, deck, outputs, proof2):
        raise AssertionError("the port's verifier rejects the proof")
    bad = list(outputs)
    bad[0], bad[1] = bad[1], bad[0]
    if app.verify_shuffle(pp.verifier_params, kzg, deck, bad, proof2):
        raise AssertionError("the verifier accepts a tampered public input")
    log("verifier: proof accepted, tampered deck rejected")
    profile = profile_prove(seed, pp, kzg, joint, deck, latency, "fixed-base")

    kzg_vb = load_srs(pp.n, dev, fixed_base=False)
    kzg_vb.commit_evals(torch.zeros((pp.n, 8), dtype=torch.int32, device=dev))  # its bases
    rng_vb = random.Random()
    rng_vb.setstate(state)
    proof_vb, _, latency_vb, launches_vb, stages_vb = prove_timed(app, rng_vb, joint, deck, pp,
                                                                  kzg_vb, "variable-base")
    check_digest(proof_to_bytes_be(proof_vb), golden, "variable-base")
    missing = [k for k in VB_KERNELS if launches_vb[k] <= 0]
    if missing or launches_vb["fb_select"]:
        raise AssertionError(f"the variable-base proof launched no {missing} or used the table")
    profile_vb = profile_prove(seed, pp, kzg_vb, joint, deck, latency_vb, "variable-base")
    log(f"{'stage (s)':24s} {'fixed-base':>12s} {'variable-base':>14s}")
    for name in ("latency",) + STAGES:
        a, b = (latency, latency_vb) if name == "latency" else (stages[name], stages_vb[name])
        log(f"{name:24s} {a:12.4f} {b:14.4f}")
    ctx = {"pp": pp, "cs": cs, "kzg": kzg, "joint": joint, "deck": deck, "state": state,
           "latency": latency, "outputs": outputs,
           "seed": seed, "stages": stages, "ntt_shapes": shapes.counts, "profile": profile,
           "profile_vb": profile_vb}
    return launches, launches_vb, ctx


def storages(pp) -> set:
    """The device storages of a ProverParams' tensors."""
    return {v.untyped_storage().data_ptr() for v in vars(pp).values()
            if isinstance(v, torch.Tensor)}


def batch_path(dev, golden, ctx):
    """Phase 4b, the proof batch (parallel/batch.py) on phase 4's prover
    params, table, joint key and rng state: three proofs on two worker
    threads of the one card; then one proof through a replica of the params
    made by replicate(), with its own table.  Returns the batch's launches."""
    from uzkge_tpu_torch import kernels
    from uzkge_tpu_torch.parallel.batch import prove_shuffle_batch, replicate
    from uzkge_tpu_torch.plonk.proof_io import proof_to_bytes_be
    from uzkge_tpu_torch.shuffle import app

    pp, kzg, joint, deck, outputs = (ctx[k] for k in ("pp", "kzg", "joint", "deck", "outputs"))
    rng_a, rng_c = random.Random(), random.Random()
    rng_a.setstate(ctx["state"])
    rng_c.setstate(ctx["state"])
    rng_b = random.Random(ctx["seed"] + 1)  # the next player reshuffles phase 4's output deck
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = prove_shuffle_batch([rng_a, rng_b, rng_c], joint, [deck, outputs, deck], pp, kzg,
                              devices=[dev, dev])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    missing = [k for k in PROOF_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the batch launched no {missing}")
    log(f"prove_shuffle_batch: 3 proofs on 2 worker threads of {torch.cuda.get_device_name(dev)} "
        f"in {wall:.3f} s, against 3 x phase 4's latency {3 * ctx['latency']:.3f} s (a record, "
        f"not a claim); launches {json.dumps(launches)}")
    check_digest(proof_to_bytes_be(got[0][0]), golden, "batch, rng_a on thread 1")
    check_digest(proof_to_bytes_be(got[2][0]), golden, "batch, rng_c on thread 1")
    proof_b, out_b = got[1]
    vk = pp.verifier_params
    if not app.verify_shuffle(vk, kzg, outputs, out_b, proof_b):
        raise AssertionError("the verifier rejects the batch's reshuffle proof")
    bad = list(out_b)
    bad[0], bad[1] = bad[1], bad[0]
    if app.verify_shuffle(vk, kzg, outputs, bad, proof_b):
        raise AssertionError("the verifier accepts the reshuffle proof with two outputs swapped")
    log("batch: the reshuffle of phase 4's outputs (rng seed + 1, thread 2) accepted, two of its "
        "outputs swapped rejected")
    del got, proof_b, out_b, bad

    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    pp_r, kzg_r = replicate(pp, kzg, dev)
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    shared = storages(pp_r) & storages(pp)
    if shared or pp_r is pp or kzg_r is kzg or kzg_r._lagrange_fb is not None:
        raise AssertionError(f"replicate shares {len(shared)} storages with pp, or its KZG")
    t0 = time.perf_counter()
    tbl_r = kzg_r.lagrange_fb_table()
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    built = {k: kernels.LAUNCHES[k] for k in SETUP_KERNELS}
    if min(built.values()) <= 0 or tbl_r is kzg.lagrange_fb_table():
        raise AssertionError(f"the replica built no table of its own: {built}")
    peak = torch.cuda.max_memory_allocated()
    rng_r = random.Random()
    rng_r.setstate(ctx["state"])
    t0 = time.perf_counter()
    proof_r, _ = app.prove_shuffle(rng_r, joint, deck, pp_r, kzg_r)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    log(f"replicate(pp, kzg, {dev}): the key's {len(storages(pp_r))} tensors copied in "
        f"{copy_s:.3f} s, none sharing storage with pp; its own table built in {table_s:.3f} s "
        f"(launches {json.dumps(built)}; device memory before {before} B, peak {peak} B); "
        f"its proof {prove_s:.3f} s")
    check_digest(proof_to_bytes_be(proof_r), golden, "replica")
    del pp_r, kzg_r, tbl_r, proof_r
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def check_query_full(dev, tbl, rate, errs, rng):
    """The query at r1_commit's batch: P = 8 MSMs over the n = 16384 table
    (K = 524,288 leaves each), every kernel at every level against its plain
    version on the same inputs, timed beside it; per kernel the times, bytes
    and products summed over the query's levels.  Then the whole query, timed,
    against the variable-base Pippenger on the same scalars."""
    from uzkge_tpu_torch import kernels
    from uzkge_tpu_torch.ff.cuda_field import fp_mont_mul, fp_mont_mul_plain
    from uzkge_tpu_torch.ff.field import fr
    from uzkge_tpu_torch.msm import fixed_base as fb
    from uzkge_tpu_torch.msm import msm as M

    P, n = 8, tbl.n
    K = tbl.W * n
    sums = {}

    def add(name, ms, pms, nbytes, products, shape):
        s = sums.setdefault(name, {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "products": 0,
                                   "shape": []})
        s["ms"] += ms
        s["plain_ms"] += pms
        s["bytes"] += nbytes
        s["products"] += products
        s["shape"].append(shape)

    sc = random_fr(P * n, dev).view(P, n, 8)  # canonical values: valid Montgomery forms
    flat = sc.view(P * n, 8)
    one = fr.const_raw(1, dev).expand(P * n, 8).contiguous()
    shape = f"Fr N={P * n}"
    _, ms, pms = compare(errs, "fp_mont_mul", shape, lambda: fp_mont_mul(fr, flat, one),
                         lambda: fp_mont_mul_plain(fr, flat, one))
    add("fp_mont_mul", ms, pms, 96 * P * n, P * n, shape)
    d = fb.scalars_to_digits(sc, tbl.c, tbl.bits).transpose(1, 2).reshape(P, K).contiguous()
    shape = f"P={P} K={K}"
    (x, y, inf), ms, pms = compare(errs, "fb_select", shape, lambda: fb.fb_select(d, tbl.table),
                                   lambda: fb.fb_select_plain(d, tbl.table))
    add("fb_select", ms, pms, P * K * (4 + 64 + 64 + 4), 0, shape)
    leaf = torch.arange(K, device=dev)[None, :]
    row = (d.abs() - 1).clamp(min=0)
    lib_ms, rows = cuda_ms(lambda: tbl.table[leaf, row])
    if not torch.equal(rows[..., :8], x):
        raise AssertionError("PyTorch's gather of the rows disagrees with fb_select's x")
    log(f"fb_select library: table[k, |d| - 1] by advanced indexing {lib_ms:.4f} ms")
    del rows
    Kc, inv_launches = K, []
    for _ in range(fb.AFFINE_LEVELS):
        H = Kc // 2
        shape = f"P={P} H={H}"
        (den, flags), ms, pms = compare(errs, "fb_pair_den", shape,
                                        lambda: fb.fb_pair_den(x, inf),
                                        lambda: fb.fb_pair_den_plain(x, inf))
        add("fb_pair_den", ms, pms, P * Kc * 36 + P * H * 36, 0, shape)
        dflat = den.view(P * H, 8)
        (dinv,), ms, pms = compare(errs, "fq_batch_inv", f"N={P * H}",
                                   lambda: fb.fq_batch_inv(dflat),
                                   lambda: fb.fq_batch_inv_plain(dflat))
        add("fq_batch_inv", ms, pms, 64 * P * H, batch_inv_products(P * H), f"N={P * H}")
        inv_launches.append(cuda_launches(lambda: fb.fq_batch_inv(dflat), "fq_inv_"))
        dinv = dinv.view(P, H, 8)
        (x, y, inf), ms, pms = compare(errs, "fb_pair_combine", shape,
                                       lambda: fb.fb_pair_combine(x, y, dinv, flags),
                                       lambda: fb.fb_pair_combine_plain(x, y, dinv, flags))
        add("fb_pair_combine", ms, pms, combine_bytes(P, H), 3 * P * H, shape)
        b = bound(combine_bytes(P, H), 3 * P * H, rate)
        log(f"  fb_pair_combine level P={P} H={H}: {ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']}), {b['bound_ms'] / ms:.4f} of it")
        Kc = H
    proj = pts = fb.to_projective(x, y, inf)
    tiles = fb.fold_tiles(Kc)
    for w in tiles:  # each launch alone
        pts = compare(errs, "fb_fold", f"P={P} Kc={pts[0].shape[1]} w={w} (one launch)",
                      lambda: fb.fb_fold(*pts, w), lambda: fb.fb_fold_plain(*pts, w))[0]
    shape = f"P={P} Kc={Kc} tail ({len(tiles)} launches)"
    tail, ms, pms = compare(errs, "fb_fold", shape, lambda: fb.fold_tail(*proj),
                            lambda: fb.fold_tail_plain(*proj))
    if not all(torch.equal(a[:, 0], b) for a, b in zip(pts, tail)):
        raise AssertionError("fb_fold launch by launch disagrees with fold_tail")
    # Kc - 1 additions per MSM; the tail's input read and its sums written once
    add("fb_fold", ms, pms, 96 * P * (Kc + 1), PADD_PRODUCTS * P * (Kc - 1), shape)

    before = kernels.LAUNCHES["fb_fold"]
    tbl.query(sc)
    per_query = kernels.LAUNCHES["fb_fold"] - before
    query_ms, (X, Y, Z) = cuda_ms(lambda: tbl.query(sc), reps=3)
    log(f"CUDA launches per P={P} query: fb_fold {per_query}; fq_batch_inv {inv_launches} "
        f"(its levels, N = {[P * (K >> (l + 1)) for l in range(fb.AFFINE_LEVELS)]}; "
        f"counted by kernels.CALLS)")
    if per_query > 2 or max(inv_launches) > 3:
        raise AssertionError("the query takes more than 2 fb_fold or 3 fq_batch_inv launches")
    got = tbl.msm_mont(sc)
    bases = M.MSMBases(tbl.points, dev)
    if got != M.msm(bases, sc) or None in got:
        raise AssertionError("the fixed-base query disagrees with the Pippenger (P = 8, dense)")
    if fb._extract_host(*tail) != got:
        raise AssertionError("the query's kernels, level by level, disagree with msm_mont")
    log(f"fixed-base query P={P} n={n} K={K}: {query_ms:.4f} ms on the card (digits, select, "
        f"levels, folds; mean of 3), points == the variable-base Pippenger's")
    res = {}
    for name, s in sums.items():
        res[name] = {"ms": s["ms"], "plain_ms": s["plain_ms"], "shape": "; ".join(s["shape"]),
                     "max_abs_err": errs[name], **bound(s["bytes"], s["products"], rate)}
        log(f"{name} per query: kernel {s['ms']:.4f} ms, plain {s['plain_ms']:.4f} ms, "
            f"bound {res[name]['bound_ms']:.4f} ms ({res[name]['bound_by']})")
    res["fb_select"]["library_ms"] = lib_ms
    return res, query_ms


def combine_bytes(P: int, H: int) -> int:
    """fb_pair_combine's bytes at a level: x and y of 2H points per MSM read,
    dinv and the flags read, xo, yo and the identity flags written."""
    return P * 2 * H * 64 + P * H * (32 + 4 + 64 + 4)


def check_query_batches(dev, tbl, errs, rate):
    """fq_batch_inv, fb_pair_combine and fb_fold at the proof's other batches
    (P = 1, 5, 2: r2_commit, r3_t_split_commit, r5_openings) on the levels of
    a query of random scalars, each against its plain version (fq_batch_inv
    by inverse_checked), timed (mean of 3); the points against msm_mont's.
    Returns {P: {kernel: ms per query}}, fb_pair_combine's bound per query
    beside it."""
    from uzkge_tpu_torch.msm import fixed_base as fb

    out = {}
    for P in (1, 5, 2):
        sc = random_fr(P * tbl.n, dev).view(P, tbl.n, 8)
        d = fb.scalars_to_digits(sc, tbl.c, tbl.bits).transpose(1, 2).reshape(P, -1).contiguous()
        x, y, inf = fb.fb_select(d, tbl.table)
        inv_ms = comb_ms = comb_bound = 0.0
        for _ in range(fb.AFFINE_LEVELS):
            den, flags = fb.fb_pair_den(x, inf)
            flat = den.view(-1, 8)
            dinv, ms = inverse_checked(f"P={P} N={flat.shape[0]}", flat)
            inv_ms += ms
            dinv, H = dinv.view(den.shape), den.shape[1]
            (x, y, inf), ms, _ = compare(errs, "fb_pair_combine", f"P={P} H={H}",
                                         lambda: fb.fb_pair_combine(x, y, dinv, flags),
                                         lambda: fb.fb_pair_combine_plain(x, y, dinv, flags))
            b = bound(combine_bytes(P, H), 3 * P * H, rate)["bound_ms"]
            log(f"  fb_pair_combine level P={P} H={H}: {ms:.4f} ms, bound {b:.4f} ms, "
                f"{b / ms:.4f} of it")
            comb_ms += ms
            comb_bound += b
        pts = fb.to_projective(x, y, inf)
        tail, fold_ms, _ = compare(errs, "fb_fold", f"P={P} Kc={x.shape[1]} tail",
                                   lambda: fb.fold_tail(*pts), lambda: fb.fold_tail_plain(*pts))
        if fb._extract_host(*tail) != tbl.msm_mont(sc):
            raise AssertionError(f"the query's levels at P = {P} disagree with msm_mont")
        out[P] = {"fq_batch_inv": inv_ms, "fb_fold": fold_ms, "fb_pair_combine": comb_ms,
                  "fb_pair_combine_bound": comb_bound}
        log(f"query P={P}: fq_batch_inv {inv_ms:.4f} ms over its {fb.AFFINE_LEVELS} levels, "
            f"fb_pair_combine {comb_ms:.4f} ms (bound {comb_bound:.4f}), fb_fold {fold_ms:.4f} ms "
            f"over the tail")
    return out


# ------------------------------------------------------------ chain MSM

GROUP_KERNELS = ("ntt_pass", "fp_mont_mul", "fb_bases", "fq_batch_inv", "scan_leaf_reduce",
                 "scan_proj_reduce")  # the proof through a KZG on a process group
OTHER_ROUTES = ("fb_select", "msm_bucket_accumulate")


def chain_rounds(errs, x, y, sc, shape_tag, rate=None, build_plain=True):
    """msm_chain's kernels on (x, y, sc), each against its plain version on
    the same inputs and timed beside it (CUDA events, mean of 3): fb_bases
    at the chain's shape (W = 256, c = 1) alone, the chain build (fb_bases,
    fq_batch_inv, fp_mont_mul; its plain version starts from fb_bases'
    plain output, which is not computed twice), the leaf round, every
    projective round.  With build_plain False the chain is built by the
    kernels alone (the small case: the full one holds the build).  Returns
    the per-kernel rows (times, bytes and products summed over the rounds;
    bounds where `rate` is given) and the chain MSM's output (X, Y, Z)."""
    from uzkge_tpu_torch.ff.cuda_field import fp_mont_mul_plain
    from uzkge_tpu_torch.ff.field import fq
    from uzkge_tpu_torch.msm import fixed_base as fb

    P, n = sc.shape[:2]
    W = 128  # msm_chain's windows: c = 2, bits = 256
    K = W * n

    plain_bases = {}

    def bases_plain():
        plain_bases["B"] = fb.fb_bases_plain(x, y, 2 * W, 1)
        return plain_bases["B"]

    def chain_plain():
        BX, BY, BZ = plain_bases.pop("B")
        zinv = fb.fq_batch_inv_plain(BZ)
        return fp_mont_mul_plain(fq, BX, zinv), fp_mont_mul_plain(fq, BY, zinv)

    shape = f"n={n} W={2 * W} c=1"
    res = {}
    if build_plain:
        _, ms, bpms = compare(errs, "fb_bases_chain", shape, lambda: fb.fb_bases(x, y, 2 * W, 1),
                              bases_plain)
        # the chain build's doublings (counted as RCB Alg. 9's); the points read, the rows written
        res["fb_bases_chain"] = {"ms": ms, "plain_ms": bpms, "shape": shape,
                                 "bytes": 64 * n + 96 * 2 * W * n,
                                 "products": DBL_PRODUCTS * n * (2 * W - 1)}
        (ax, ay), ms, pms = compare(errs, "chain", f"{shape_tag} {shape}",
                                    lambda: fb.build_bases(x, y, 2 * W, 1), chain_plain)
        log(f"chain build (fb_bases, fq_batch_inv, fp_mont_mul) n={n}: {ms:.4f} ms, plain "
            f"{bpms + pms:.4f} ms (fb_bases' {bpms:.4f} ms of it timed in the row above)")
    else:
        ax, ay = fb.build_bases(x, y, 2 * W, 1)
    d = fb.scalars_to_digits(sc, 2, 256).transpose(1, 2).reshape(P, K).contiguous()
    S = fb.pick_s(K)
    shape = f"P={P} K={K} S={S}"
    (X, Y, Z), ms, pms = compare(errs, "scan_leaf_reduce", shape,
                                 lambda: fb.scan_leaf_reduce(ax, ay, d, n, S),
                                 lambda: fb.scan_leaf_reduce_plain(ax, ay, d, n, S))
    nz = d != 0
    rows = torch.unique(fb.chain_rows(d, n)[nz]).numel()  # chain rows the leaves need
    lanes = P * (K // S)
    # one mixed addition per nonzero leaf; its digit and its chain row read, a lane written
    res["scan_leaf_reduce"] = {"ms": ms, "plain_ms": pms, "shape": shape,
                               "bytes": 4 * P * K + 64 * rows + 96 * lanes,
                               "products": MADD_PRODUCTS * int(nz.sum())}
    proj = {"ms": 0.0, "plain_ms": 0.0, "shape": [], "bytes": 0, "products": 0}
    for S in fb.fold_tiles(K // S):  # reduce_leaves' projective rounds
        N = X.shape[0]
        shape = f"N={N} S={S}"
        (X, Y, Z), ms, pms = compare(errs, "scan_proj_reduce", shape,
                                     lambda: fb.scan_proj_reduce(X, Y, Z, S),
                                     lambda: fb.scan_proj_reduce_plain(X, Y, Z, S))
        proj["ms"] += ms
        proj["plain_ms"] += pms
        proj["shape"].append(shape)
        proj["bytes"] += 96 * (N + N // S)
        proj["products"] += PADD_PRODUCTS * (N - N // S)  # S - 1 additions per output
    proj["shape"] = "; ".join(proj["shape"])
    res["scan_proj_reduce"] = proj
    if rate is not None:
        for name, r in res.items():
            r.update(bound(r.pop("bytes"), r.pop("products"), rate), max_abs_err=errs[name])
            log(f"{name} per msm_chain: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return res, (X, Y, Z)


def check_chain_small(dev, tbl, errs, rng):
    """The chain MSM's rounds at n = 256, P = 3 on the n = 256 table's points
    (the first 256 Lagrange bases), with an all-zero scalar row and a run of
    zero digits planted, each against its plain version (the chain build
    is held against its plain version at full size, check_chain_full); then
    msm_chain's points against the host Pippenger's and the fixed-base
    query's."""
    from uzkge_tpu_torch.constants.bn254 import R_MOD
    from uzkge_tpu_torch.ff.field import fr
    from uzkge_tpu_torch.msm import fixed_base as fb
    from uzkge_tpu_torch.msm.msm import host_msm

    P, n = 3, tbl.n
    rows = [[0] * n] + [[rng.randrange(R_MOD) for _ in range(n)] for _ in range(P - 1)]
    rows[1][:16] = [0] * 16  # 16 points' 128 windows: zero digits
    rows[2][0] = R_MOD - 1
    sc = fr.to_mont_limbs([v for row in rows for v in row], dev).reshape(P, n, 8)
    x, y = fq_rows(tbl.points, dev)
    _, (X, Y, Z) = chain_rounds(errs, x, y, sc, "small", build_plain=False)
    got = fb._extract_host(X, Y, Z)
    if got != fb._extract_host(*fb.msm_chain(x, y, sc)):
        raise AssertionError("msm_chain disagrees with its rounds run one by one")
    if got != [host_msm(tbl.points, r) for r in rows] or got != tbl.msm_mont(sc) or got[0] is not None:
        raise AssertionError("msm_chain (n = 256, P = 3) disagrees with the host Pippenger or the "
                             "fixed-base query")
    log(f"msm_chain n={n} P={P}: kernels == plain, points == host Pippenger == fixed-base query")


def check_chain_full(dev, tbl, rate, errs, query_ms):
    """msm_chain at r1_commit's batch (P = 8 dense rows, n = 16384): every
    round against its plain version, timed; its points against the
    fixed-base query's on the same scalars; the whole call timed beside the
    query's (`query_ms`, same scalars' shape).  Returns the kernel rows, the
    scalars and the points."""
    from uzkge_tpu_torch.msm import fixed_base as fb

    P, n = 8, tbl.n
    sc = random_fr(P * n, dev).view(P, n, 8)
    x, y = fq_rows(tbl.points, dev)
    res, (X, Y, Z) = chain_rounds(errs, x, y, sc, "full", rate)
    chain_ms, out = cuda_ms(lambda: fb.msm_chain(x, y, sc), reps=3)
    got = fb._extract_host(*out)
    if got != fb._extract_host(X, Y, Z) or got != tbl.msm_mont(sc) or None in got:
        raise AssertionError("msm_chain (n = 16384, P = 8) disagrees with the fixed-base query")
    log(f"msm_chain P={P} n={n}: {chain_ms:.4f} ms on the card (chain build, digits, rounds; "
        f"mean of 3) against the fixed-base query's {query_ms:.4f} ms; points equal")
    return res, sc, got


def check_sharded(dev, group, tbl, sc, want):
    """The sharded path on an NCCL group of world size 1: both MSM axes at n
    = 16384, P = 8 against msm_chain's points `want`; sharded_ntt_batch on
    the prover's coset batch (5 x 131072, the 52-card k1) and ShardedNTT at n
    = 2^17 (fft, ifft, coset fft / ifft) against NTTDomain; the tiny-shape
    dry run with its one-card proof."""
    from uzkge_tpu_torch.ff.field import fr
    from uzkge_tpu_torch.gen_params import load_shuffle_verifier_params
    from uzkge_tpu_torch.msm.fixed_base import _extract_host
    from uzkge_tpu_torch.ntt.ntt import NTTDomain
    from uzkge_tpu_torch.parallel import sharded as sh

    x, y = fq_rows(tbl.points, dev)
    for name, fn in (("sharded_msm_device_sums", sh.sharded_msm_device_sums),
                     ("sharded_msm_batch", sh.sharded_msm_batch)):
        ms, out = cuda_ms(lambda: fn(group, x, y, sc), reps=1)
        if _extract_host(*out) != want:
            raise AssertionError(f"{name} (world size 1) disagrees with msm_chain")
        log(f"{name} n={tbl.n} P={sc.shape[0]}: {ms:.4f} ms, points == msm_chain's")
    k1 = load_shuffle_verifier_params(52).k[1]
    m = 131072
    batch = random_fr(5 * m, dev).view(5, m, 8)
    dom = NTTDomain(m, dev)
    ms, out = cuda_ms(lambda: sh.sharded_ntt_batch(group, batch, coset_k=k1), reps=1)
    if not torch.equal(out, dom.coset_fft_batch(batch, k1)):
        raise AssertionError("sharded_ntt_batch disagrees with NTTDomain.coset_fft_batch")
    log(f"sharded_ntt_batch (5 x {m}, coset k1): {ms:.4f} ms, == NTTDomain")
    sntt, v = sh.ShardedNTT(m, group), batch[0].contiguous()
    for name, got, ref in (("fft", sntt.fft(v), dom.fft(v)), ("ifft", sntt.ifft(v), dom.ifft(v)),
                           ("coset_fft", sntt.coset_fft(v, k1), dom.coset_fft(v, k1)),
                           ("coset_ifft", sntt.coset_ifft(v, k1), dom.coset_ifft(v, k1))):
        if not torch.equal(got, ref):
            raise AssertionError(f"ShardedNTT.{name} (n = {m}) disagrees with NTTDomain")
    log(f"ShardedNTT n={m}: fft, ifft, coset fft / ifft == NTTDomain")
    t0 = time.perf_counter()
    if not sh.dryrun_multichip(group, prove=True):
        raise AssertionError("dryrun_multichip failed")
    log(f"dryrun_multichip (world size 1): sharded MSMs and NTTs == host math, a one-card "
        f"shuffle proof through a KZG on the group verifies; {time.perf_counter() - t0:.3f} s")


def group_proof(dev, group, golden, ctx):
    """This slice's main path: the seeded 52-card proof on phase 4's prover
    params through a KZG on `group` (every Lagrange commit through the
    sharded msm_chain, the batched NTTs through sharded_ntt_batch), from the
    rng state of the fixed-base proof; the same sha256, both scan kernels
    launched, the table and the Pippenger not used; then one more under the
    profiler.  Returns its launches and the profile's kernel sums."""
    from uzkge_tpu_torch.gen_params import load_srs
    from uzkge_tpu_torch.plonk.proof_io import proof_to_bytes_be
    from uzkge_tpu_torch.shuffle import app

    pp, joint, deck = ctx["pp"], ctx["joint"], ctx["deck"]
    kzg = load_srs(pp.n, dev, group=group)
    rng = random.Random()
    rng.setstate(ctx["state"])
    proof, _, latency, launches, stages = prove_timed(app, rng, joint, deck, pp, kzg, "group")
    check_digest(proof_to_bytes_be(proof), golden, "group")
    missing = [k for k in GROUP_KERNELS if launches[k] <= 0]
    if missing or any(launches[k] for k in OTHER_ROUTES) or kzg._lagrange_fb is not None:
        raise AssertionError(f"the group proof launched no {missing} or used another route")
    log(f"{'stage (s)':24s} {'fixed-base':>12s} {'group':>12s}")
    for name in ("latency",) + STAGES + ("r1_ifft", "r3_coset_ffts"):
        a, b = ((ctx["latency"], latency) if name == "latency"
                else (ctx["stages"].get(name, 0.0), stages.get(name, 0.0)))
        log(f"{name:24s} {a:12.4f} {b:12.4f}")
    return launches, profile_prove(ctx["seed"], pp, kzg, joint, deck, latency, "group")


def sharded_path(dev, golden, ctx, tbl, sc, want):
    """An NCCL process group of world size 1 over a FileStore in a temporary
    directory: check_sharded, then group_proof; the group is destroyed and
    the directory removed after.  Returns the group proof's launches and
    profile."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from uzkge_tpu_torch.parallel import start_group

    tmp = tempfile.mkdtemp(prefix="uzkge-nccl-")
    try:
        group = start_group(tmp, 0, 1, "nccl", timeout_s=300)
        log(f"NCCL group: world size 1, FileStore in the temporary directory {tmp}")
        check_sharded(dev, group, tbl, sc, want)
        return group_proof(dev, group, golden, ctx)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


# ------------------------------------------------------------ matchmaking

MM_BATCHES = (5, 1, 5, 2)  # the generic proof's commits: r1 (5 wires), r2 (z), r3 (5 t), r5


def check_mm_query(dev, tbl, errs, rate):
    """The query's kernels on the n = 8192 table at the matchmaking proof's
    batches (P = 5, 1, 2; K = 262,144 leaves an MSM), every kernel at every
    level against its plain version on the same inputs (fq_batch_inv by
    inverse_checked), timed beside it; the points against msm_mont's.
    Returns per kernel the ms (CUDA events), plain ms and bound summed over
    one proof's four queries (P = 5 twice)."""
    from uzkge_tpu_torch.ff.cuda_field import fp_mont_mul, fp_mont_mul_plain
    from uzkge_tpu_torch.ff.field import fr
    from uzkge_tpu_torch.msm import fixed_base as fb

    per_p = {}
    for P in sorted(set(MM_BATCHES)):
        sums = {}

        def add(name, ms, pms, nbytes, products):
            s = sums.setdefault(name, [0.0, 0.0, 0, 0])
            s[0] += ms
            s[1] += pms
            s[2] += nbytes
            s[3] += products

        n, K = tbl.n, tbl.W * tbl.n
        sc = random_fr(P * n, dev).view(P, n, 8)
        flat = sc.view(P * n, 8)
        one = fr.const_raw(1, dev).expand(P * n, 8).contiguous()
        _, ms, pms = compare(errs, "fp_mont_mul", f"Fr N={P * n}",
                             lambda: fp_mont_mul(fr, flat, one),
                             lambda: fp_mont_mul_plain(fr, flat, one))
        add("fp_mont_mul", ms, pms, 96 * P * n, P * n)
        d = fb.scalars_to_digits(sc, tbl.c, tbl.bits).transpose(1, 2).reshape(P, K).contiguous()
        (x, y, inf), ms, pms = compare(errs, "fb_select", f"P={P} K={K}",
                                       lambda: fb.fb_select(d, tbl.table),
                                       lambda: fb.fb_select_plain(d, tbl.table))
        add("fb_select", ms, pms, P * K * (4 + 64 + 64 + 4), 0)
        Kc = K
        for _ in range(fb.AFFINE_LEVELS):
            H = Kc // 2
            (den, flags), ms, pms = compare(errs, "fb_pair_den", f"P={P} H={H}",
                                            lambda: fb.fb_pair_den(x, inf),
                                            lambda: fb.fb_pair_den_plain(x, inf))
            add("fb_pair_den", ms, pms, P * Kc * 36 + P * H * 36, 0)
            dflat = den.view(P * H, 8)
            dinv, ms = inverse_checked(f"N={P * H}", dflat)
            add("fq_batch_inv", ms, 0.0, 64 * P * H, batch_inv_products(P * H))
            dinv = dinv.view(P, H, 8)
            (x, y, inf), ms, pms = compare(errs, "fb_pair_combine", f"P={P} H={H}",
                                           lambda: fb.fb_pair_combine(x, y, dinv, flags),
                                           lambda: fb.fb_pair_combine_plain(x, y, dinv, flags))
            add("fb_pair_combine", ms, pms, combine_bytes(P, H), 3 * P * H)
            Kc = H
        pts = fb.to_projective(x, y, inf)
        tail, ms, pms = compare(errs, "fb_fold", f"P={P} Kc={Kc} tail",
                                lambda: fb.fold_tail(*pts), lambda: fb.fold_tail_plain(*pts))
        add("fb_fold", ms, pms, 96 * P * (Kc + 1), PADD_PRODUCTS * P * (Kc - 1))
        if fb._extract_host(*tail) != tbl.msm_mont(sc):
            raise AssertionError(f"the query's levels at n = {n}, P = {P} disagree with msm_mont")
        per_p[P] = sums
    res = {}
    for name in ("fp_mont_mul", "fb_select", "fb_pair_den", "fq_batch_inv", "fb_pair_combine",
                 "fb_fold"):
        ms = sum(per_p[P][name][0] for P in MM_BATCHES)
        pms = None if name == "fq_batch_inv" else sum(per_p[P][name][1] for P in MM_BATCHES)
        b = bound(sum(per_p[P][name][2] for P in MM_BATCHES),
                  sum(per_p[P][name][3] for P in MM_BATCHES), rate)
        res[name] = {"mm_events_ms": ms, "mm_plain_ms": pms, "mm_bound_ms": b["bound_ms"],
                     "mm_bound_by": b["bound_by"]}
        plain = "not run (inverse_checked)" if pms is None else f"{pms:.4f} ms"
        log(f"{name} per matchmaking proof (queries at P = 5, 1, 5, 2, n = {tbl.n}): kernel "
            f"{ms:.4f} ms, plain {plain}, bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    return res


def check_mm_pippenger(dev, rng, rate):
    """msm_bucket_accumulate (limb for limb, against its plain version) and
    msm_bucket_reduce at n = 8192 on dense rows at the matchmaking proof's
    batches (P = 5, 1, 2), timed; the reduce's buckets have the shape of
    phase 3's at the same P, where it was held against its plain version
    (whose times stand here), and the variable-base matchmaking proof's
    sha256 covers its output at these shapes.  Returns each kernel's ms,
    plain ms and bound summed over one proof's four batches."""
    from uzkge_tpu_torch.constants.bn254 import R_MOD
    from uzkge_tpu_torch.ff.field import fr
    from uzkge_tpu_torch.gen_params import load_srs
    from uzkge_tpu_torch.msm import msm as M

    bases = M.MSMBases(load_srs(8192, dev)._lagrange_points, dev)
    n, per_p = bases.n, {}
    for P in sorted(set(MM_BATCHES)):
        std = fr.from_mont(torch.stack([
            fr.to_mont_limbs([rng.randrange(R_MOD) for _ in range(n)], dev) for _ in range(P)]))
        L = M.pick_piece(n, P, dev)
        ms, kb = cuda_ms(lambda: M.msm_bucket_accumulate(bases.x, bases.y, std, L))
        pms, pb = cuda_ms(lambda: M.msm_bucket_accumulate_plain(bases.x, bases.y, std, L), reps=0)
        if not torch.equal(kb, pb):
            raise AssertionError(f"msm_bucket_accumulate (n={n}, P={P}, L={L}) disagrees with "
                                 "its plain version")
        rms, ks = cuda_ms(lambda: M.msm_bucket_reduce(kb))
        rpms = REDUCE_PLAIN_MS[P]
        if None in window_points(ks):
            raise AssertionError(f"msm_bucket_reduce (n={n}, P={P}): an identity window sum")
        a, r = acc_bound(std, n, rate), reduce_bound(P, kb.shape[1], rate)
        log(f"Pippenger n={n} P={P} L={L}: msm_bucket_accumulate {ms:.4f} ms (plain {pms:.4f}, "
            f"bound {a['bound_ms']:.4f}), equal to its plain version; msm_bucket_reduce "
            f"{rms:.4f} ms (plain {rpms:.4f}: phase 3's at these (P, 1, 32, 256) buckets, where "
            f"it was held against the kernel; bound {r['bound_ms']:.4f})")
        per_p[P] = {"msm_bucket_accumulate": (ms, pms, a["bound_ms"]),
                    "msm_bucket_reduce": (rms, rpms, r["bound_ms"])}
        del kb, pb, ks
    return {name: {"mm_events_ms": sum(per_p[P][name][0] for P in MM_BATCHES),
                   "mm_plain_ms": sum(per_p[P][name][1] for P in MM_BATCHES),
                   "mm_bound_ms": sum(per_p[P][name][2] for P in MM_BATCHES)}
            for name in VB_KERNELS}


def check_params_cache(dev, pp):
    """The port's params cache on the card: the matchmaking prover params
    saved to a temporary directory and loaded back (to the card, the
    default); every tensor equal and on the card, the host part and the
    verifying key equal."""
    import shutil
    import tempfile
    from dataclasses import fields

    from uzkge_tpu_torch.plonk.indexer import ProverParams
    from uzkge_tpu_torch.utils import params_cache as pc

    tmp = tempfile.mkdtemp(prefix="uzkge-pp-")
    try:
        path = os.path.join(tmp, "matchmaking-pp")
        t0 = time.perf_counter()
        pc.save_pp(path, pp)
        t1 = time.perf_counter()
        got = pc.load_pp(path, ProverParams)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if got is None:
            raise AssertionError("params cache: the saved matchmaking params did not load")
        nbytes = 0
        for f in fields(ProverParams):
            a, b = getattr(got, f.name), getattr(pp, f.name)
            if isinstance(b, torch.Tensor):
                if a.device.type != "cuda" or not torch.equal(a, b):
                    raise AssertionError(f"params cache: {f.name} differs or is not on the card")
                nbytes += a.numel() * 4
            elif a != b:
                raise AssertionError(f"params cache: {f.name} differs")
        size = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
        log(f"params cache ({pc.SCHEMA_VERSION}): matchmaking params saved in {t1 - t0:.3f} s, "
            f"loaded to the card in {t2 - t1:.3f} s; {size} B on disk, {nbytes} B of tensors, "
            "every tensor equal and on the card, host part equal")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def matchmaking_path(dev, golden, rate, errs, rng, ntt_52):
    """zmatchmaking's 50-player proof (the generic TurboPLONK shape, n = 8192,
    m = 65536) at full size: set-up (the embedded vk refused as stale, the
    circuit re-indexed, the n = 8192 table built), the seeded proof on the
    fixed-base route, verified, a tampered one rejected, its sha256 the JAX
    package's `golden`; a profiled proof; the same proof through a
    fixed_base=False KZG from the same rng state; both routes' stages; the
    kernels at the proof's new shapes; table rows; the params cache.
    Returns what the kernels line needs."""
    from uzkge_tpu_torch import kernels
    from uzkge_tpu_torch.errors import MissingVerifierParamsError
    from uzkge_tpu_torch.gen_params import load_matchmaking_verifier_params, load_srs
    from uzkge_tpu_torch.hash.anemoi import eval_variable_length_hash
    from uzkge_tpu_torch.matchmaking import app
    from uzkge_tpu_torch.plonk.cs import N_SELECTORS
    from uzkge_tpu_torch.plonk.proof_io import proof_from_bytes_be, proof_to_bytes_be

    try:
        load_matchmaking_verifier_params()
        raise AssertionError("the embedded matchmaking vk was not refused as stale")
    except MissingVerifierParamsError as e:
        log(f"embedded matchmaking vk refused: {e}")
    kernels.reset_launches()
    t0 = time.perf_counter()
    pp, cs, kzg = app.gen_matchmaking_prover_params(app.N, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup = {k: kernels.LAUNCHES[k] for k in FB_KERNELS + ("ntt_pass", "fb_select")}
    log(f"matchmaking prover params (N = {app.N}, n = {pp.n}, m = {pp.m}, circuit re-indexed, "
        f"{len(pp.verifier_params.cm_q_vec)} selector commitments): {setup_s:.3f} s; set-up "
        f"launches {json.dumps(setup)}")
    if ((pp.n, pp.m, pp.with_shuffle) != (8192, 65536, False)
            or len(pp.verifier_params.cm_q_vec) != N_SELECTORS):
        raise AssertionError("the matchmaking params are not the re-indexed generic n = 8192 ones")
    if not kzg.uses_fixed_base() or min(setup[k] for k in SETUP_KERNELS + ("fb_select",)) <= 0:
        raise AssertionError("the matchmaking set-up did not build the n = 8192 table and "
                             "commit through it")

    seed = golden["seed"]
    prng = random.Random(seed)
    inputs, committed_seed, random_number = req = app.seeded_match(prng, app.N)
    state = prng.getstate()
    label = "prove_mm50 (fixed-base)"
    with NttShapes() as shapes:
        (proof, outputs), latency, launches, stages = run_timed(
            lambda: app.prove_matchmaking(prng, *req, pp, kzg), label)
    log("ntt_pass shapes of the matchmaking proof (OUT, S, IN, pre, post, const): launches " +
        json.dumps({str(k): v for k, v in sorted(shapes.counts.items())}))
    missing = [k for k in PROOF_KERNELS if launches[k] <= 0]
    if missing or kzg._lagrange_vb is not None:
        raise AssertionError(f"the matchmaking proof launched no {missing} or used the Pippenger")
    if sorted(outputs) != sorted(inputs):
        raise AssertionError("the matchmaking outputs are not a permutation of the inputs")
    moved = sum(a != b for a, b in zip(outputs, inputs))
    blob = proof_to_bytes_be(proof, with_shuffle=False)
    check_digest(blob, golden, label)
    commitment = eval_variable_length_hash([committed_seed])
    vk, proof2 = pp.verifier_params, proof_from_bytes_be(blob, with_shuffle=False)
    if len(blob) != 1312 or not app.verify_matchmaking(vk, kzg, inputs, outputs, commitment,
                                                       random_number, proof2):
        raise AssertionError("the port's verifier rejects the matchmaking proof")
    bad = list(outputs)
    bad[0], bad[1] = bad[1], bad[0]
    if app.verify_matchmaking(vk, kzg, inputs, bad, commitment, random_number, proof2):
        raise AssertionError("the verifier accepts a matchmaking proof with two outputs swapped")
    log(f"matchmaking: outputs a permutation of the inputs ({moved} of {app.N} moved); proof "
        f"({len(blob)} B) accepted, two outputs swapped rejected")
    profile = profile_fn(lambda: app.prove_matchmaking(random.Random(seed + 1), *req, pp, kzg),
                         latency, label)

    kzg_vb = load_srs(pp.n, dev, fixed_base=False)
    kzg_vb.commit_evals(torch.zeros((pp.n, 8), dtype=torch.int32, device=dev))  # its bases
    rng_vb = random.Random()
    rng_vb.setstate(state)
    label_vb = "prove_mm50 (variable-base)"
    (proof_vb, _), latency_vb, launches_vb, stages_vb = run_timed(
        lambda: app.prove_matchmaking(rng_vb, *req, pp, kzg_vb), label_vb)
    check_digest(proof_to_bytes_be(proof_vb, with_shuffle=False), golden, label_vb)
    missing = [k for k in VB_KERNELS if launches_vb[k] <= 0]
    if missing or launches_vb["fb_select"]:
        raise AssertionError(f"the variable-base matchmaking proof launched no {missing} or used "
                             "the table")
    profile_vb = profile_fn(lambda: app.prove_matchmaking(random.Random(seed + 1), *req, pp,
                                                          kzg_vb), latency_vb, label_vb)
    log(f"{'matchmaking stage (s)':24s} {'fixed-base':>12s} {'variable-base':>14s}")
    for name in ("latency",) + tuple(sorted(set(stages) | set(stages_vb))):
        a, b = ((latency, latency_vb) if name == "latency"
                else (stages.get(name, 0.0), stages_vb.get(name, 0.0)))
        log(f"{name:24s} {a:12.4f} {b:14.4f}")

    new = {k: v for k, v in shapes.counts.items() if k not in ntt_52}
    log("ntt_pass shapes new to the matchmaking proof (not in the 52-card proof): " +
        json.dumps({str(k): v for k, v in sorted(new.items())}))
    ntt = time_ntt_shapes(dev, shapes.counts, rate, errs)
    tbl = kzg.lagrange_fb_table()
    log(f"matchmaking table (n={tbl.n} c={tbl.c} W={tbl.W} D={tbl.D}, {tbl.table.numel() * 4} B): "
        f"{check_table_rows(tbl, rng)} sampled rows == host bn254 multiples")
    build = check_fixed_base_full(dev, tbl, rate, errs)
    build_prof = profile_table_build(tbl, dev)
    for name in FB_KERNELS:
        # fb_bases and fb_mult_chunk run on matchmaking's path only here, so
        # their mm_* fields are the build's; the other two keep the query's
        pre = "mm_" if name in SETUP_KERNELS else "mm_setup_"
        b = build[name]
        build[name] = {f"{pre}events_ms": b["ms"], f"{pre}plain_ms": b["plain_ms"],
                       f"{pre}bound_ms": b["bound_ms"], f"{pre}bound_by": b["bound_by"],
                       f"{pre}shape": b["shape"],
                       "mm_setup_ms": build_prof[name][0] if build_prof else None,
                       "mm_setup_profiled_launches": build_prof[name][1] if build_prof else None}
    query = check_mm_query(dev, tbl, errs, rate)
    vb = check_mm_pippenger(dev, rng, rate)
    check_params_cache(dev, pp)
    query["ntt_pass"] = {"mm_events_ms": ntt["ms"], "mm_plain_ms": ntt["plain_ms"],
                         "mm_bound_ms": ntt["bound_ms"]}
    query.update(vb)
    for name, res in build.items():
        query.setdefault(name, {}).update(res)
    return {"setup_s": setup_s, "setup": setup, "launches": launches, "launches_vb": launches_vb,
            "profile": profile, "profile_vb": profile_vb, "per_proof": query,
            "latency": latency, "latency_vb": latency_vb}


# ------------------------------------------------------------------- SDK

def _sdk_verify_mask(args):
    """verify_masked_card in a worker process (host BabyJubjub arithmetic)."""
    from uzkge_tpu_torch.shuffle import sdk

    return sdk.verify_masked_card(*args)


def _sdk_open(args):
    """Players 1-3 reveal `card`, each share checked with its proof; player
    0 unmasks it with its own key; returns the card's index (-1 when a
    reveal is rejected)."""
    from uzkge_tpu_torch.shuffle import sdk

    players, card = args
    reveals = [sdk.reveal_card(sk, card) for sk, _ in players[1:]]
    if not all(sdk.verify_revealed_card(pk, card, r) for (_, pk), r in zip(players[1:], reveals)):
        return -1
    return sdk.unmask_card(players[0][0], card, [r["card"] for r in reveals])


def sdk_path(ctx, n=52):
    """The SDK's hex game flow for n cards and four players: keypairs,
    aggregate_keys, refresh_joint_key, init_masked_cards, verify_masked_card,
    shuffle_cards (the proof on the card), verify_shuffled_cards (and a
    tampered deck rejected), reveal_card / verify_revealed_card by three
    players and unmask_card by the fourth; the revealed indices must be the
    deck's n.  `ctx` holds phase 4's n-card prover params.  The per-card host arithmetic (a BabyJubjub product is ~0.2 s
    of Python) runs in 8 spawned worker processes, which end with the
    phase.  Runs after every phase that proves on phase 4's params: the key
    refresh rewrites them."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from uzkge_tpu_torch.shuffle import sdk

    sdk._PARAMS[n] = (ctx["pp"], ctx["cs"], ctx["kzg"])
    log(f"SDK: the {n}-card prover params handed over from phase 4: sdk._PARAMS[{n}] = the (pp, "
        f"cs, kzg) of its gen_shuffle_prover_params({n}) on the card, so init_prover_key({n}) "
        "builds nothing")
    t0 = time.perf_counter()
    players = [sdk.generate_keypair() for _ in range(4)]
    joint = sdk.aggregate_keys([pk for _, pk in players])
    words = sdk.refresh_joint_key(joint, n)
    t1 = time.perf_counter()
    deck = sdk.init_masked_cards(joint, n)
    t2 = time.perf_counter()
    cards = [c["card"] for c in deck]
    with ProcessPoolExecutor(8, mp_context=multiprocessing.get_context("spawn")) as pool:
        masks_ok = list(pool.map(_sdk_verify_mask, [(joint, i, c["card"], c["proof"])
                                                    for i, c in enumerate(deck)]))
        t3 = time.perf_counter()
        shuffled = sdk.shuffle_cards(joint, cards)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        ok = sdk.verify_shuffled_cards(cards, shuffled["cards"], shuffled["proof"])
        bad = list(shuffled["cards"])
        bad[0], bad[1] = bad[1], bad[0]
        ok_bad = sdk.verify_shuffled_cards(cards, bad, shuffled["proof"])
        t5 = time.perf_counter()
        indices = list(pool.map(_sdk_open, [(players, c) for c in shuffled["cards"]]))
        t6 = time.perf_counter()
    if len(words) != 2 * len(ctx["pp"].verifier_params.cm_shuffle_public_key_vec):
        raise AssertionError(f"SDK: refresh_joint_key gave {len(words)} words")
    if not all(masks_ok):
        raise AssertionError(f"SDK: verify_masked_card rejects cards {masks_ok}")
    if not ok or ok_bad:
        raise AssertionError(f"SDK: verify_shuffled_cards gave {ok} on the shuffle, {ok_bad} on "
                             "a tampered deck")
    if sorted(indices) != list(range(n)):
        raise AssertionError(f"SDK: the revealed cards are not the deck's {n} ({indices})")
    log(f"SDK hex game flow, {n} cards, 4 players: keys + refresh_joint_key ({len(words)} words) "
        f"{t1 - t0:.3f} s, init_masked_cards {t2 - t1:.3f} s, verify_masked_card x{n} "
        f"{t3 - t2:.3f} s, shuffle_cards {t4 - t3:.3f} s, verify_shuffled_cards (accepted, a "
        f"tampered deck rejected) {t5 - t4:.3f} s, 3 x reveal_card + verify_revealed_card and "
        f"unmask_card x{n} {t6 - t5:.3f} s; the revealed indices are the deck's {n} "
        f"({sum(i != j for i, j in enumerate(indices))} moved by the shuffle)")


# ------------------------------------------------------------------- groth16

G2_KERNELS = ("g2_bucket_accumulate", "g2_bucket_reduce")  # a proof's G2 MSM, once each
# a Groth16 proof's kernels, the reveal's and groth16.prove's alike (ark_prove.prove_tail)
G16_KERNELS = ("ntt_pass", "msm_bucket_accumulate", "msm_bucket_reduce") + G2_KERNELS
G2_ACC_KERNELS = ("g2_bucket_accumulate_sort_kernel", "g2_bucket_accumulate_piece_kernel",
                  "g2_bucket_accumulate_merge_kernel")  # g2_bucket_accumulate's launches
G2_MADD_PRODUCTS, G2_PADD_PRODUCTS, G2_DBL_PRODUCTS = 39, 42, 25  # Montgomery products
G16_QUERIES = ("a", "b1", "l", "h")  # the G1 MSMs of a proof, in ark_prove.prove_tail's order


def _g16_load_pk():
    """The embedded 52-card reveal proving key (host ark decompression), in
    a worker process; returns it and its seconds."""
    from uzkge_tpu_torch.groth16.ark_pk import load_reference_groth16_pk

    t0 = time.perf_counter()
    return load_reference_groth16_pk(), time.perf_counter() - t0


def _g16_toy_setup(products: int, x: int, setup_seed: bytes):
    """The own-shape Groth16 setup of chain_circuit(products, x) (host
    Python), in a worker process; returns the key and its seconds."""
    from uzkge_tpu_torch.groth16.groth16 import setup
    from uzkge_tpu_torch.groth16.r1cs import chain_circuit

    t0 = time.perf_counter()
    return setup(chain_circuit(products, x), seed=setup_seed), time.perf_counter() - t0


def g16_host_work(goldens):
    """Starts the groth16 phase's host-only set-up in 2 spawned worker
    processes, overlapped with phases 3-8: the embedded key's load and the
    toy's setup.  Returns the pool and the futures."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from uzkge_tpu_torch.constants.bn254 import R_MOD

    toy = goldens["g16toy"]
    pool = ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn"))
    x = random.Random(toy["seed"]).randrange(1, R_MOD)
    return pool, {"pk": pool.submit(_g16_load_pk),
                  "toy": pool.submit(_g16_toy_setup, toy["products"], x,
                                     toy["setup_seed"].encode())}


def g16_words(words) -> bytes:
    return b"".join(int(w).to_bytes(32, "big") for w in words)


def check_g16_msms(dev, apk, cs, rate):
    """msm_bucket_accumulate (limb for limb, against its plain version) and
    msm_bucket_reduce at each of the reveal's four G1 MSMs (P = 1: the a,
    b1, l and h queries' non-identity points, 2823, 4094, 4862 and 8191 of
    them) on the reveal's own bases (the key's cached MSMBases) and scalars
    (the assignment, the witnesses, the witness map's h), timed; at n = 2823
    and 8191 the window sums' point against the host Pippenger
    (ark_prove._pippenger).  The reduce's buckets have phase 3's P = 1 shape,
    where it was held against its plain version, whose time stands here;
    the reveal's sha256 covers its output.  Returns each kernel's ms, plain
    ms and bound summed over one reveal."""
    from uzkge_tpu_torch.ff.field import fr
    from uzkge_tpu_torch.groth16.ark_prove import g1_msm_host, qap_witness_map
    from uzkge_tpu_torch.msm import msm as M

    z = cs.assignment()
    h = qap_witness_map(*cs.matrices(), z, cs.num_instance, apk.domain_size, dev)
    scalars = {"a": z, "b1": z, "l": z[cs.num_instance:], "h": h}
    tot = {k: {"g16_events_ms": 0.0, "g16_plain_ms": 0.0, "g16_bound_ms": 0.0}
           for k in ("msm_bucket_accumulate", "msm_bucket_reduce")}
    for name in G16_QUERIES:
        idx, bases = apk._msm_cache[(name, str(dev))]
        row = [scalars[name][i] for i in idx]
        n = bases.n
        std = fr.from_mont(fr.to_mont_limbs(row, dev)[None])
        L = M.pick_piece(n, 1, dev)
        ms, kb = cuda_ms(lambda: M.msm_bucket_accumulate(bases.x, bases.y, std, L))
        pms, pb = cuda_ms(lambda: M.msm_bucket_accumulate_plain(bases.x, bases.y, std, L), reps=0)
        if not torch.equal(kb, pb):
            raise AssertionError(f"msm_bucket_accumulate (reveal's {name} query, n={n}, P=1, "
                                 f"L={L}) disagrees with its plain version")
        rms, ks = cuda_ms(lambda: M.msm_bucket_reduce(kb))
        rpms = REDUCE_PLAIN_MS[1]
        host = ""
        if n in (2823, 8191):
            want_pt = g1_msm_host([bases.points[i] for i in range(n)], row)
            if M._window_sums_to_points(ks.cpu()) != [want_pt]:
                raise AssertionError(f"the Pippenger (reveal's {name} query, n={n}) disagrees "
                                     "with the host Pippenger")
            host = "; its point == the host Pippenger's"
        a, r = acc_bound(std, n, rate), reduce_bound(1, 1, rate)
        for k, (t, pt, b) in (("msm_bucket_accumulate", (ms, pms, a)),
                              ("msm_bucket_reduce", (rms, rpms, r))):
            tot[k]["g16_events_ms"] += t
            tot[k]["g16_plain_ms"] += pt
            tot[k]["g16_bound_ms"] += b["bound_ms"]
        log(f"Pippenger at the reveal's {name} query (n={n}, P=1, L={L}): msm_bucket_accumulate "
            f"{ms:.4f} ms (plain {pms:.4f}, bound {a['bound_ms']:.4f} {a['bound_by']}), "
            f"msm_bucket_reduce {rms:.4f} ms (plain {rpms:.4f}: phase 3's at P = 1, bound "
            f"{r['bound_ms']:.4f} {r['bound_by']}); the accumulate equal to its plain "
            f"version{host}")
        del kb, pb, ks
    log("Pippenger per reveal (n = 2823, 4094, 4862, 8191): " + json.dumps(tot))
    return tot


def g2_acc_bound(std, n: int, rate) -> dict:
    """g2_bucket_accumulate's bound: a mixed addition over Fq2 per nonzero
    digit; the (n, 4, 8) bases and the scalars read once, the 32 x 256
    buckets (192 B each) written once."""
    from uzkge_tpu_torch.msm import msm as M

    nonzero = int((M._digits(std) != 0).sum())
    return bound(n * 128 + n * 32 + M.N_WINDOWS * M.N_BUCKETS * 192,
                 nonzero * G2_MADD_PRODUCTS, rate)


def g2_reduce_bound(rate) -> dict:
    """g2_bucket_reduce's bound: reduce_bound's count at (P, K) = (1, 1),
    542 additions and 4 doublings a window, in Fq2; the buckets read once,
    the window sums written once."""
    from uzkge_tpu_torch.msm import msm as M

    adds = M.N_WINDOWS * (16 * 30 + 15 + 47)
    return bound(M.N_WINDOWS * M.N_BUCKETS * 192 + M.N_WINDOWS * 192,
                 adds * G2_PADD_PRODUCTS + M.N_WINDOWS * 4 * G2_DBL_PRODUCTS, rate)


def check_g2_msm(dev, apk, cs, s, rate):
    """g2_bucket_accumulate and g2_bucket_reduce on the reveal's own G2 MSM:
    the key's cached host limbs of b_g2_query's non-identity points with
    beta_g2 and delta_g2 (ark_prove.device_g2_msm's, copied in as it copies
    them) and the scalars z + [1, s]; each timed (CUDA events, mean of 5)
    beside its plain version on the same tensors (cold, one call) and equal
    to it limb for limb.  Returns each kernel's row for the kernels line
    and its g16_* numbers for one reveal."""
    from uzkge_tpu_torch.constants.bn254 import R_MOD
    from uzkge_tpu_torch.ff.field import ints_to_limbs
    from uzkge_tpu_torch.msm import msm_g2 as MG

    idx, host_bases = apk._msm_cache["b2"]
    z = cs.assignment() + [1, s]
    bases = host_bases.to(dev)
    std = torch.from_numpy(ints_to_limbs(z[i] % R_MOD for i in idx)).to(dev)
    n, L = len(idx), MG.G2_PIECE
    ms, kb = cuda_ms(lambda: MG.g2_bucket_accumulate(bases, std, L))
    pms, pb = cuda_ms(lambda: MG.g2_bucket_accumulate_plain(bases, std, L), reps=0)
    if not torch.equal(kb, pb):
        raise AssertionError(f"g2_bucket_accumulate (reveal's G2 MSM, n={n}, L={L}) disagrees "
                             "with its plain version")
    rms, ks = cuda_ms(lambda: MG.g2_bucket_reduce(kb))
    rpms, ps = cuda_ms(lambda: MG.g2_bucket_reduce_plain(kb), reps=0)
    if not torch.equal(ks, ps):
        raise AssertionError(f"g2_bucket_reduce (reveal's G2 MSM, n={n}) disagrees with its "
                             "plain version")
    a, r = g2_acc_bound(std[None], n, rate), g2_reduce_bound(rate)
    log(f"G2 Pippenger at the reveal's G2 MSM (n={n}, L={L}): g2_bucket_accumulate {ms:.4f} ms "
        f"(plain {pms:.4f}, bound {a['bound_ms']:.4f} {a['bound_by']}), g2_bucket_reduce "
        f"{rms:.4f} ms (plain {rpms:.4f}, bound {r['bound_ms']:.4f} {r['bound_by']}); both equal "
        "to their plain versions limb for limb")
    out = {}
    for k, t, pt, b, shape in (("g2_bucket_accumulate", ms, pms, a, f"n={n} L={L}"),
                               ("g2_bucket_reduce", rms, rpms, r, "32 x 256 buckets")):
        out[k] = {"max_abs_err": 0, "ms": t, "plain_ms": pt, "shape": shape, **b,
                  "g16_events_ms": t, "g16_plain_ms": pt, "g16_bound_ms": b["bound_ms"]}
    del kb, pb, ks, ps, bases, std
    return out


def groth16_path(dev, goldens, rate, errs, pending):
    """The Groth16 phase.  The reveal for the deployed verifier, through its
    entry point: prove_reveal_onchain for the golden seed on the card (the
    embedded key, domain 8192; its witness map's NTTs, four G1 MSMs and
    the G2 MSM on the card), its words' sha256 equal to the JAX
    package's (`reveal`), verify_reveal_onchain accepting it and rejecting
    the reveal point changed by one, ntt_pass and both Pippenger kernels
    launched; a profiled second reveal; sdk.reveal_card_with_snark on the
    card, verified; the kernels at the reveal's shapes against their plain
    versions; then the own-shape setup + prove of the 700-product chain
    (domain 1024) on the card, its sha256 the JAX package's (`g16toy`),
    verified, a wrong public input rejected.  `pending`: g16_host_work's
    futures.  Returns the reveal's launches, the kernels' g16_* fields and
    the profile's sums."""
    from uzkge_tpu_torch.constants.bn254 import R_MOD
    from uzkge_tpu_torch.curve import babyjubjub as bjj
    from uzkge_tpu_torch.groth16 import ark_pk, groth16 as g16, reveal
    from uzkge_tpu_torch.groth16.ark_r1cs import synthesize_reveal
    from uzkge_tpu_torch.groth16.r1cs import chain_circuit
    from uzkge_tpu_torch.shuffle import sdk
    from uzkge_tpu_torch.shuffle.primitives import Ciphertext
    from uzkge_tpu_torch.utils.chacha import ChaCha20Rng

    t_phase = time.perf_counter()
    apk, load_s = pending["pk"].result()
    ark_pk._CACHED = apk  # load_reference_groth16_pk() hands it out from here on
    log(f"groth16: the embedded reveal proving key (groth16_pk.bin: domain {apk.domain_size}, "
        f"{apk.num_instance} instance columns, {apk.num_witness} witnesses) loaded in a worker "
        f"process in {load_s:.3f} s of host time, overlapped with the earlier phases")
    golden = goldens["reveal"]
    seed = golden["seed"]
    sk, e1 = reveal.seeded_reveal(random.Random(seed))
    pk_pt = bjj.mul(bjj.GENERATOR, sk)

    def prove():
        return reveal.prove_reveal_onchain(sk, e1, rng=random.Random(seed), device=dev)

    with NttShapes() as shapes:
        (reveal_pt, proof), latency, launches, stages = run_timed(
            prove, "reveal (prove_reveal_onchain, first: the MSM bases made)")
    missing = [k for k in G16_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the reveal launched no {missing}")
    g2_launches = {k: launches[k] for k in G2_KERNELS}
    if any(v != 1 for v in g2_launches.values()):
        raise AssertionError(f"the reveal's G2 launches {g2_launches}, want one of each")
    log("ntt_pass shapes of the reveal (OUT, S, IN, pre, post, const): launches " +
        json.dumps({str(k): v for k, v in sorted(shapes.counts.items())}))
    check_digest(g16_words(reveal.onchain_words(reveal_pt, proof)), golden, "reveal")
    bad = ((reveal_pt[0] + 1) % R_MOD, reveal_pt[1])
    ok = reveal.verify_reveal_onchain(e1, reveal_pt, pk_pt, proof)
    ok_bad = reveal.verify_reveal_onchain(e1, bad, pk_pt, proof)
    if not ok or ok_bad:
        raise AssertionError(f"verify_reveal_onchain gave {ok} on the reveal, {ok_bad} on the "
                             "reveal point changed by one")
    log("verify_reveal_onchain: the reveal accepted, the reveal point changed by one rejected")
    prof = profile_fn(prove, latency, "reveal (second: the bases cached)")

    masked = Ciphertext.encrypt(bjj.mul(bjj.GENERATOR, 17), pk_pt, random.Random(seed + 1)
                                .randrange(1, bjj.ORDER))
    t0 = time.perf_counter()
    out = sdk.reveal_card_with_snark(sdk.scalar_to_hex(sk), sdk.masked_card_serialize(masked),
                                     device=dev)
    sdk_s = time.perf_counter() - t0
    w = [sdk.hex_to_scalar(x) for x in out["snark_proof"]]
    sdk_pt = sdk.hex_to_point(out["card"])
    sdk_proof = ((w[0], w[1]), ((w[3], w[2]), (w[5], w[4])), (w[6], w[7]))
    if (sdk_pt != bjj.mul(masked.e1, sk)
            or not reveal.verify_reveal_onchain(masked.e1, sdk_pt, pk_pt, sdk_proof)):
        raise AssertionError("sdk.reveal_card_with_snark's proof does not verify")
    log(f"sdk.reveal_card_with_snark on the card (the bases cached): {sdk_s:.3f} s; its proof "
        "verifies")

    cs = synthesize_reveal(sk, e1, reveal_pt, pk_pt)
    res = check_g16_msms(dev, apk, cs, rate)
    rs = random.Random(seed)  # prove_reveal_onchain draws r, then s
    rs.randrange(1, R_MOD)
    res.update(check_g2_msm(dev, apk, cs, rs.randrange(1, R_MOD), rate))
    ntt = time_ntt_shapes(dev, shapes.counts, rate, errs)
    res["ntt_pass"] = {"g16_events_ms": ntt["ms"], "g16_plain_ms": ntt["plain_ms"],
                       "g16_bound_ms": ntt["bound_ms"]}

    toy = goldens["g16toy"]
    tpk, setup_s = pending["toy"].result()
    tcs = chain_circuit(toy["products"], random.Random(toy["seed"]).randrange(1, R_MOD))
    tproof, tlat, tlaunch, _ = run_timed(
        lambda: g16.prove(tpk, tcs, rng=ChaCha20Rng(toy["seed"].to_bytes(32, "little")),
                          device=dev),
        f"groth16.prove (own shape: {toy['products']}-product chain, domain {tpk.domain_size})")
    launched = sorted(k for k, v in tlaunch.items() if v > 0)
    if launched != sorted(G16_KERNELS) or any(tlaunch[k] != 1 for k in G2_KERNELS):
        raise AssertionError(f"the own-shape proof launched {tlaunch}, want every one of "
                             f"{G16_KERNELS} and nothing else, each G2 kernel once")
    check_digest(g16_words(tproof.to_solidity_words()), toy, "g16toy")
    public = tcs.public_inputs()
    ok = g16.verify(tpk.vk, public, tproof)
    ok_bad = g16.verify(tpk.vk, [public[0], (public[1] + 1) % R_MOD], tproof)
    if not ok or ok_bad:
        raise AssertionError(f"groth16.verify gave {ok} on the own-shape proof, {ok_bad} with a "
                             "wrong public input")
    log(f"groth16 own shape: setup {setup_s:.3f} s (host, in a worker process), prove {tlat:.3f} "
        "s on the card; verify accepts it and rejects a wrong public input")
    log(f"groth16 phase: {time.perf_counter() - t_phase:.1f} s")
    for k in G16_KERNELS:
        res[k]["g16_launches"] = launches[k]
        names = PROFILE_NAMES.get(k, (f"{k}_kernel",))
        res[k]["g16_proof_ms"] = sum(prof[n][0] for n in names if n in prof) if prof else None
    res["reveal_s"] = latency
    return res


# the wrappers' kernels as the profiles name them
PROFILE_NAMES = {"msm_bucket_accumulate": ACC_KERNELS, "g2_bucket_accumulate": G2_ACC_KERNELS,
                 "fq_batch_inv": (
    "fq_inv_down_kernel", "fq_inv_root_kernel", "fq_inv_up_kernel")}


def matchmaking_row(name, mm):
    """A kernel's numbers on the matchmaking proof for the kernels line:
    mm_launches (the fixed-base proof's; the variable-base proof's for the
    Pippenger's two; the set-up's table build for fb_bases and
    fb_mult_chunk), mm_setup_launches, mm_proof_ms (device time in that
    proof's profile, summed over the wrapper's kernels) and, where phase 7
    timed the kernel at the proof's shapes, mm_events_ms, mm_plain_ms and
    mm_bound_ms summed over one proof."""
    vb = name in VB_KERNELS
    launches = mm["setup"] if name in SETUP_KERNELS else mm["launches_vb" if vb else "launches"]
    prof = mm["profile_vb" if vb else "profile"]
    names = PROFILE_NAMES.get(name, (f"{name}_kernel",))
    return {"mm_launches": launches.get(name, 0), "mm_setup_launches": mm["setup"].get(name, 0),
            "mm_proof_ms": sum(prof[k][0] for k in names if k in prof) if prof else None,
            **mm["per_proof"].get(name, {})}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this smoke run needs one", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    import uzkge_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    dev = torch.device("cuda:0")
    start = time.perf_counter()
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    with open(GOLDEN) as f:
        goldens = json.load(f)
    pool, pending = g16_host_work(goldens)
    try:
        run_phases(dev, goldens, start, pending)
    finally:
        pool.shutdown(cancel_futures=True)


def run_phases(dev, goldens, start, pending):
    """Phases 2 to 10 (the kernel build on); `pending`: g16_host_work's
    futures."""
    from uzkge_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.build(verbose=True)
    kernels.library()
    log(f"kernel build + load: {time.perf_counter() - t0:.3f} s")
    golden = goldens["52"]
    rng = random.Random(golden["seed"])
    rate = imul_rate()
    log(f"bounds: {HBM_BYTES_PER_S:.4g} B/s, {rate:.4g} 32-bit multiplies/s")
    check_product_rate(dev)
    ntt = check_ntt(dev, rng, rate)
    acc, red = check_msm(dev, rng, rate)
    from uzkge_tpu_torch.gen_params import load_srs

    errs = {}
    small = check_fixed_base_small(dev, load_srs(16384, dev)._lagrange_points, errs)
    check_query_small(dev, small, errs, rng)
    check_chain_small(dev, small, errs, rng)
    del small

    launches, launches_vb, ctx = main_path(dev, golden)
    t_batch = time.perf_counter()
    batch_path(dev, golden, ctx)
    log(f"batch phase: {time.perf_counter() - t_batch:.1f} s")
    tbl, fb_launches = fixed_base_path(dev, rng)
    fbres = check_fixed_base_full(dev, tbl, rate, errs)
    qres, query_ms = check_query_full(dev, tbl, rate, errs, rng)
    batches = check_query_batches(dev, tbl, errs, rate)
    per_proof = {k: qres[k]["ms"] + sum(b[k] for b in batches.values())
                 for k in ("fq_batch_inv", "fb_fold", "fb_pair_combine")}
    log("per proof (queries at P = 8, 1, 5, 2), ms: " + json.dumps(per_proof))
    ntt_proof = time_ntt_shapes(dev, ctx["ntt_shapes"], rate, errs)
    ntt["max_abs_err"] = max(ntt["max_abs_err"], errs.get("ntt_pass", 0))
    prof = ctx["profile"]
    ntt.update(proof_ms=prof.get("ntt_pass_kernel", (None,))[0], proof_events_ms=ntt_proof["ms"],
               proof_bound_ms=ntt_proof["bound_ms"])
    qres["fb_pair_combine"].update(
        proof_ms=prof.get("fb_pair_combine_kernel", (None,))[0],
        proof_events_ms=per_proof["fb_pair_combine"],
        proof_bound_ms=qres["fb_pair_combine"]["bound_ms"]
        + sum(b["fb_pair_combine_bound"] for b in batches.values()))
    chain, sc, want = check_chain_full(dev, tbl, rate, errs, query_ms)
    group_launches, prof_grp = sharded_path(dev, golden, ctx, tbl, sc, want)
    del tbl, sc
    mm = matchmaking_path(dev, goldens["mm50"], rate, errs, rng, ctx["ntt_shapes"])
    sdk_path(ctx)
    g16 = groth16_path(dev, goldens, rate, errs, pending)
    prof_vb = ctx["profile_vb"]
    for res, names, prof_route in ((acc, ACC_KERNELS, prof_vb),
                                   (red, ("msm_bucket_reduce_kernel",), prof_vb),
                                   (chain["scan_leaf_reduce"], ("scan_leaf_reduce_kernel",),
                                    prof_grp),
                                   (chain["scan_proj_reduce"], ("scan_proj_reduce_kernel",),
                                    prof_grp)):
        # device time per proof, summed over the wrapper's kernels
        res["proof_ms"] = sum(prof_route[k][0] for k in names) if prof_route else None
    launches.update({k: launches_vb[k] for k in VB_KERNELS})
    launches.update({k: fb_launches[k] for k in SETUP_KERNELS})
    launches.update({k: group_launches[k] for k in ("scan_leaf_reduce", "scan_proj_reduce")})
    launches["fb_bases_chain"] = group_launches["fb_bases"]  # one per msm_chain call
    launches.update({k: g16[k]["g16_launches"] for k in G2_KERNELS})  # their path: the reveal

    fb_src = "uzkge_tpu_torch/csrc/fixed_base.cu"
    q_src = "uzkge_tpu_torch/csrc/fixed_base_query.cu"
    s_src = "uzkge_tpu_torch/csrc/scan_reduce.cu"
    g2_src = "uzkge_tpu_torch/csrc/msm_g2.cu"
    jfb = "uzkge_tpu/msm/fixed_base.py"
    rows = [
        ("ntt_pass", "uzkge_tpu_torch/csrc/ntt.cu", "uzkge_tpu/ntt/pallas_ntt.py:87", ntt),
        ("msm_bucket_accumulate", "uzkge_tpu_torch/csrc/msm.cu", "uzkge_tpu/msm/msm.py:184", acc),
        ("msm_bucket_reduce", "uzkge_tpu_torch/csrc/msm.cu", "uzkge_tpu/msm/msm.py:197", red),
        ("fp_mont_mul", "uzkge_tpu_torch/csrc/mont_mul.cu", "uzkge_tpu/ff/pallas_field.py:69",
         qres["fp_mont_mul"]),
        ("fb_bases", fb_src, f"{jfb}:232", fbres["fb_bases"]),
        ("fb_bases_chain", fb_src, f"{jfb}:232", chain["fb_bases_chain"]),
        ("fb_mult_chunk", fb_src, f"{jfb}:254", fbres["fb_mult_chunk"]),
        # _prod_kernel, _inv_kernel (pbatch_inv_fq); _prefix_kernel, _invback_kernel,
        # _fermat_bits_kernel (pbatch_inv_fq_fast)
        ("fq_batch_inv", fb_src, f"{jfb}:274,283,334,345,355", qres["fq_batch_inv"]),
        ("fb_select", q_src, f"{jfb}:607", qres["fb_select"]),
        ("fb_pair_den", q_src, f"{jfb}:630,737", qres["fb_pair_den"]),
        ("fb_pair_combine", q_src, f"{jfb}:652,757", qres["fb_pair_combine"]),
        ("fb_fold", q_src, f"{jfb}:680", qres["fb_fold"]),
        ("scan_leaf_reduce", s_src, f"{jfb}:195", chain["scan_leaf_reduce"]),
        ("scan_proj_reduce", s_src, f"{jfb}:215", chain["scan_proj_reduce"]),
        # the JAX package's host Pippenger g2_msm_host (_pippenger over Fq2)
        ("g2_bucket_accumulate", g2_src, "uzkge_tpu/groth16/ark_prove.py:207,280",
         g16.pop("g2_bucket_accumulate")),
        ("g2_bucket_reduce", g2_src, "uzkge_tpu/groth16/ark_prove.py:207,280",
         g16.pop("g2_bucket_reduce")),
    ]
    for name, _, _, res in rows:
        res.update(matchmaking_row(name, mm))
        res.update(g16.get(name, {}))
    out = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **res}
        for name, src, rep, res in rows
    ]}
    log(f"chip_smoke: {time.perf_counter() - start:.1f} s from the card check to the kernels line")
    log(json.dumps(out))
    log(card_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
