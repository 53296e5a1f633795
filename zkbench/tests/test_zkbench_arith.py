"""The harness's arithmetic on synthetic readings: busy time as an interval
union, gaps and the stage they fall in, the window over the proofs, and the
roofline sums over kernel time."""

import random
import sys

import pytest

from .conftest import ROOT

sys.path.insert(0, ROOT)

from zkbench import run  # noqa: E402
from zkbench.metrics import (build_cs_s, commit_s, device_idle_share, fb_query_roofline,  # noqa: E402
                             ntt_roofline, proof_latency_s, quotient_s)
from zkbench.yardstick import bounds, trace  # noqa: E402


def test_interval_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (1.5, 1.8), (3.0, 4.0)]
    assert trace.merged(iv) == [(0.0, 2.0), (3.0, 4.0)]
    assert trace.busy(iv, 0.0, 5.0) == 3.0
    assert trace.busy(iv, 0.5, 3.5) == 2.0  # clipped to the window
    assert trace.gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]
    stages = [("outer", 1.5, 4.5), ("inner", 2.2, 2.6)]
    got = trace.idle_by_stage(trace.gaps(iv, -1.0, 5.0), stages)
    assert got["inner"] == pytest.approx(0.4)
    assert got["outer"] == pytest.approx(1.1)
    assert got["between_stages"] == pytest.approx(1.5)
    assert trace.top_by_name([(0, 1, "a"), (1, 3, "b"), (3, 4, "a"), (4, 4.5, "c")], 2) == [
        ("a", 2), ("b", 2)]


def test_window_over_proofs_and_stage_means():
    r = run.Run({}, None)
    r.window_s, r.completed = 33.0, 3
    assert proof_latency_s.read(r) == 11.0
    r.completed = 0
    assert proof_latency_s.read(r) is None
    r.stages = [{"r0_build_cs": 3.0, "r1_commit": 2.0, "r3_t_split_commit": 1.0, "r3_t_kernel": 0.5},
                {"r0_build_cs": 1.0, "r2_commit": 0.5, "r5_openings": 0.5, "r3_t_kernel": 1.5}]
    assert build_cs_s.read(r) == 2.0
    assert commit_s.read(r) == 2.0
    assert quotient_s.read(r) == 1.0


def test_stage_recorder_keeps_spans():
    rec = run.StageRecorder()
    rec["a"] += 1.0
    rec.spans = []
    rec["a"] += 0.25
    (name, lo, hi), = rec.spans
    assert name == "a" and rec["a"] == 1.25 and hi - lo == pytest.approx(0.25)


def _trace(events, fb=(), passes=()):
    return run.Trace(events, 0.0, 10.0, [("r1_commit", 0.0, 5.0)], list(fb), list(passes))


def test_idle_share_and_breakdown():
    t = _trace([(1.0, 2.0, "void fb_select_kernel<8>(...)"), (1.5, 3.0, "aten::add"),
                (6.0, 7.0, "ntt_pass_kernel"), (11.0, 12.0, "late")])
    r = run.Run({}, 1e9)
    r.trace = t
    assert t.busy_s == 3.0 and t.window_s == 10.0
    assert device_idle_share.read(r) == pytest.approx(70.0)
    b = t.breakdown()
    assert b["device_ops"][0] == ["aten::add", 1.5]
    assert dict(b["idle_gaps"]) == pytest.approx({"r1_commit": 3.0, "between_stages": 4.0})


def test_roofline_sums_bounds_over_kernel_time():
    rate = bounds.product_rate(132, 1980.0)
    assert rate * bounds.MULS_PER_PRODUCT == pytest.approx(1.672704e13)
    ev = [(0.0, 0.004, "fb_select_kernel"), (0.004, 0.006, "fq_inv_up_kernel"),
          (0.006, 0.007, "ntt_pass_kernel"), (0.007, 0.009, "ntt_pass_kernel"),
          (0.009, 0.010, "fb_mult_chunk_kernel")]
    queries = [(8, 16384, 4_000_000), (1, 16384, 300_000)]
    passes = [(5, 1024, 128, 0, 0, 0), (1, 16, 8192, 1, 1, 1)]
    r = run.Run({}, rate)
    r.trace = _trace(ev, queries, passes)
    want_fb = sum(bounds.fixed_base_query_s(P, n, nz, rate) for P, n, nz in queries) / 0.006
    assert fb_query_roofline.read(r) == pytest.approx(100 * want_fb)
    want_ntt = sum(bounds.ntt_pass_s(*s, rate) for s in passes) / 0.003
    assert ntt_roofline.read(r) == pytest.approx(100 * want_ntt)
    # each bound by hand: ops-bound query, the NTT pass's products
    P, n, nz = queries[0]
    assert bounds.fixed_base_query_s(P, n, nz, rate) == pytest.approx(
        (P * n + 6 * (nz - P)) / rate)
    assert bounds.ntt_pass_s(5, 1024, 128, 0, 0, 0, rate) == pytest.approx(
        5 * 128 * (512 * 10 - 1023) / rate)
    r.trace = _trace([(0.0, 1.0, "aten::mul")], queries, passes)
    assert fb_query_roofline.read(r) is None and ntt_roofline.read(r) is None


@pytest.mark.parametrize("S", [2, 4, 16, 1024])
def test_ntt_twiddle_products_count_the_twiddles_that_are_not_one(S):
    """A radix-2 NTT written out stage by stage: the butterfly at offset j
    of a block of 2h takes the twiddle w^(j S / 2h), which is 1 at j = 0."""
    want, h = 0, 1
    while h < S:
        want += sum(1 for _ in range(0, S, 2 * h) for j in range(h) if j * (S // (2 * h)) % S)
        h *= 2
    assert bounds.ntt_twiddle_products(S) == want


def test_query_work_counts_digits_of_montgomery_scalars():
    torch = pytest.importorskip("torch")
    rng = random.Random(3)
    vals = [0, 1, run.R_MOD - 1] + [rng.randrange(run.R_MOD) for _ in range(61)]
    mont = [v * (1 << 256) % run.R_MOD for v in vals]
    limbs = [[(m >> (32 * i)) & 0xFFFFFFFF for i in range(8)] for m in mont]
    t = torch.tensor(limbs, dtype=torch.int64).to(torch.int32).view(2, 32, 8)
    assert run.query_work(t, 8) == (2, 32, bounds.signed_digits_nonzero(vals, 8))
    assert bounds.signed_digits_nonzero([0, 1, 255, 256], 8) == 4


def test_observed_calls_must_match_the_programs_launch_counts(capsys):
    torch = pytest.importorskip("torch")
    scalars = torch.zeros((1, 4, 8), dtype=torch.int32)
    seen = {"queries": [(scalars, 8)], "passes": [(1, 16, 1, 0, 0, 0)],
            "launched": {"fb_select": 1, "ntt_pass": 2}}
    assert run.fb_query_work(seen) == [(1, 4, 0)]
    assert run.agreed(seen["passes"], seen["launched"]["ntt_pass"], "ntt_pass calls") is None
    assert "1 calls observed but 2 launches" in capsys.readouterr().err
    seen["launched"]["fb_select"] = 2  # a query launched by a route not observed
    assert run.fb_query_work(seen) is None
    seen["launched"]["fb_select"], seen["queries"] = 1, [(scalars, None)]  # a table without c
    assert run.fb_query_work(seen) is None
