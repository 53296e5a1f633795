"""The port's span timer (uzkge_tpu_torch/utils/stagetimer.py) and its
launch counter (`kernels.count`): nesting per thread, the writes a caller
watching `_acc` sees, exact totals under threads, nothing kept or annotated
with no recording or profiler open, and the spans as the profiler's user
annotations on a clock that agrees with the spans' own."""

import sys
import threading
from collections import defaultdict

import pytest
import torch

from uzkge_tpu_torch import kernels
from uzkge_tpu_torch.utils import stagetimer
from uzkge_tpu_torch.utils.stagetimer import recording, stage


class Watched(dict):
    """An `_acc` stand-in that keeps each write, as a benchmark's recorder
    bound in its place does (a missing name reads 0.0 and is not written)."""

    def __init__(self):
        super().__init__()
        self.writes = []

    def __missing__(self, name):
        return 0.0

    def __setitem__(self, name, value):
        self.writes.append((name, value))
        super().__setitem__(name, value)


@pytest.fixture
def watched(monkeypatch):
    acc = Watched()
    monkeypatch.setattr(stagetimer, "_acc", acc)
    return acc


def test_nested_spans_start_end_depth_and_order(watched):
    me = threading.get_ident()
    with recording() as spans:
        with stage("outer"):
            with stage("a"):
                pass
            with stage("b"):
                with stage("c"):
                    pass
    assert [(s[0], s[3], s[4]) for s in spans] == [
        ("a", me, 1), ("c", me, 2), ("b", me, 1), ("outer", me, 0)]
    got = {s[0]: s[1:3] for s in spans}
    for name, (t0, t1) in got.items():
        assert t0 <= t1
        if name != "outer":
            assert got["outer"][0] <= t0 and t1 <= got["outer"][1]
    assert got["a"][1] <= got["b"][0] and got["b"][0] <= got["c"][0] <= got["c"][1] <= got["b"][1]
    # every span's seconds reach the _acc bound at its end, one write each
    assert [w[0] for w in watched.writes] == ["a", "c", "b", "outer"]
    for name, (t0, t1) in got.items():
        assert watched[name] == pytest.approx(t1 - t0, abs=1e-4)


def test_span_written_to_the_acc_bound_when_it_ends(monkeypatch):
    first, second = Watched(), Watched()
    monkeypatch.setattr(stagetimer, "_acc", first)
    with stage("x"):
        monkeypatch.setattr(stagetimer, "_acc", second)
    with stage("x"):
        pass
    assert first.writes == []
    assert [w[0] for w in second.writes] == ["x", "x"]
    assert second.writes[1][1] > second.writes[0][1] > 0
    # a span whose body raises is still timed
    with pytest.raises(ValueError):
        with stage("y"):
            raise ValueError
    assert "y" in second and second["y"] >= 0


def _in_threads(nthreads, work):
    """Run work(i) on `nthreads` threads released together, with the
    interpreter switching threads as often as it can."""
    barrier = threading.Barrier(nthreads)

    def run(i):
        barrier.wait()
        work(i)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(nthreads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)


def test_threads_keep_their_own_nesting_and_exact_totals(watched):
    nthreads, nspans = 8, 500

    def work(i):
        with stage(f"outer{i}"):
            for _ in range(nspans - 1):
                with stage("inner"):
                    pass

    with recording() as spans:
        _in_threads(nthreads, work)
    assert len(spans) == nthreads * nspans
    by_thread = defaultdict(list)
    for s in spans:
        by_thread[s[3]].append(s)
    assert len(by_thread) == nthreads
    for own in by_thread.values():
        outer = [s for s in own if s[4] == 0]
        assert len(outer) == 1 and outer[0][0].startswith("outer")
        inner = [s for s in own if s[0] == "inner"]
        assert len(inner) == nspans - 1 and all(s[4] == 1 for s in inner)
        assert all(outer[0][1] <= s[1] <= s[2] <= outer[0][2] for s in inner)
    assert len(watched.writes) == nthreads * nspans
    assert watched["inner"] == pytest.approx(sum(s[2] - s[1] for s in spans if s[0] == "inner"))


def test_launch_counter_exact_under_threads():
    nthreads, n = 8, 500
    base = kernels.LAUNCHES["fp_mul_chain"]
    calls = {}

    def work(i):
        for _ in range(n):
            kernels.count("fp_mul_chain")
            kernels.count("stress", calls)

    try:
        _in_threads(nthreads, work)
        assert kernels.LAUNCHES["fp_mul_chain"] - base == nthreads * n
    finally:
        kernels.LAUNCHES["fp_mul_chain"] = base
    assert calls == {"stress": nthreads * n}


def test_nothing_kept_or_annotated_without_a_recording_or_profiler(monkeypatch, watched):
    made = []
    monkeypatch.setattr(stagetimer, "record_function", lambda name: made.append(name))
    assert not torch.autograd._profiler_enabled()
    with stage("quiet"):
        with stage("inner"):
            pass
    assert made == [] and stagetimer._recordings == []
    with recording() as spans:
        pass
    assert spans == [] and stagetimer._recordings == []
    assert [w[0] for w in watched.writes] == ["inner", "quiet"]
    # two recordings, one inside the other: each sees what ends while it is open
    with recording() as a:
        with stage("one"):
            pass
        with recording() as b:
            with stage("two"):
                pass
        with stage("three"):
            pass
    assert [s[0] for s in a] == ["one", "two", "three"] and [s[0] for s in b] == ["two"]
    assert stagetimer._recordings == [] and made == []


def test_spans_are_profiler_annotations_on_an_agreeing_clock(watched):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = [f"span{i}" for i in range(20)]
    with recording() as spans:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            # a process's first annotation stamps its start ~1 ms before
            # its enter returns; later ones do not
            with stage("warm"):
                pass
            with stage("outer"):
                for name in names:
                    with stage(name):
                        torch.ones(64).sum()
    notes = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation() and e.device_type() == DeviceType.CPU:
            notes.setdefault(e.name(), []).append(e.start_ns() / 1e9)
    assert all(len(notes.get(s[0], [])) == 1 for s in spans), notes
    # one-point alignment at the outer span, then every start after the
    # warm-up within 1 ms
    first = next(s for s in spans if s[0] == "outer")
    off = notes["outer"][0] - first[1]
    for name, t0, _, _, _ in spans[1:]:
        assert abs(notes[name][0] - off - t0) < 1e-3, name
