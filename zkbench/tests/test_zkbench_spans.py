"""The readers of the prover's inner spans on synthetic runs (`blind_s`,
`msm_s`, `quotient_kernels`), and the harness's stage recorder bound as the
program's span accumulator while the program's spans nest."""

import sys

import pytest

from .conftest import ROOT

sys.path.insert(0, ROOT)

from zkbench import run  # noqa: E402
from zkbench.metrics import blind_s, commit_s, msm_s, quotient_kernels  # noqa: E402


def test_blind_and_msm_seconds_a_proof():
    r = run.Run({}, None)
    assert blind_s.read(r) is None and msm_s.read(r) is None
    r.stages = [{"r1_commit": 3.0, "kzg_blind": 2.0, "kzg_msm": 0.25},
                {"r1_commit": 2.0, "r5_openings": 1.0, "kzg_blind": 1.0, "kzg_msm": 0.75}]
    assert blind_s.read(r) == 1.5 and msm_s.read(r) == 0.5
    assert blind_s.read(r) + msm_s.read(r) <= commit_s.read(r)
    # a program without the spans (the parent of the change that added them)
    r.stages = [{"r1_commit": 3.0}, {"r1_commit": 2.0}]
    assert blind_s.read(r) is None and msm_s.read(r) is None


def _trace(events, spans):
    return run.Trace(events, 0.0, 10.0, spans, [], [])


def test_quotient_kernels_count_what_starts_inside_the_span():
    spans = [("r3_t_kernel", 1.0, 2.0), ("r1_commit", 0.0, 1.0), ("r3_t_kernel", 5.0, 6.0)]
    events = [(1.1, 1.2, "void at::native::vectorized_elementwise_kernel<4>"),
              (1.9, 2.5, "queued late, starts inside"),
              (0.9, 1.05, "started before the span"),
              (2.0, 2.1, "starts at the span's end"),
              (1.5, 1.6, "Memcpy DtoH (Device -> Pageable)"),
              (1.6, 1.7, "Memset (Device)"),
              (5.5, 5.6, "ntt_pass_kernel"),
              (0.5, 0.6, "fb_select_kernel")]
    r = run.Run({}, None)
    r.trace = _trace(events, spans)
    assert quotient_kernels.read(r) is None  # no proofs
    r.stages = [{"r3_t_kernel": 1.0}, {"r3_t_kernel": 1.0}]
    assert quotient_kernels.read(r) == 1.5
    r.trace = _trace(events, [s for s in spans if s[0] != "r3_t_kernel"])
    assert quotient_kernels.read(r) is None
    r.trace = _trace([], spans)  # no device events (a CPU run)
    assert quotient_kernels.read(r) is None
    r.trace = None
    assert quotient_kernels.read(r) is None


def test_stage_recorder_keeps_the_programs_nested_spans(monkeypatch):
    pytest.importorskip("torch")
    from uzkge_tpu_torch.utils import stagetimer

    rec = run.StageRecorder()
    monkeypatch.setattr(stagetimer, "_acc", rec)
    rec.spans = []
    with stagetimer.recording() as own:
        with stagetimer.stage("r1_commit"):
            with stagetimer.stage("kzg_msm"):
                pass
            with stagetimer.stage("kzg_blind"):
                pass
        with stagetimer.stage("kzg_blind"):
            pass
    kept = [(n, a, b) for n, a, b in rec.spans if b > a]  # a first write adds 0.0
    assert [n for n, _, _ in kept] == ["kzg_msm", "kzg_blind", "r1_commit", "kzg_blind"]
    assert rec["kzg_blind"] == pytest.approx(sum(s[2] - s[1] for s in own if s[0] == "kzg_blind"))
    outer = kept[2]
    assert all(outer[1] - 1e-3 <= a <= b <= outer[2] + 1e-3 for _, a, b in kept[:2])
    # each recorded span lies within a ms of the program's own start and end
    for (n, a, b), s in zip(kept, own):
        assert n == s[0] and abs(a - s[1]) < 1e-3 and abs(b - s[2]) < 1e-3
