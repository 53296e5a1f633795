"""Reduction of device intervals: busy time as the union of the intervals
(an operator and the kernel it launched count once), the idle gaps between
them, and the host stage each gap fell in."""

from collections import defaultdict
from typing import Iterable, List, Tuple


def merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def busy(intervals, lo: float, hi: float) -> float:
    """The length of the union of `intervals` clipped to [lo, hi]."""
    clipped = [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]
    return sum(b - a for a, b in merged(clipped))


def gaps(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] in which no interval ran."""
    out, cur = [], lo
    for a, b in merged((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        out.append((cur, hi))
    return out


def idle_by_stage(gap_list, stages, outside: str = "between_stages"):
    """Idle time summed by the innermost host stage (name, start, end) that
    held each moment of a gap; moments in no stage go to `outside`."""
    cuts = sorted({t for _, a, b in stages for t in (a, b)})
    out = defaultdict(float)
    for g0, g1 in gap_list:
        points = [g0] + [t for t in cuts if g0 < t < g1] + [g1]
        for a, b in zip(points, points[1:]):
            mid = (a + b) / 2
            inner = [(e - s, name) for name, s, e in stages if s <= mid < e]
            out[min(inner)[1] if inner else outside] += b - a
    return dict(out)


def top_by_name(events, k: int = 10):
    """[(name, seconds)] of the `k` names with the most summed time;
    events are (start_s, end_s, name)."""
    tot = defaultdict(float)
    for a, b, name in events:
        tot[name] += b - a
    return sorted(tot.items(), key=lambda kv: -kv[1])[:k]
