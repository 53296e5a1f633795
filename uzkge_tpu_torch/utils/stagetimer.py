"""Named spans of the prover hot path.

Counterpart of `uzkge_tpu/utils/stagetimer.py`, with the same `stage` API.

    with stage("r3_t_kernel", block=t_evals):
        ...

A span starts and ends on one clock, `CLOCK` (`time.perf_counter`).  It
nests under the innermost span open on the same thread: each thread keeps
its own depth, so the threads of parallel/batch.py do not nest under each
other's spans.  Every finished span adds its seconds to the process-wide
`_acc` under a lock (`snapshot()` reads it; chip_smoke.py prints it as the
stage breakdown), and is appended to every list that `recording()` holds
open at that moment as (name, start, end, thread id, depth), depth 0 for a
span opened under none.

While a torch profiler is active, each span also opens
`record_function(name)`, so the spans appear in the profiler's trace as user
annotations, on the profiler's clock beside the device's events.  With no
profiler active no annotation is made, and with no recording open no span is
kept: a span then costs two clock reads, the profiler's flag, the lock and
one dict update.

`block` (optional) is a tensor: on exit the span waits for its device
(`torch.cuda.synchronize`, the whole device, whichever thread launched the
work) so that work launched asynchronously is charged to the span that
launched it, not to the next host sync.
"""

import threading
import time
from collections import defaultdict
from contextlib import contextmanager

import torch
from torch.autograd.profiler import record_function

CLOCK = time.perf_counter

# seconds summed by span name; written as `_acc[name] += seconds` on the
# module's `_acc` as it is bound when the span ends, so a caller may bind
# another mapping here to watch each span end
_acc = defaultdict(float)
_lock = threading.Lock()  # guards _acc and _recordings
_recordings = []  # the span lists of the open recording() blocks
_local = threading.local()  # .depth: the spans open on this thread


def reset():
    with _lock:
        _acc.clear()


def snapshot(round_to: int = 4):
    with _lock:
        items = list(_acc.items())
    return {k: round(v, round_to) for k, v in sorted(items, key=lambda kv: -kv[1])}


@contextmanager
def recording():
    """Yields a list that gathers every span that ends, on any thread, while
    the block is open: (name, start, end, thread id, depth) in the order
    they end, start and end on `CLOCK`."""
    spans = []
    with _lock:
        _recordings.append(spans)
    try:
        yield spans
    finally:
        with _lock:
            _recordings[:] = [r for r in _recordings if r is not spans]


@contextmanager
def stage(name: str, block=None):
    depth = getattr(_local, "depth", 0)
    _local.depth = depth + 1
    note = record_function(name) if torch.autograd._profiler_enabled() else None
    if note is not None:
        note.__enter__()
    t0 = CLOCK()
    try:
        yield
    finally:
        if isinstance(block, torch.Tensor) and block.is_cuda:
            torch.cuda.synchronize(block.device)
        t1 = CLOCK()
        if note is not None:
            note.__exit__(None, None, None)
        _local.depth = depth
        with _lock:
            _acc[name] += t1 - t0
            if _recordings:
                span = (name, t0, t1, threading.get_ident(), depth)
                for spans in _recordings:
                    spans.append(span)
