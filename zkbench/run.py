"""One run of one cell of the port's benchmark.

    python3 zkbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names its configuration (`zkbench/configs/<config>.json`, whose
`app` names its module in `zkbench/apps/`) and its traffic
(`zkbench/workloads/<cell>.json`); every metric is read by
`zkbench/metrics/<metric>.py`.  A run builds or loads the port's kernel
library, sets up, serves the traffic's warm-up requests, then serves
requests back to back for `--seconds` and finishes the request under way.
With `--trace 1` the window runs under torch.profiler.  Once the window has
closed and the program's state is freed, the reference judges every answer
of the run.  The last line of standard output is the result as one JSON
object; the numbers judged, each beside its limit, are the last lines of
standard error.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from collections import defaultdict  # noqa: E402
from contextlib import contextmanager  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "uzkge_tpu")  # top-level names, compared whole
R_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617
R_INV = pow(1 << 256, -1, R_MOD)  # Montgomery form, 8 x 32-bit limbs


def process_age() -> float:
    """Seconds since this process started (Linux), else since this module
    was loaded."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_START


def forbidden_modules():
    """Loaded modules whose top-level name is a forbidden one (a None entry
    only blocks an import)."""
    loaded = {m.split(".")[0] for m, mod in list(sys.modules.items()) if mod is not None}
    return sorted(loaded & set(FORBIDDEN))


def load_cell(root: str, name: str):
    """(benchmark, cell, configuration, traffic spec) of the cell `name`."""
    from zkbench import traffic

    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    spec = traffic.load(os.path.join(root, "zkbench", "workloads", f"{name}.json"))
    return bench, cell, config, spec


def cell_metrics(bench: dict, cell: dict, trace: bool):
    """The metric entries a run of `cell` reports: its end-to-end metrics,
    or with a trace its per-layer metrics."""
    e2e = [m for m in bench["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell["name"] in m.get("workloads", [cell["name"]] if m["moves"] in moved else [])]


def environment():
    """The program's caches, at fixed paths inside the checkout."""
    cache = os.path.join(HERE, "cache")
    os.environ["UZKGE_PARAMS_CACHE"] = os.path.join(cache, "params")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    for d in ("params", "triton"):
        os.makedirs(os.path.join(cache, d), exist_ok=True)


def product_rate(device):
    """Montgomery products/s at the card's peak integer rate, from its SM
    count and the maximum SM clock it reports; None off the card."""
    import torch

    from zkbench.yardstick.bounds import product_rate as rate

    if device.type != "cuda":
        return None
    try:
        mhz = subprocess.run(
            ["nvidia-smi", "-i", str(device.index or 0), "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60).stdout.split()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None
    return rate(torch.cuda.get_device_properties(device).multi_processor_count, float(mhz))


class StageRecorder(defaultdict):
    """Stands in for the program's stage-time accumulator
    (`utils/stagetimer.py`'s `_acc`): it accumulates alike, and while
    `spans` is a list it also keeps each stage's (name, start, end) on the
    host clock."""

    def __init__(self):
        super().__init__(float)
        self.spans = None

    def __setitem__(self, name, value):
        if self.spans is not None:
            now = time.perf_counter()
            self.spans.append((name, now - (value - self.get(name, 0.0)), now))
        super().__setitem__(name, value)


class Trace:
    """The device's side of a traced window, on the host's clock (seconds)."""

    def __init__(self, events, lo, hi, spans, fb_queries, ntt_passes):
        from zkbench.yardstick import trace as tr

        self.events = [(a, b, n) for a, b, n in events if b > lo and a < hi]
        self.lo, self.hi, self.spans = lo, hi, spans
        self.window_s = hi - lo
        self.busy_s = tr.busy([(a, b) for a, b, _ in self.events], lo, hi)
        self.fb_queries = fb_queries
        self.ntt_passes = ntt_passes

    def kernel_seconds(self, names) -> float:
        pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
        return sum(b - a for a, b, n in self.events if pat.search(n))

    def breakdown(self) -> dict:
        from zkbench.yardstick import trace as tr

        gaps = tr.gaps([(a, b) for a, b, _ in self.events], self.lo, self.hi)
        idle = sorted(tr.idle_by_stage(gaps, self.spans).items(), key=lambda kv: -kv[1])
        return {"device_ops": [[n[:160], s] for n, s in tr.top_by_name(self.events, 10)],
                "idle_gaps": [[n, s] for n, s in idle[:10]]}


class Run:
    """What the metric readers read."""

    def __init__(self, config, rate):
        self.config, self.rate = config, rate
        self.setup_s = self.window_s = None
        self.completed = 0
        self.peak_bytes = 0
        self.stages = []  # per proof of the window: {stage: seconds}
        self.trace = None

    def stage_mean(self, names):
        if not self.stages:
            return None
        return sum(sum(s.get(n, 0.0) for n in names) for s in self.stages) / len(self.stages)


@contextmanager
def observe(record: bool):
    """While `record`, keeps the inputs of every fixed-base query (its
    scalars, copied on the device, and the window width of the table that
    serves it) and the shape of every `ntt_pass`; once it closes, also the
    launches of their kernels that the program itself counted meanwhile
    (`kernels.LAUNCHES`), one a query and one a pass."""
    seen = {"queries": [], "passes": [], "launched": {}}
    if not record:
        yield seen
        return
    from uzkge_tpu_torch import kernels
    from uzkge_tpu_torch.msm.fixed_base import FixedBaseTable
    from uzkge_tpu_torch.ntt import cuda_ntt

    query, ntt_pass = FixedBaseTable.query, cuda_ntt.ntt_pass

    def query_seen(self, scalars):
        seen["queries"].append((scalars.detach().clone(), getattr(self, "c", None)))
        return query(self, scalars)

    def ntt_seen(x, tw, pre=None, post=None, const=None):
        OUT, S, IN = x.shape[:3]
        seen["passes"].append((OUT, S, IN, int(pre is not None), int(post is not None),
                               int(const is not None)))
        return ntt_pass(x, tw, pre, post, const)

    before = dict(kernels.LAUNCHES)
    FixedBaseTable.query, cuda_ntt.ntt_pass = query_seen, ntt_seen
    try:
        yield seen
    finally:
        FixedBaseTable.query, cuda_ntt.ntt_pass = query, ntt_pass
        seen["launched"] = {k: kernels.LAUNCHES.get(k, 0) - before.get(k, 0)
                            for k in ("fb_select", "ntt_pass")}


def agreed(calls, launched: int, what: str):
    """`calls` where as many as the program counted launches of their
    kernel, else None, and why on standard error: a call that reaches the
    kernel by a route not observed would leave its roofline's bound short."""
    if len(calls) != launched:
        log(f"{what}: {len(calls)} calls observed but {launched} launches counted by the "
            "program; its roofline is left out")
        return None
    return calls


def fb_query_work(seen):
    """[(P, n, nonzero signed digits)] of the observed queries, each in its
    table's window width; None where the calls and the program's count of
    `fb_select` launches differ or a table has no window width."""
    calls = agreed(seen["queries"], seen["launched"].get("fb_select", 0), "fixed-base queries")
    if calls is None:
        return None
    if any(c is None for _, c in calls):
        log("fixed-base queries: a table without a window width c; its roofline is left out")
        return None
    return [query_work(s, c) for s, c in calls]


def query_work(scalars, c: int):
    """(P, n, nonzero signed digits) of one query's Montgomery scalars."""
    import numpy as np

    from zkbench.yardstick.bounds import signed_digits_nonzero

    P, n = scalars.shape[:2]
    raw = scalars.cpu().numpy().astype(np.uint32).tobytes()
    vals = [int.from_bytes(raw[i:i + 32], "little") * R_INV % R_MOD
            for i in range(0, len(raw), 32)]
    return P, n, signed_digits_nonzero(vals, c)


def device_events(prof, t0_host: float):
    """The profile's device events as (start, end, name) on the host clock,
    aligned by the `zkbench.window` annotation entered at `t0_host`."""
    from torch.autograd import DeviceType

    evs = prof.profiler.kineto_results.events()
    marks = [e.start_ns() for e in evs if e.name() == "zkbench.window"
             and e.device_type() == DeviceType.CPU]
    if not marks:
        raise RuntimeError("the profile lost the window's annotation")
    off = marks[0] / 1e9 - t0_host
    return [(e.start_ns() / 1e9 - off, e.end_ns() / 1e9 - off, e.name()) for e in evs
            if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, root: str = ROOT,
             wrap_session=None):
    """One run of the cell `name` on `device`.  Returns (result, checks).
    `wrap_session`, given, wraps the app's session before set-up (tests
    plant faults with it)."""
    import torch

    from uzkge_tpu_torch.utils import stagetimer

    bench, cell, config, spec = load_cell(root, name)
    from zkbench.traffic import Traffic

    tr = Traffic(spec, seed)
    app = importlib.import_module(f"zkbench.apps.{config['app']}")
    session = app.Session(config, tr, device, root)
    if wrap_session is not None:
        session = wrap_session(session)
    cuda = device.type == "cuda"

    t = time.perf_counter()
    if cuda:
        from uzkge_tpu_torch import kernels

        kernels.library()
    lib_s = time.perf_counter() - t
    session.setup()
    rec = StageRecorder()
    stagetimer._acc = rec

    served = []

    def serve(i):
        req = session.request(i)
        before = dict(rec)
        try:
            ans = session.serve(req)
        except Exception:  # a failed request is counted, and the run goes on
            log(f"request {i} failed:\n{traceback.format_exc()}")
            ans = None
        if ans is not None:
            session.accept(req, ans)
        served.append((req, ans))
        return {k: v - before.get(k, 0.0) for k, v in rec.items() if v != before.get(k, 0.0)}

    t = time.perf_counter()
    for i in range(spec["warmup"]):
        serve(i)
    warm_s = time.perf_counter() - t

    run = Run(config, product_rate(device))
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
        rec.spans = []
    with observe(trace and cuda) as seen:
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        run.setup_s = process_age()
        ctx = record_function("zkbench.window") if trace else None
        if ctx is not None:
            ctx.__enter__()
        i = spec["warmup"]
        while True:  # the first request starts at t0, the last before `seconds`
            run.stages.append(serve(i))
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
        if ctx is not None:
            ctx.__exit__(None, None, None)
    run.window_s = t1 - t0
    window = served[spec["warmup"]:]
    run.completed = sum(ans is not None for _, ans in window)
    if cuda:
        run.peak_bytes = torch.cuda.max_memory_allocated(device)
    if prof is not None:
        prof.__exit__(None, None, None)
        t = time.perf_counter()
        events = device_events(prof, t0) if cuda else []
        fb = fb_query_work(seen)
        passes = agreed(seen["passes"], seen["launched"].get("ntt_pass", 0), "ntt_pass calls")
        run.trace = Trace(events, t0, t1, rec.spans, fb or [], passes or [])
        del prof, seen
        log(f"trace reduced in {time.perf_counter() - t:.1f} s: {len(events)} device events")
    stagetimer._acc = defaultdict(float)

    session.release()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    verdicts, checks = session.judge(served)
    judge_s = time.perf_counter() - t
    failed = sum(ans is None or not ok for (_, ans), ok in zip(window, verdicts[spec["warmup"]:]))

    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        reader = importlib.import_module(f"zkbench.metrics.{m['name']}")
        v = reader.read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell["chips"], "memory_peak_bytes": run.peak_bytes}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    correct = bool(window) and failed == 0 and all(v <= lim for v, lim in checks.values())
    result = {"correct": correct, "attempted": len(window), "failed": failed,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    pieces = {"kernel_library": lib_s, **session.pieces, "warmup_requests": warm_s,
              "judge": judge_s}
    result["setup_pieces"] = pieces
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    environment()
    import torch

    _, cell, _, _ = load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"this cell needs {cell['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda", 0)
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device)
    found = forbidden_modules()
    if found:
        log(f"the run loaded {', '.join(found)}: no result")
        return 3
    for k, (v, lim) in checks.items():
        log(f"check {k} {v} limit {lim}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
