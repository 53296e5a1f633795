"""Device kernels that start inside the quotient's evaluation
(`r3_t_kernel`, which ends on a device sync), a proof of the traced window;
memory copies and sets are left out.  None without device events."""

SPAN = "r3_t_kernel"


def read(run):
    t = run.trace
    if t is None or not t.events or not run.stages:
        return None
    spans = [(a, b) for name, a, b in t.spans if name == SPAN]
    if not spans:
        return None
    n = sum(1 for a, _, name in t.events if not name.startswith(("Memcpy", "Memset"))
            and any(lo <= a < hi for lo, hi in spans))
    return n / len(run.stages)
