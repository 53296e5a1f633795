"""`ntt_pass`'s share of its roofline, in %: the least time of every pass of
the traced window at its shape (yardstick.bounds.ntt_pass_s) over the
kernel's device time."""

from ..yardstick.bounds import ntt_pass_s

KERNELS = ("ntt_pass_kernel",)


def read(run):
    t = run.trace
    if t is None or not t.ntt_passes:
        return None
    device_s = t.kernel_seconds(KERNELS)
    if not device_s:
        return None
    return 100.0 * sum(ntt_pass_s(*shape, run.rate) for shape in t.ntt_passes) / device_s
