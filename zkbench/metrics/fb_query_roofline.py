"""The fixed-base query's share of its roofline, in %: the least time of
every query of the traced window (yardstick.bounds.fixed_base_query_s, from
its scalars' nonzero signed digits in the configuration's window) over the
device time of the query's kernels."""

from ..yardstick.bounds import fixed_base_query_s

KERNELS = ("fb_select_kernel", "fb_pair_den_kernel", "fb_pair_combine_kernel", "fb_fold_kernel",
           "fq_inv_down_kernel", "fq_inv_root_kernel", "fq_inv_up_kernel", "fp_mont_mul_kernel")


def read(run):
    t = run.trace
    if t is None or not t.fb_queries:
        return None
    device_s = t.kernel_seconds(KERNELS)
    if not device_s:
        return None
    bound = sum(fixed_base_query_s(P, n, nz, run.rate) for P, n, nz in t.fb_queries)
    return 100.0 * bound / device_s
