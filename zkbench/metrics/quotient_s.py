"""The quotient's evaluation on the coset (`r3_t_kernel`, which waits for
the device), seconds a proof of the window."""


def read(run):
    return run.stage_mean(("r3_t_kernel",))
