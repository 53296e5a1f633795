"""The window's wall time over the proofs completed in it (one client, each
proof sent when the last came back)."""


def read(run):
    return run.window_s / run.completed if run.completed else None
