"""Seconds from the process's start to the start of the timed window."""


def read(run):
    return run.setup_s
