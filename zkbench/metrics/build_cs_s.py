"""The app's circuit build (`r0_build_cs`), seconds a proof of the window."""


def read(run):
    return run.stage_mean(("r0_build_cs",))
