"""The commits' MSMs as the host sees them (`kzg_msm`: from the digit recode
and the launches to host affine points), seconds a proof of the window; None
where the program has no such span."""


def read(run):
    if not any("kzg_msm" in s for s in run.stages):
        return None
    return run.stage_mean(("kzg_msm",))
