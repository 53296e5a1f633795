"""The commits' blinding on the host (`kzg_blind`, `KZG.apply_blind_factors`),
seconds a proof of the window; None where the program has no such span."""


def read(run):
    if not any("kzg_blind" in s for s in run.stages):
        return None
    return run.stage_mean(("kzg_blind",))
