"""The Groth16 G2 MSM over the b_g2 query, on the host (`g16_msm_b2_host`),
seconds a proof of the window; None where the program has no such span."""


def read(run):
    if not any("g16_msm_b2_host" in s for s in run.stages):
        return None
    return run.stage_mean(("g16_msm_b2_host",))
