"""The Groth16 G1 MSMs over the a, b_g1, l and h queries on the device
(`g16_msm_a`, `g16_msm_b1`, `g16_msm_l`, `g16_msm_h`: from the scalars'
upload to host affine points), seconds a proof of the window; None where
the program has no such spans."""

SPANS = ("g16_msm_a", "g16_msm_b1", "g16_msm_l", "g16_msm_h")


def read(run):
    if not any(n in s for s in run.stages for n in SPANS):
        return None
    return run.stage_mean(SPANS)
