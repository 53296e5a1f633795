"""The reveal circuit's build on the host (`g16_synthesize`: sk * G and
sk * e1, then ark-r1cs-std's gates replayed by `groth16/ark_r1cs.py`),
seconds a proof of the window; None where the program has no such span."""


def read(run):
    if not any("g16_synthesize" in s for s in run.stages):
        return None
    return run.stage_mean(("g16_synthesize",))
