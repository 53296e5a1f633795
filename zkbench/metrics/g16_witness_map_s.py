"""The Groth16 witness map (`g16_witness_map`: the rows' sums on the host,
then the QAP's NTTs on the device and h back on the host), seconds a proof
of the window; None where the program has no such span."""


def read(run):
    if not any("g16_witness_map" in s for s in run.stages):
        return None
    return run.stage_mean(("g16_witness_map",))
