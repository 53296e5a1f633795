"""The prover's commit stages (the four rounds' Lagrange commits, the host's
blinding, the openings), seconds a proof of the window."""


def read(run):
    return run.stage_mean(("r1_commit", "r2_commit", "r3_t_split_commit", "r5_openings"))
