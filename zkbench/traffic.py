"""The one traffic generator.  A traffic mix is a file of parameters,
`zkbench/workloads/<cell>.json`:

    warmup      requests served in set-up, before the window
    next_input  "previous_output": request i takes the answer of request
                i - 1 as its input (turns of one game); "fresh": every
                request draws new inputs
    about       what the mix stands for, in words

The loop is closed (one client sends the next request when the last answer
came back), and the reference judges every answer of the run.
Every random draw comes from the run's seed through `rng(purpose, i)`, so
the same seed gives the same inputs, whatever else the run does.
"""

import hashlib
import json
import os
import random

NEXT_INPUT = ("previous_output", "fresh")


def load(path: str) -> dict:
    with open(path) as f:
        spec = json.load(f)
    if spec.get("next_input") not in NEXT_INPUT:
        raise ValueError(f"{os.path.basename(path)}: next_input must be one of {NEXT_INPUT}")
    if not isinstance(spec.get("warmup"), int) or spec["warmup"] < 1:
        raise ValueError(f"{os.path.basename(path)}: warmup must be a whole number >= 1")
    return spec


class Traffic:
    def __init__(self, spec: dict, seed: int):
        self.spec = spec
        self.seed = int(seed)

    @property
    def chained(self) -> bool:
        return self.spec["next_input"] == "previous_output"

    def rng(self, purpose: str, i: int = 0) -> random.Random:
        digest = hashlib.sha256(f"{self.seed}/{purpose}/{i}".encode()).digest()
        return random.Random(int.from_bytes(digest, "big"))
