"""One module per application the benchmark drives, named by a
configuration's `app`.  Each has a `Session(config, traffic, device)` with
`setup()`, `request(i)`, `serve(request)`, `accept(request, answer)`,
`judge(served)` and `release()`."""

import os

import torch


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def published(root: str, name: str) -> bytes:
    """A file of the reference project's published parameters, which the
    program reads from the same place."""
    with open(os.path.join(root, "uzkge_tpu", "parameters", name), "rb") as f:
        return f.read()
