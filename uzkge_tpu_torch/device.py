"""Where the port's tensors live.

The port is written for one NVIDIA card: every public entry point runs there
unless its caller asks for the CPU (`device="cpu"`, as the CPU tests do).
There is no silent fallback: asking for the card where there is none raises.
"""

import torch


def resolve(device=None) -> torch.device:
    """None -> the current CUDA card; anything else -> torch.device(device),
    a CUDA device without an index taking the current one, so that it
    compares equal to the device of the tensors made on it.  Raises if that
    needs a card and CUDA is not available (a CUDA device with an index, as
    tensors report theirs, passes through: torch raises on its first use
    where there is no card)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "uzkge_tpu_torch runs on a CUDA card by default and none is available; "
            "pass device='cpu' to run the plain torch versions on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
