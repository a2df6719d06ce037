"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU.  A CUDA request without a GPU raises.

    The port never falls back to the CPU on its own: CPU runs (the tests)
    pass ``device="cpu"`` explicitly.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested (the default) but torch sees none; "
            "pass device='cpu' to run on the CPU")
    return dev
