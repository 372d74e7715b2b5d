"""Device resolution for the port's entry points.

Entry points take an explicit `device` that defaults to "cuda". A CUDA
request on a machine without a usable GPU raises instead of quietly running
on the CPU: the CPU path exists for tests and must be asked for by name.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain torch path on the CPU"
        )
    return dev
