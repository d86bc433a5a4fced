"""Device resolution shared by every entry point of the port.

``None`` means the card: the port runs on CUDA unless the caller names the
CPU explicitly (as the tests do). A missing card is an error, never a quiet
CPU run.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return dev
