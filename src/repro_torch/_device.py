"""Device resolution shared by every entry point of the port.

``None`` means the card: the port runs on CUDA unless the caller names the
CPU explicitly (as the tests do). A missing card is an error, never a quiet
CPU run.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

# batch entries that hold token ids: int64 on the device, as embedding and
# gather take them
_IDS = ("tokens", "labels")


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return dev


def batch_on_device(batch: dict, device: torch.device) -> dict:
    """A batch (numpy arrays, lists or tensors) on ``device``: token ids and
    labels as int64, every other entry (``loss_mask``, ``patch_embeds``,
    ``frame_embeds``) in its own dtype."""
    return {name: torch.as_tensor(v, device=device).long() if name in _IDS
            else torch.as_tensor(v, device=device) for name, v in batch.items()}
