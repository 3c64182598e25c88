"""Default-device resolution for the port's entry points.

The port runs on the card. The CPU is used only when the caller asks for it
(``device="cpu"``), as the tests do; with no card and no explicit request the
entry points raise instead of silently running somewhere else.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device
