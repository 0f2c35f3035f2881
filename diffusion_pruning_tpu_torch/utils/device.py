"""Device selection for the port's entry points: the card unless the caller
asks for the CPU, and never a silent fallback."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means the CUDA card and raises when there is none; anything
    else is taken as given (`"cpu"` for tests)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                               "plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
