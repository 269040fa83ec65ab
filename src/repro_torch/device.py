"""Device resolution for the port's entry points: the card by default, the
CPU only when the caller names it."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` -> ``torch.device``. Raises when a CUDA device is asked
    for (the default) and no GPU is visible: the port never drops to the
    CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was requested but torch sees no GPU; pass "
                "device='cpu' to run the plain torch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or "
                         "'cpu'")
    return dev
