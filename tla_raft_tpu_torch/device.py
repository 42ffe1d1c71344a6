"""The one rule for choosing a device: ``None`` means the card.

Every entry point of the package takes ``device=None`` and resolves it
here, so nothing runs on the CPU unless the caller names it, and nothing
falls back to the CPU when CUDA is missing.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises if a CUDA device is asked for and
    there is none (there is no quiet CPU fallback)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the checker runs on the card by default; "
            "pass device='cpu' to run the plain torch versions on the CPU"
        )
    return dev
