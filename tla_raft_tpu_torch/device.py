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


# Device-to-host reads, counted by what they are for: each ``fetch`` is
# one read (all its copies, then one wait), so a level's reads can be
# reported beside its launches.
READS: dict = {}
_PINNED: dict = {}


def fetch(*tensors: torch.Tensor, what: str = "read") -> list:
    """Copy ``tensors`` to the host in one counted read: numpy arrays.

    On the card the copies go to pinned buffers kept per (``what``,
    position) and are waited for once; the arrays are views of those
    buffers, valid until the next ``fetch`` with the same ``what``.  On the
    CPU the arrays are copies."""
    READS[what] = READS.get(what, 0) + 1
    if tensors[0].device.type != "cuda":
        return [t.detach().numpy().copy() for t in tensors]
    bufs = []
    for i, t in enumerate(tensors):
        buf = _PINNED.get((what, i))
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            _PINNED[(what, i)] = buf
        buf.copy_(t, non_blocking=True)
        bufs.append(buf)
    torch.cuda.current_stream().synchronize()
    return [b.numpy() for b in bufs]
