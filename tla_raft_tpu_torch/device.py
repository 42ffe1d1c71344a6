"""The one rule for choosing a device: ``None`` means the card.

Every entry point of the package takes ``device=None`` and resolves it
here, so nothing runs on the CPU unless the caller names it, and nothing
falls back to the CPU when CUDA is missing.
"""

from __future__ import annotations

import time

import torch

from .analysis import devprof as _devprof
from .obs import telemetry as _obs


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


# Device-to-host reads, counted by what they are for: each read is one count
# (all its copies, then one wait), so a level's reads can be reported beside
# its launches.  A read starts (``fetch_start``: the copies queued on the
# current stream and an event behind them) and completes (``fetch_complete``:
# the event waited for); ``fetch`` is the two at once.
READS: dict = {}
_PINNED: dict = {}


class PendingFetch:
    """A started read: its host buffers and the events its copies end at,
    one a source device (none on the CPU, where the copies are made at the
    start)."""

    __slots__ = ("bufs", "events")

    def __init__(self, bufs: list, events: list):
        self.bufs, self.events = bufs, events


def fetch_start(*tensors: torch.Tensor, what: str = "read",
                slot: str | None = None) -> PendingFetch:
    """Start one counted read of ``tensors``.  On the card the copies go to
    pinned buffers kept per (``slot`` or ``what``, position), queued on the
    current stream in its order (a later launch that overwrites a source
    runs after them); on the CPU the copies are made here."""
    READS[what] = READS.get(what, 0) + 1
    if tensors[0].device.type != "cuda":
        return PendingFetch([t.detach().numpy().copy() for t in tensors], [])
    key = what if slot is None else slot
    bufs = []
    for i, t in enumerate(tensors):
        buf = _PINNED.get((key, i))
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            _PINNED[(key, i)] = buf
        buf.copy_(t, non_blocking=True)  # on the source device's current stream
        bufs.append(buf)
    events = []
    for dev in dict.fromkeys(t.device for t in tensors):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)
    return PendingFetch(bufs, events)


def fetch_complete(pending: PendingFetch) -> list:
    """Wait for a started read: numpy arrays (on the card, views of its
    pinned buffers, valid until a read of the same slot starts again).
    With a telemetry hub installed the wait and the bytes are published
    (``fetch``); a ``--profile`` capture counts the read as one window."""
    t0 = time.perf_counter() if _obs.CURRENT is not None else 0.0
    if pending.events:
        for ev in pending.events:
            ev.synchronize()
        out = [b.numpy() for b in pending.bufs]
    else:
        out = pending.bufs
    if _obs.CURRENT is not None:
        _obs.fetch_done(time.perf_counter() - t0, sum(int(a.nbytes) for a in out))
    _devprof.profile_tick()
    return out


def fetch(*tensors: torch.Tensor, what: str = "read") -> list:
    """Copy ``tensors`` to the host in one counted read: numpy arrays.

    On the card the copies go to pinned buffers kept per (``what``,
    position) and are waited for once; the arrays are views of those
    buffers, valid until the next ``fetch`` with the same ``what``.  On the
    CPU the arrays are copies."""
    return fetch_complete(fetch_start(*tensors, what=what))
