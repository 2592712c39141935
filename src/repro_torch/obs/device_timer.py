"""Device time of a ``device=True`` span: a CUDA timing event recorded on
the current stream at the span's entry and another at its exit; the
stream time between them is the span's ``device_ms`` once the tracer
drains it.  The one torch-touching part of ``obs``: ``trace`` imports it
only when a device span records.
"""
from __future__ import annotations

from typing import Optional

import torch


class _Timer:
    __slots__ = ("stream", "begin", "end")

    def __init__(self, stream):
        self.stream = stream
        self.begin = torch.cuda.Event(enable_timing=True)
        self.begin.record(stream)
        self.end = None

    def stop(self):
        self.end = torch.cuda.Event(enable_timing=True)
        self.end.record(self.stream)

    def ms(self) -> float:
        """Stream milliseconds from entry to exit (waits for the exit
        event to complete)."""
        self.end.synchronize()
        return self.begin.elapsed_time(self.end)


def start() -> Optional[_Timer]:
    """A timer started on the current CUDA stream; None when CUDA has
    not started in this process (no device work to time)."""
    if not torch.cuda.is_initialized():
        return None
    return _Timer(torch.cuda.current_stream())
