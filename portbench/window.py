"""What a measured window records, whatever drives it.

A driver (:mod:`portbench.drivers`) issues its traffic for the window's
seconds and returns a :class:`Window`: every request's latency, the
host time of each call into the program, and the requests whose outputs
the check keeps.  The end-to-end and dispatch readers
(``portbench/metrics/``) read only this record, so a new driver needs
no new reader.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch


@dataclasses.dataclass
class Kept:
    """A request whose outputs the check judges: its index in the
    window, the input it read (``slot``) and the tensors it produced,
    in the order its driver's ``compare`` reads them."""

    index: int
    slot: int
    tensors: List[torch.Tensor]


@dataclasses.dataclass
class Window:
    seconds: float                 # first enqueue to the last completion
    latencies_s: List[float]       # every request, in order
    calls_s: List[float]           # host time of each call not traced
    kept: List[Kept]

    @property
    def completed(self) -> int:
        return len(self.latencies_s)

    @property
    def kept_bytes(self) -> int:
        """Device bytes the check's kept outputs hold."""
        return sum(t.numel() * t.element_size()
                   for k in self.kept for t in k.tensors)


class _HostDone:
    """Completion marker on the CPU, where every call has finished when
    it returns."""

    def record(self):
        pass

    def synchronize(self):
        pass


def done_marker(device_type: str):
    """An event that marks where a request's work ends on the stream."""
    return torch.cuda.Event() if device_type == "cuda" else _HostDone()


def split_rows(data: torch.Tensor, n: int) -> List[torch.Tensor]:
    """``n`` equal views of ``data`` along its first axis."""
    if data.shape[0] % n:
        raise ValueError(f"{data.shape[0]} rows do not split into {n} "
                         f"equal requests")
    return list(torch.chunk(data, n, dim=0))
