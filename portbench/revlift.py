"""What the readers of the reversible lifting kernel (RL) share: its
share of the bytes roofline, read from the program's ``revlift.*``
spans in a traced run.

The numerator is the transform's own bytes, as the ``dwt_*_roofline``
readers count them (:func:`portbench.peaks.transform_bytes` of one
request at the configuration's dtype), once per complete call of the
harness's span (``portbench.forward`` or ``portbench.inverse``); the
denominator is the device time of the operations launched inside the
program's span of that direction (``revlift.forward`` or
``revlift.inverse``) within those calls.  Where the program has no such
span (a program without the reversible path), it reads nothing.
"""
from __future__ import annotations

from typing import Optional

from portbench import peaks, program


def roofline_pct(reading, call_span: str, kernel_span: str
                 ) -> Optional[float]:
    s = reading.summary
    p = program.of(reading)
    if s is None or p is None:
        return None
    calls, _ = s.span_seconds(call_span)
    seconds = p.matching(kernel_span).device_s
    if calls == 0 or seconds <= 0:
        return None
    least = peaks.bytes_bound_s(
        calls * peaks.transform_bytes(reading.request_samples,
                                      reading.itemsize))
    return 100.0 * least / seconds
