"""intra_idle_ms.dec (ms per frame): device-idle time whose gap falls
inside the port's own span dec.intra_waves (the host loop that issues
the intra wave scan's segments, dec/device_frame.py:_intra_waves)."""
from harness.program import idle_ms_per_frame


def read(ctx):
    return idle_ms_per_frame(ctx, "dec.intra_waves")
