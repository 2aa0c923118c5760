"""intra_idle_ms.enc (ms per frame): device-idle time whose gap falls
inside the port's own span enc.intra_waves (the turbo finalizer's host
loop over the intra wave segments, enc/turbo_final.py)."""
from harness.program import idle_ms_per_frame


def read(ctx):
    return idle_ms_per_frame(ctx, "enc.intra_waves")
