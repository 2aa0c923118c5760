"""plan_emit_ms.enc (ms per frame): host time in the port's spans
enc.plan (the C plan walk) and enc.emit (the C syntax emit) of the
turbo encoder."""
from harness.program import host_ms_per_frame


def read(ctx):
    return host_ms_per_frame(ctx, "enc.plan", "enc.emit")
