"""frame_prep_ms.dec (ms per frame): host time in the port's span
dec.frame_prep (DeviceFrameDecoder.run up to pixel_core: the wave
segments, the filter masks and stream reads, the plan stacks)."""
from harness.program import host_ms_per_frame


def read(ctx):
    return host_ms_per_frame(ctx, "dec.frame_prep")
