"""encode_fps (frames/s): coded frames of the window's whole clips over
the window's whole time (host clock)."""
from harness.readers import frames_per_s


def read(ctx):
    return frames_per_s(ctx, "encode")
