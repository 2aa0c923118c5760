"""decode_fps (frames/s): decoded frames of the window's whole streams,
summed over streams, over the window's whole time (host clock)."""
from harness.readers import frames_per_s


def read(ctx):
    return frames_per_s(ctx, "decode")
