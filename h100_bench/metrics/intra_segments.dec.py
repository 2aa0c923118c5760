"""intra_segments.dec (segments per frame): the intra wave segments the
port issued, the count `segments` on its span dec.intra_waves."""
from harness.program import count_per_frame


def read(ctx):
    return count_per_frame(ctx, "dec.intra_waves", "segments")
