"""parse_ms.dec (ms per frame): the C block parser's call,
dec.native_parse.parse_frame, per decoded frame."""
from harness.readers import span_ms_per_frame

SPANS = {"dec.native_parse": [
    "thor_tpu_torch.dec.native_parse:parse_frame"]}


def read(ctx):
    return span_ms_per_frame(ctx, "dec.native_parse")
