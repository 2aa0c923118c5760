"""decide_ms.enc (ms per frame): enc.turbo's decide_frame per coded
frame, the device work it queued included."""
from harness.readers import span_ms_per_frame

SPANS = {"enc.turbo": ["thor_tpu_torch.enc.turbo:decide_frame"]}


def read(ctx):
    return span_ms_per_frame(ctx, "enc.turbo")
