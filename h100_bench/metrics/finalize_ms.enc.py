"""finalize_ms.enc (ms per frame): enc.turbo_final's finalize_core per
coded frame, the device work it queued included."""
from harness.readers import span_ms_per_frame

SPANS = {"enc.turbo_final": ["thor_tpu_torch.enc.turbo_final:finalize_core"]}


def read(ctx):
    return span_ms_per_frame(ctx, "enc.turbo_final")
