"""fused_frame_ms.dec (ms per frame): dec.device_frame's
DeviceFrameDecoder.run (pixel core and filter pack) per decoded frame,
the device work it queued included."""
from harness.readers import span_ms_per_frame

SPANS = {"dec.device_frame": [
    "thor_tpu_torch.dec.device_frame:DeviceFrameDecoder.run"]}


def read(ctx):
    return span_ms_per_frame(ctx, "dec.device_frame")
