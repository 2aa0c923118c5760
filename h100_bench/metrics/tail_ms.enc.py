"""tail_ms.enc (ms per frame): enc.encoder's Encoder._encode_frame_tail
(deblock, CLPF search and application, the reference ring) per coded
frame, the device work it queued included."""
from harness.readers import span_ms_per_frame

SPANS = {"enc.encoder": [
    "thor_tpu_torch.enc.encoder:Encoder._encode_frame_tail"]}


def read(ctx):
    return span_ms_per_frame(ctx, "enc.encoder")
