"""clpf_apply_ms.enc (ms per frame): host time in the port's span
enc.clpf_apply (Encoder._clpf_apply: the CLPF decisions and the filter
applied on the host, in the frame tail)."""
from harness.program import host_ms_per_frame


def read(ctx):
    return host_ms_per_frame(ctx, "enc.clpf_apply")
