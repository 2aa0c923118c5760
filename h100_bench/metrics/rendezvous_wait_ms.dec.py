"""rendezvous_wait_ms.dec (ms per frame): host time in the port's span
dec.rendezvous (each Rendezvous.wait of a lockstep stream thread,
dec/multistream.py), summed over the stream threads."""
from harness.program import host_ms_per_frame


def read(ctx):
    return host_ms_per_frame(ctx, "dec.rendezvous")
