"""batch_exec_ms.dec (ms per frame): host time in the port's span
dec.batch_exec (ShardedExecutor._run on the lockstep decode's thread 0:
the uploads, one frame_exec_batch for every stream, the pull)."""
from harness.program import host_ms_per_frame


def read(ctx):
    return host_ms_per_frame(ctx, "dec.batch_exec")
