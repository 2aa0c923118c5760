"""setup_s (s): process start to the window's start: imports, the CUDA
context, the port's libraries (built on a checkout's first run), the
inputs and the warm-up (host clock)."""


def read(ctx):
    return ctx.setup_s
