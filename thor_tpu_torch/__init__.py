"""thor_tpu_torch: the Thor decoder on PyTorch and CUDA (NVIDIA Hopper).

A port of thor_tpu's device tier; thor_tpu stays the reference.  The host
tier (C block parser, syntax walk, tables, frame buffers) is thor_tpu's
own code, loaded without JAX (_host.py).

Layout:
- tables.py: the normative tables as device tensors (to_device)
- ops/: torch functions and CUDA kernel wrappers, bit-exact with
  thor_tpu/ops (mc.py wraps csrc/*.cu)
- dec/: the frame decoder on the device and the decoder entry point
- csrc/, kernels/: CUDA C++ sources for sm_90a and their build/binding
"""
from . import _host  # noqa: F401  (first: sets up the host-tier alias)
from .dec.decoder import decode_stream  # noqa: F401
