"""thor_tpu_torch: the Thor decoder on PyTorch and CUDA (NVIDIA Hopper).

A port of thor_tpu, which stays the reference.  The port imports nothing
of thor_tpu: it keeps its own copy of the host tier that its decode runs
(C block parser, bit reader, tables, frame buffers, the numpy spec of
inter and filters, the frame driver), and its device
tier is torch with hand-written CUDA kernels.  Entry points decode on the
CUDA card unless the caller asks for the CPU (`device="cpu"`).

Layout:
- tables.py: the normative tables, and the same as device tensors
  (to_device)
- bitstream.py, frame.py, io_y4m.py, qmtx.py (with qm_tables.npz), spec/,
  _native/, dec/native_parse.py, dec/decoder.py, cli.py: the host tier,
  copied from thor_tpu (what the decode runs of it)
- ops/: torch functions and CUDA kernel wrappers, bit-exact with
  thor_tpu/ops (mc.py wraps csrc/*.cu; tempinterp.py is temporal
  interpolation)
- dec/: the frame decoder on the device and the decoder entry point
- models/pipeline.py, entry.py: the decode pipeline over 16x16 inter
  tiles and its forward step on one card
- csrc/, kernels/: CUDA C++ sources for sm_90a and their build/binding
"""
from .dec.decoder import decode_stream  # noqa: F401
