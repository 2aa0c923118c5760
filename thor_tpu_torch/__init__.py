"""thor_tpu_torch: the Thor decoder on PyTorch and CUDA (NVIDIA Hopper).

A port of thor_tpu, which stays the reference.  The port imports nothing
of thor_tpu: it keeps its own copy of the host tier that its decode runs
(C block parser, bit reader, tables, frame buffers, the numpy spec of
inter, intra, transform, CFL and filters, the decoder with its Python
syntax walk), and its device tier is torch with hand-written CUDA
kernels.  The decoder does all that thor_tpu's does: every stream decodes
(4:2:0, 4:4:4 and mono; 8 to 12 bits; qmtx; temporal interpolation), a
frame on the fused device route where the stream allows it and on the
two-stage executor or the host records otherwise (dec/decoder.py).  Entry
points decode on the CUDA card unless the caller asks for the CPU
(`device="cpu"`); `decode_stream(..., fused=False)` keeps every frame off
the fused route.

Layout:
- tables.py: the normative tables, and the same as device tensors
  (to_device)
- bitstream.py, frame.py, io_y4m.py, qmtx.py (with qm_tables.npz), spec/,
  _native/, dec/native_parse.py, dec/decoder.py, cli.py: the host tier,
  copied from thor_tpu (what the decode runs of it)
- ops/: torch functions and CUDA kernel wrappers, bit-exact with
  thor_tpu/ops (mc.py wraps csrc/*.cu; tempinterp.py is temporal
  interpolation)
- dec/: the decoder entry point and its routes (decoder.py), the fused
  frame decoder on the device (device_frame.py), the frame plan and the
  two-stage executor (device_pixels.py)
- models/pipeline.py, entry.py: the decode pipeline over 16x16 inter
  tiles and its forward step on one card
- csrc/, kernels/: CUDA C++ sources for sm_90a and their build/binding
"""
from .dec.decoder import decode_stream  # noqa: F401
