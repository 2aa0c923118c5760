"""thor_tpu_torch: the Thor decoder and encoders on PyTorch and CUDA
(NVIDIA Hopper).

A port of thor_tpu, which stays the reference.  The port imports nothing
of thor_tpu: it keeps its own copy of the host tier that its decode runs
(C block parser, bit reader, tables, frame buffers, the numpy spec of
inter, intra, transform, CFL and filters, the decoder with its Python
syntax walk), and its device tier is torch with hand-written CUDA
kernels.  The decoder does all that thor_tpu's does: every stream decodes
(4:2:0, 4:4:4 and mono; 8 to 12 bits; qmtx; temporal interpolation), a
frame on the fused device route where the stream allows it and on the
two-stage executor or the host records otherwise (dec/decoder.py).  The
encoder (enc/) is thor_tpu's exact host-RDO encoder, byte-identical with
the reference's goldens, its turbo encoder, byte-identical with its
turbo streams, and its wavefront device encoder (`device_enc=1`),
byte-identical with its device route, chosen per frame as thor_tpu
chooses.  Entry points decode and
encode on the CUDA card unless the caller asks for the CPU
(`device="cpu"`); `decode_stream(..., fused=False)` keeps every frame off
the fused route; `encode_sequence(..., megakernel=False)` takes the
device encoder's host loop instead of frame_megakernel.  Several streams of one geometry decode in lockstep with
their two-stage frames batched on one card (`decode_streams_sharded`),
several encode at once (`encode_streams_sharded`), and the turbo encoder
prefetches the decision passes of independent B frames
(`encode_sequence_lanes`); `entry.dryrun_multistream` runs those paths
once on tiny shapes.

Layout:
- tables.py: the normative tables, and the same as device tensors
  (to_device)
- bitstream.py, frame.py, io_y4m.py, qmtx.py (with qm_tables.npz), spec/,
  _native/, dec/native_parse.py, dec/decoder.py, cli.py: the host tier,
  copies of thor_tpu's files (what the decode runs of them)
- ops/: torch functions and CUDA kernel wrappers, bit-exact with
  thor_tpu/ops (mc.py wraps csrc/*.cu; tempinterp.py is temporal
  interpolation; transform.py, quant.py, coeff_cost.py, me_batch.py and
  enc_kernels.py carry the encoder's forward transform, quantizer, bit
  count, MV helpers and SAD evaluators)
- enc/: the encoder: frame loop, the exact host-RDO SB loop and the
  filter tail (encoder.py), the turbo encoder's batched decision pass
  (turbo.py) and device finalizer with the C or Python plan/emit walks
  (turbo_final.py, turbo_native.py), the wavefront device encoder's
  decision pass (frame_megakernel, on the card a CUDA graph of the
  diagonal body replayed per diagonal; or the host loop) and syntax
  replay (device_lc.py), the CDEF/CLPF searches
  (filters_rdo.py), and the copied params.py, writer.py, me.py and rc.py
- dec/: the decoder entry point and its routes (decoder.py), the fused
  frame decoder on the device (device_frame.py), the frame plan and the
  two-stage executor with its stream-batched form (device_pixels.py),
  the multi-stream decode (multistream.py)
- enc/gop_lanes.py, enc/multistream.py: the GOP-lane decision prefetch
  and the multi-stream encode
- models/pipeline.py, entry.py: the decode pipeline over 16x16 inter
  tiles, its multi-stream steps, its forward step on one card and the
  multi-stream dry run
- csrc/, kernels/: CUDA C++ sources for sm_90a and their build/binding
- trace.py: the port's spans (off unless enabled; on the clock of the
  device trace) and its counters (MC launches, frames by decode route)
"""
from .dec.decoder import decode_stream  # noqa: F401
from .dec.multistream import decode_streams_sharded  # noqa: F401
from .enc.encoder import encode_sequence  # noqa: F401
from .enc.gop_lanes import encode_sequence_lanes  # noqa: F401
from .enc.multistream import encode_streams_sharded  # noqa: F401
