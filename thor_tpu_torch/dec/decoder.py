"""The port's decoder: the host syntax walk of thor_tpu/dec/decoder.py
(loaded without JAX, thor_tpu_torch/_host.py) with every pixel of every
frame decoded by the torch/CUDA `DeviceFrameDecoder`.

The host decoder has fallbacks that decode pixels on the host or in JAX.
`Decoder` closes each of them with a `NotImplementedError` that names the
ROADMAP.md item that ports it, so that a stream outside the slice fails
loudly instead of decoding on another path.
"""
from __future__ import annotations

import os
import sys

import torch

from .._host import bitstream
from .._host import decoder as host
from .._host import native_parse as NP
from .device_frame import DeviceFrameDecoder


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to thor_tpu_torch (ROADMAP.md Queue 1, "
        f"'{item}')")


class Decoder(host.Decoder):
    """thor_tpu's decoder with the device path forced on and served by
    the port's DeviceFrameDecoder on `device`."""

    def __init__(self, header, device):
        # THOR_DEVICE_FILTERS=0 makes the host __init__ skip its JAX
        # backend probe, which would otherwise switch the device path off
        # where JAX is missing; the device path is switched on below.
        saved = os.environ.get("THOR_DEVICE_FILTERS")
        os.environ["THOR_DEVICE_FILTERS"] = "0"
        try:
            super().__init__(header)
        finally:
            if saved is None:
                del os.environ["THOR_DEVICE_FILTERS"]
            else:
                os.environ["THOR_DEVICE_FILTERS"] = saved
        self.use_device_filters = True
        self.use_device_pixels = True
        self.use_device_frame = True
        self._device_frame = DeviceFrameDecoder(device)

    def process_block(self, *args, **kwargs):
        _not_ported("the Python syntax walk with host pixels",
                    "Decoder fallbacks")

    def _loop_filters_device(self, *args, **kwargs):
        _not_ported("the unfused loop filters (filters_exec)",
                    "Decoder fallbacks")

    def _loop_filters_spec(self, *args, **kwargs):
        _not_ported("the host loop filters", "Decoder fallbacks")

    def _exec_records_host(self, *args, **kwargs):
        _not_ported("host pixel decoding", "Decoder fallbacks")

    def _exec_intra_records(self, *args, **kwargs):
        _not_ported("the two-stage executor (frame_exec/execute)",
                    "Decoder fallbacks")


def check_slice(header):
    """Raise NotImplementedError for a stream outside the ported slice."""
    if (header.subsample != 420 or header.cfl_inter or header.qmtx
            or header.interp_ref):
        _not_ported(
            "this stream (subsample=%d cfl_inter=%d qmtx=%d interp_ref=%d;"
            " the port decodes 4:2:0 with cfl_inter=0, qmtx=0 and "
            "interp_ref=0)" % (header.subsample, header.cfl_inter,
                               header.qmtx, header.interp_ref),
            "Decoder fallbacks, Temporal interpolation")


def decode_stream(data: bytes, progress=None, device=None):
    """Decode a full Thor stream; returns (header, list of frames in
    display order as bytes).  `device` defaults to CUDA when torch sees a
    card, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    fur = bitstream.FrameUnitReader(data)
    s = fur.next_frame()
    header = host.SequenceHeader.read(s)
    check_slice(header)
    if not NP.available():
        raise RuntimeError("the native block parser (thor_tpu/_native) is "
                           "unavailable: thor_tpu_torch needs it")
    dec = Decoder(header, device)
    dec.bc.sequence_header = s.bitcnt  # maindec.c:129-139
    outputs = {}
    n = 0
    bitcnt = 0
    pend_out = None
    while s is not None:
        dec.decode_frame(s, n)
        # desync detection: a compliant frame consumes its length-prefixed
        # unit to within byte padding
        slack = (len(s.data) << 3) - s.bitpos
        if slack < 0 or slack >= 8:
            what = ("overran the unit by %d bits" % -slack if slack < 0
                    else "left %d bits unread" % slack)
            print(f"thor_tpu_torch: WARNING: frame {n}: bitstream desync - "
                  f"the {len(s.data)}-byte frame unit {what}; decoded "
                  f"output for this frame is unreliable", file=sys.stderr)
        # output deferred ONE frame: frame N's pull is still in flight
        # when decode_frame(N) returns and is resolved by N+1's
        if pend_out is not None:
            outputs[pend_out[0]] = pend_out[1].to_bytes()
        pend_out = (dec.fi.display_frame_num, dec.rec)
        bitcnt += s.bitcnt
        if progress:
            progress(n, dec.fi.display_frame_num, bitcnt)
        n += 1
        s = fur.next_frame()
    dec.flush_pixels()
    if pend_out is not None:
        outputs[pend_out[0]] = pend_out[1].to_bytes()
    header.bit_count = dec.bc  # for the CLI statistics report
    return header, [outputs[k] for k in sorted(outputs)]
