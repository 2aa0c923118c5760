"""The port's forward step for a compile-and-run check on one card (the
twin of thor_tpu's graft entry)."""
from functools import partial

import numpy as np
import torch

from .dec.decoder import resolve_device
from .models.pipeline import decode_p_frame_420, make_example_full


def entry(device=None):
    """Forward step on the tile decode pipeline.

    Returns (fn, example_args): the full device side of decoding one CIF
    4:2:0 P frame of 16x16 inter tiles - luma/chroma MC, dequant, inverse
    transform, reconstruction and the deblock -> CDEF -> CLPF loop chain.
    The arguments are tensors on `device` (the CUDA card when none is
    given), and fn runs there."""
    device = resolve_device(device)
    args, _dd, _presets = make_example_full(height=288, width=352, qp=32)
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in args)
    fn = partial(decode_p_frame_420, height=288, width=352, qp=32,
                 bitdepth=8, device=device, clpf_strengths=(2, 1, 4))
    return fn, args
