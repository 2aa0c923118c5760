"""The codec's parameters as device tensors.

The codec has no learned weights: its parameters are the normative
tables of `thor_tpu/tables.py`, read from the host tier, and the few
constants the JAX modules build beside them, copied verbatim below (the
originals import JAX; tests/test_torch_transform.py holds the copies
equal to them).  `to_device` turns them into tensors on one device.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ._host import tables as T

# verbatim copies of thor_tpu/dec/device_pixels.py:37-41 (tests hold them
# equal to the originals)
LUMA_BANK = np.stack([T.COEFFS_STANDARD, T.COEFFS_BIPRED]).astype(np.int32)
CHROMA_BANK = T.COEFFS_CHROMA.astype(np.int32)
LOWPASS_K = np.array([[0, 1, 1, 0], [1, 2, 2, 1],
                      [1, 2, 2, 1], [0, 1, 1, 0]], np.int32)


def _dir_projection_matrices():
    """One-hot (i,j)->bin maps for the 8 directional partial sums
    (ops/filters.py:314-329).  Shape [8, 64, 15] int32."""
    m = np.zeros((8, 64, 15), np.int32)
    for i in range(8):
        for j in range(8):
            p = i * 8 + j
            m[0, p, i + j] = 1
            m[1, p, i + j // 2] = 1
            m[2, p, i] = 1
            m[3, p, 3 + i - j // 2] = 1
            m[4, p, 7 + i - j] = 1
            m[5, p, 3 - i // 2 + j] = 1
            m[6, p, j] = 1
            m[7, p, i // 2 + j] = 1
    return m


# verbatim copies of thor_tpu/ops/filters.py:314-333
DIR_PROJ = _dir_projection_matrices()
DIV_TABLE = np.array([0, 840, 420, 280, 210, 168, 140, 120, 105], np.int64)


@functools.cache
def _to_device(device: str) -> dict:
    dev = torch.device(device)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    return {
        # transform matrices as float64: exact for |T| <= 90 (see
        # ops/transform.py)
        "transform": {s: t(m, torch.float64)
                      for s, m in T.TRANSFORM_TABLES.items()},
        "gdequant": t(T.GDEQUANT, torch.int32),
        "luma_bank": t(LUMA_BANK, torch.int32),
        "chroma_bank": t(CHROMA_BANK, torch.int32),
        "lowpass_k": t(LOWPASS_K, torch.int32),
        # [64, 8*15] one-hot projection, float64 so the partial sums are
        # an exact matrix product on any device
        "dir_proj": t(DIR_PROJ.transpose(1, 0, 2).reshape(64, 8 * 15),
                      torch.float64),
        "div_table": t(DIV_TABLE, torch.int64),
    }


def to_device(device) -> dict:
    """The tables as tensors on `device` (built once per device; callers
    must not write into them)."""
    return _to_device(str(torch.device(device)))
