"""Quantization weight matrices (qmtx).

Tables extracted from reference common/wt_matrix.c (12 QM levels x 3 planes
x intra/inter x TR sizes 4..128; sizes >=16 share the 16x16 matrix) into
qm_tables.npz.  Layout mirrors alloc_wmatrices (wt_matrix.c:38-56).
"""
from __future__ import annotations

import os

import numpy as np

from .tables import NUM_QM_LEVELS

_QW = [4, 8, 16, 16, 16, 16]  # per TR size 4,8,16,32,64,128

_cache = {}


def _load(kind: str):
    if kind in _cache:
        return _cache[kind]
    path = os.path.join(os.path.dirname(__file__), "qm_tables.npz")
    flat = np.load(path)[kind].astype(np.int64)
    out = []
    off = 0
    for q in range(NUM_QM_LEVELS):
        planes = []
        for c in range(3):
            intra = []
            for f in range(2):
                per_size = []
                for t in range(len(_QW)):
                    n = _QW[t]
                    per_size.append(flat[off:off + n * n].reshape(n, n))
                    off += n * n
                intra.append(per_size)
            planes.append(intra)
        out.append(planes)
    _cache[kind] = out
    return out


def get_iwmatrices():
    """iwmatrix[qlevel][plane][intra][log2(size/4)] -> (qsize,qsize)."""
    return _load("inv")


def get_wmatrices():
    return _load("fwd")
