"""The MC kernels' roofline: peaks, and the bytes and operations a call
needs, whatever kernel does it.

`needed_samples`, `filter_ops` and `bound` are a frozen copy of
chip_smoke.py's (the copy takes the reference stack's shape and device
instead of the stack, and its taps from plainref's tables); a test holds
them equal.  `McCalls` records, in a traced run, the cells that every
call of the port's three MC entry points was given, so that the bound is
taken over exactly the launches the trace timed.
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass

import numpy as np

from plainref.tables import COEFFS_BIPRED, COEFFS_CHROMA, COEFFS_STANDARD

# NVIDIA H100 SXM data sheet, dense, at the full 700 W limit
PEAKS = {"hbm_bytes_per_s": 3.35e12,
         # int32 multiply-adds run outside the tensor cores: the float32
         # rate outside them stands for their peak
         "int32_ops_per_s": 67e12}
HBM_BYTES_PER_S = PEAKS["hbm_bytes_per_s"]
OPS_PER_S = PEAKS["int32_ops_per_s"]

LUMA_BANK = np.stack([COEFFS_STANDARD, COEFFS_BIPRED]).astype(np.int32)
CHROMA_BANK = COEFFS_CHROMA.astype(np.int32)
LOWPASS_K = np.array([[0, 1, 1, 0], [1, 2, 2, 1],
                      [1, 2, 2, 1], [0, 1, 1, 0]], np.int32)

# the kernels' name in the trace (csrc/mc_common.cuh), all three launches
MC_KERNEL = "mc_cells_kernel"
# where the port's callers find the three entry points
MC_MODULES = ("thor_tpu_torch.ops.mc", "thor_tpu_torch.dec.device_pixels")
MC_ENTRIES = {"mc_cells_luma": (True, 1), "mc_cells_chroma": (False, 1),
              "mc_cells_chroma_uv": (False, 2)}
CELL_KEYS = ("rsel", "y0", "x0", "op", "vf", "hf", "fs")


def _jidx(i, n):
    import torch
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def needed_samples(shape, device, cells, luma):
    """Distinct reference samples the cells' ops read: a six-tap (or 4-tap)
    cell the rows and columns its fractions' nonzero taps reach, a copy
    cell its cs x cs centre, a lowpass cell the 7x7 square around it."""
    import torch
    R, Hp, Wp = shape
    cs, taps = (4, 6) if luma else (2, 4)
    w, back = cs + taps - 1, taps // 2 - 1
    dev = device
    n = cells["y0"].shape[0]
    op = cells["op"].long()
    if luma:
        bank = torch.as_tensor(LUMA_BANK, device=dev)
        fset = _jidx(cells["fs"].long(), 2)
        fv = bank[fset, _jidx(cells["vf"].long(), 4)]
        fh = bank[fset, _jidx(cells["hf"].long(), 4)]
    else:
        bank = torch.as_tensor(CHROMA_BANK, device=dev)
        fv = bank[_jidx(cells["vf"].long(), 8)]
        fh = bank[_jidx(cells["hf"].long(), 8)]
    d = torch.arange(w, device=dev)

    def reach(f):   # [n, w]: window lines some output line's taps read
        m = torch.zeros((n, w), dtype=torch.bool, device=dev)
        for i in range(cs):
            m[:, i:i + taps] |= f != 0
        return m

    filt = reach(fv)[:, :, None] & reach(fh)[:, None, :]
    centre = ((d >= back) & (d < back + cs))
    copy = (centre[:, None] & centre[None, :]).expand(n, w, w)
    mask = torch.where((op == 1)[:, None, None], copy, filt)
    if luma:
        lp = torch.zeros((w, w), dtype=torch.bool, device=dev)
        k = torch.as_tensor(LOWPASS_K != 0, device=dev)
        for i in range(cs):
            for j in range(cs):
                lp[1 + i:5 + i, 1 + j:5 + j] |= k
        mask = torch.where((op == 3)[:, None, None], lp.expand(n, w, w), mask)
    r = _jidx(cells["rsel"].long(), R)
    yy = _jidx(cells["y0"].long()[:, None] - back + d, Hp)
    xx = _jidx(cells["x0"].long()[:, None] - back + d, Wp)
    flat = (r[:, None, None] * Hp + yy[:, :, None]) * Wp + xx[:, None, :]
    return int(torch.unique(flat[mask]).numel())


def filter_ops(cells, luma):
    """Multiply-adds of the separable filters on these cells (x2 ops)."""
    op = cells["op"]
    if luma:
        six = int(((op != 1) & (op != 3)).sum())
        lp = int((op == 3).sum())
        return 2 * (six * (9 * 4 * 6 + 16 * 6) + lp * 16 * 12)
    filt = int((op != 1).sum())
    return 2 * filt * (5 * 2 * 4 + 4 * 4)


def bound(cells, shape, device, luma, planes):
    """(bytes, bound in ms, bound_by) of one call on these cells."""
    n = cells["y0"].shape[0]
    cs = 4 if luma else 2
    meta = len(cells) * 4 * n
    out = n * cs * cs * 4 * planes
    ref = 2 * planes * needed_samples(shape, device, cells, luma)
    nbytes = meta + out + ref
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = planes * filter_ops(cells, luma) / OPS_PER_S * 1e3
    return nbytes, max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                         else "operations")


@dataclass
class McCall:
    luma: bool
    planes: int
    shape: tuple
    device: object
    cells: dict


class McCalls:
    """Records every CUDA call of the three MC entry points: the
    stacks' shape and a copy of the cells (the caller may reuse its
    buffers).  Bounds are taken after the window."""

    def __init__(self):
        self.calls = []

    def replacements(self):
        out = []
        for mod in MC_MODULES:
            for name, (luma, planes) in MC_ENTRIES.items():
                out.append((f"{mod}:{name}",
                            lambda fn, lu=luma, p=planes:
                            self._wrap(fn, lu, p)))
        return out

    def _wrap(self, fn, luma, planes):
        sig = inspect.signature(fn)
        stack_arg = "u_stack" if planes == 2 else "ref_stack"

        def recorded(*args, **kwargs):
            a = sig.bind(*args, **kwargs).arguments
            stack = a[stack_arg]
            if stack.device.type == "cuda" and a["y0"].shape[0]:
                cells = {k: a[k].clone() for k in CELL_KEYS if k in a}
                self.calls.append(McCall(luma, planes, tuple(stack.shape),
                                         stack.device, cells))
            return fn(*args, **kwargs)
        return recorded

    def bound_ms(self):
        """Summed bound (ms) over the recorded calls, and their count."""
        return (sum(bound(c.cells, c.shape, c.device, c.luma, c.planes)[1]
                    for c in self.calls), len(self.calls))
