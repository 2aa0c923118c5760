"""Motion compensation over uniform cells: CUDA kernels and their plain
torch versions.

`mc_cells_luma`, `mc_cells_chroma` and `mc_cells_chroma_uv` keep the
contract of thor_tpu/dec/device_pixels.py:mc_cells_luma/mc_cells_chroma
(which the port's dec/device_pixels.py re-exports).  On a CUDA tensor
they launch the hand-written kernels of csrc/mc_luma.cu and
csrc/mc_chroma.cu (which replace the three Pallas kernels of
thor_tpu/ops/mc_pallas.py); on a CPU tensor they run the plain version.
There is no other route: a CUDA tensor gets the kernel or an exception.

Indices follow JAX's gather: a negative index counts from the end and
every index is then clamped into range (`_jidx`), so both versions equal
the XLA gathers on any input.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import build
from ..tables import CHROMA_BANK, LOWPASS_K, LUMA_BANK, to_device

OP_NONE, OP_COPY, OP_SIXTAP, OP_LOWPASS = 0, 1, 2, 3

# kernel launches since the counts were last set to 0 (plain integers;
# chip_smoke.py and the tests read and reset them)
LUMA_LAUNCHES = 0
CHROMA_LAUNCHES = 0

# host copies of the taps, handed to the kernels' __constant__ memory
_LUMA_TAPS = np.ascontiguousarray(LUMA_BANK.reshape(-1), np.int32)
_LOWPASS_TAPS = np.ascontiguousarray(LOWPASS_K.reshape(-1), np.int32)
_CHROMA_TAPS = np.ascontiguousarray(CHROMA_BANK.reshape(-1), np.int32)


def _jidx(i, n: int):
    """An index as a JAX gather takes it."""
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def _windows(ref_stack, rsel, y0, x0, wn: int, back: int):
    """[N, wn, wn] int32 windows with top-left (y0-back, x0-back)."""
    R, Hp, Wp = ref_stack.shape
    d = torch.arange(wn, device=ref_stack.device)
    r = _jidx(rsel.long(), R)
    yy = _jidx(y0.long()[:, None] - back + d, Hp)
    xx = _jidx(x0.long()[:, None] - back + d, Wp)
    return ref_stack[r[:, None, None], yy[:, :, None],
                     xx[:, None, :]].to(torch.int32)


# ---------------------------------------------------------------------------
# plain versions (torch transcriptions of device_pixels.mc_cells_*)
# ---------------------------------------------------------------------------

def mc_cells_luma_plain(ref_stack, rsel, y0, x0, op, vf, hf, fs, cs: int,
                        bitdepth: int):
    """Batched luma MC over cs x cs cells.  ref_stack [R,Hp,Wp] integer
    (padded planes); y0/x0 absolute padded window-origin coords.
    Returns [N,cs,cs] int32."""
    win = _windows(ref_stack, rsel, y0, x0, cs + 5, 2)
    p_copy = win[:, 2:2 + cs, 2:2 + cs]
    bank = to_device(ref_stack.device)["luma_bank"]          # [2,4,6]
    fset = _jidx(fs.long(), 2)
    fv = bank[fset, _jidx(vf.long(), 4)]                        # [N,6]
    fh = bank[fset, _jidx(hf.long(), 4)]
    tmp = sum(fv[:, m, None, None] * win[:, m:m + cs, :] for m in range(6))
    six = sum(fh[:, m, None, None] * tmp[:, :, m:m + cs] for m in range(6))
    maxv = (1 << bitdepth) - 1
    p_six = ((six + 2048) >> 12).clamp(0, maxv)
    lp = sum(int(LOWPASS_K[dy, dx]) * win[:, 1 + dy:1 + dy + cs,
                                          1 + dx:1 + dx + cs]
             for dy in range(4) for dx in range(4) if LOWPASS_K[dy, dx])
    p_lp = ((lp + 8) >> 4).clamp(0, maxv)
    sel = op[:, None, None]
    return torch.where(sel == OP_COPY, p_copy,
                       torch.where(sel == OP_LOWPASS, p_lp, p_six))


def mc_cells_chroma_plain(ref_stack, rsel, y0, x0, op, vf, hf, cs: int,
                          bitdepth: int):
    """Batched 4-tap eighth-pel chroma MC over cs x cs cells (horizontal
    first, one rounding).  Returns [N,cs,cs] int32."""
    win = _windows(ref_stack, rsel, y0, x0, cs + 3, 1)
    p_copy = win[:, 1:1 + cs, 1:1 + cs]
    bank = to_device(ref_stack.device)["chroma_bank"]        # [8,4]
    fhc = bank[_jidx(hf.long(), 8)]
    fvc = bank[_jidx(vf.long(), 8)]
    tmp = sum(fhc[:, m, None, None] * win[:, :, m:m + cs] for m in range(4))
    out = sum(fvc[:, m, None, None] * tmp[:, m:m + cs, :] for m in range(4))
    p_f = ((out + 2048) >> 12).clamp(0, (1 << bitdepth) - 1)
    return torch.where(op[:, None, None] == OP_COPY, p_copy, p_f)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_cells(ref_stacks, cells, n: int):
    dev = ref_stacks[0].device
    for r in ref_stacks:
        if (r.device != dev or r.dtype != torch.int16 or r.dim() != 3
                or not r.is_contiguous() or r.shape != ref_stacks[0].shape):
            raise ValueError("reference stacks must be contiguous int16 "
                             "[R,Hp,Wp] tensors of one shape on one device")
    for c in cells:
        if (c.device != dev or c.dtype != torch.int32 or c.shape != (n,)
                or not c.is_contiguous()):
            raise ValueError("cell metadata must be contiguous int32 [N] "
                             "tensors on the reference's device")


def _launch_args(ref_stack):
    dev = ref_stack.device
    return (dev.index if dev.index is not None else
            torch.cuda.current_device(),
            torch.cuda.current_stream(dev).cuda_stream)


def _require_cuda(t):
    if t.device.type != "cuda":
        raise ValueError(f"no MC kernel for device {t.device}")


def mc_cells_luma(ref_stack, rsel, y0, x0, op, vf, hf, fs, cs: int,
                  bitdepth: int):
    """Luma MC over cells: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  On CUDA the reference stack must be int16
    and the metadata int32."""
    if ref_stack.device.type == "cpu":
        return mc_cells_luma_plain(ref_stack, rsel, y0, x0, op, vf, hf, fs,
                                   cs, bitdepth)
    _require_cuda(ref_stack)
    global LUMA_LAUNCHES
    n = y0.shape[0]
    cells = (rsel, y0, x0, op, vf, hf, fs)
    _check_cells((ref_stack,), cells, n)
    out = torch.empty((n, cs, cs), dtype=torch.int32,
                      device=ref_stack.device)
    if n == 0:
        return out
    lib = build.load()
    device, stream = _launch_args(ref_stack)
    R, Hp, Wp = ref_stack.shape
    rc = lib.thor_mc_luma_cells(
        device, ref_stack.data_ptr(), R, Hp, Wp,
        *[c.data_ptr() for c in cells], n, cs, bitdepth,
        _LUMA_TAPS.ctypes.data, _LOWPASS_TAPS.ctypes.data, out.data_ptr(),
        stream)
    build.check(lib, rc, "mc_luma_cells")
    LUMA_LAUNCHES += 1
    return out


def _chroma_kernel(u_stack, v_stack, rsel, y0, x0, op, vf, hf, cs: int,
                   bitdepth: int):
    global CHROMA_LAUNCHES
    _require_cuda(u_stack)
    n = y0.shape[0]
    cells = (rsel, y0, x0, op, vf, hf)
    stacks = (u_stack,) if v_stack is None else (u_stack, v_stack)
    _check_cells(stacks, cells, n)
    outs = [torch.empty((n, cs, cs), dtype=torch.int32,
                        device=u_stack.device) for _ in stacks]
    if n == 0:
        return outs
    lib = build.load()
    device, stream = _launch_args(u_stack)
    R, Hp, Wp = u_stack.shape
    rc = lib.thor_mc_chroma_cells(
        device, u_stack.data_ptr(),
        None if v_stack is None else v_stack.data_ptr(), R, Hp, Wp,
        *[c.data_ptr() for c in cells], n, cs, bitdepth,
        _CHROMA_TAPS.ctypes.data, outs[0].data_ptr(),
        None if v_stack is None else outs[1].data_ptr(), stream)
    build.check(lib, rc, "mc_chroma_cells")
    CHROMA_LAUNCHES += 1
    return outs


def mc_cells_chroma(ref_stack, rsel, y0, x0, op, vf, hf, cs: int,
                    bitdepth: int):
    """Chroma MC over cells for one plane (the kernel's one-plane case on
    CUDA, the plain version on the CPU)."""
    if ref_stack.device.type == "cpu":
        return mc_cells_chroma_plain(ref_stack, rsel, y0, x0, op, vf, hf,
                                     cs, bitdepth)
    return _chroma_kernel(ref_stack, None, rsel, y0, x0, op, vf, hf, cs,
                          bitdepth)[0]


def mc_cells_chroma_uv(u_stack, v_stack, rsel, y0, x0, op, vf, hf, cs: int,
                       bitdepth: int):
    """Chroma MC of U and V with shared cell metadata: one kernel launch
    on CUDA.  Returns (pred_u, pred_v), each [N,cs,cs] int32."""
    if u_stack.device.type == "cpu":
        return tuple(mc_cells_chroma_plain(s, rsel, y0, x0, op, vf, hf, cs,
                                           bitdepth)
                     for s in (u_stack, v_stack))
    return tuple(_chroma_kernel(u_stack, v_stack, rsel, y0, x0, op, vf, hf,
                                cs, bitdepth))
