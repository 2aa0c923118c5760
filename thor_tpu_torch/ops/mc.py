"""Motion compensation over uniform cells: CUDA kernels and their plain
torch versions.

`mc_cells_luma`, `mc_cells_chroma` and `mc_cells_chroma_uv` keep the
contract of thor_tpu/dec/device_pixels.py:mc_cells_luma/mc_cells_chroma
(which the port's dec/device_pixels.py re-exports).  On a CUDA tensor
they launch the hand-written kernels of csrc/mc_luma.cu and
csrc/mc_chroma.cu (which replace the three Pallas kernels of
thor_tpu/ops/mc_pallas.py); on a CPU tensor they run the plain version.
There is no other route: a CUDA tensor gets the kernel or an exception.
The kernels take the cell sizes of the decoder's main path, 4x4 luma and
2x2 chroma; the wrappers raise for another size on CUDA.

`mc_luma_tiles`, `mc_chroma_tiles` and `mc_chroma_uv_tiles` keep the
contract of thor_tpu/ops/mc.py and of the Pallas wrappers (one window
origin and one fraction per tile, as models/pipeline.py calls them): on
CUDA they expand each tile into the kernels' cells and launch the luma,
the one-plane chroma or the U+V kernel once.

Indices follow JAX's gather: a negative index counts from the end and
every index is then clamped into range (`_jidx`), so both versions equal
the XLA gathers on any input.
"""
from __future__ import annotations

import torch

from ..kernels import build
from ..tables import LOWPASS_K, to_device

OP_NONE, OP_COPY, OP_SIXTAP, OP_LOWPASS = 0, 1, 2, 3

# kernel launches since the counts were last set to 0 (plain integers;
# chip_smoke.py and the tests read and reset them): luma, chroma U+V (the
# two-plane case) and chroma of one plane
LUMA_LAUNCHES = 0
CHROMA_UV_LAUNCHES = 0
CHROMA_LAUNCHES = 0


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


def _require_cuda(t, cs: int, kernel_cs: int):
    if t.device.type != "cuda":
        raise ValueError(f"no MC kernel for device {t.device}")
    if cs != kernel_cs:
        raise ValueError(f"the CUDA kernel takes {kernel_cs}x{kernel_cs} "
                         f"cells, not {cs}x{cs}")


def mc_cells_luma(ref_stack, rsel, y0, x0, op, vf, hf, fs, cs: int,
                  bitdepth: int):
    """Luma MC over cells: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  On CUDA the reference stack must be int16
    and the metadata int32."""
    if ref_stack.device.type == "cpu":
        return mc_cells_luma_plain(ref_stack, rsel, y0, x0, op, vf, hf, fs,
                                   cs, bitdepth)
    _require_cuda(ref_stack, cs, 4)
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
        *[c.data_ptr() for c in cells], n, cs, bitdepth, out.data_ptr(),
        stream)
    build.check(lib, rc, "mc_luma_cells")
    LUMA_LAUNCHES += 1
    return out


def _chroma_kernel(u_stack, v_stack, rsel, y0, x0, op, vf, hf, cs: int,
                   bitdepth: int):
    global CHROMA_LAUNCHES, CHROMA_UV_LAUNCHES
    _require_cuda(u_stack, cs, 2)
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
        *[c.data_ptr() for c in cells], n, cs, bitdepth, outs[0].data_ptr(),
        None if v_stack is None else outs[1].data_ptr(), stream)
    build.check(lib, rc, "mc_chroma_cells")
    if v_stack is None:
        CHROMA_LAUNCHES += 1
    else:
        CHROMA_UV_LAUNCHES += 1
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


# ---------------------------------------------------------------------------
# tiles: one window origin and one fraction per tile x tile block
# (thor_tpu/ops/mc.py:mc_luma_tiles/mc_chroma_tiles and the Pallas
# wrappers of thor_tpu/ops/mc_pallas.py)
# ---------------------------------------------------------------------------

def _tile_ops(frac_v, frac_h, bipred):
    """(op, fs) of each tile, chosen as dec/device_pixels.py:_plan_luma
    chooses a cell's: a copy at fraction (0,0) (tap row 0 of every bank
    is the unit tap), the centre lowpass at (2,2) unless bipred is 2,
    else the separable filter with the bipred bank when bipred is set.
    For chroma `bipred` is None: no lowpass and no filter set."""
    op = torch.full_like(frac_v, OP_SIXTAP)
    if bipred is not None and bipred < 2:
        op = torch.where((frac_v == 2) & (frac_h == 2), OP_LOWPASS, op)
    op = torch.where((frac_v == 0) & (frac_h == 0), OP_COPY, op)
    return op, torch.full_like(frac_v, 1 if bipred else 0)


def _tiles_to_cells(oy, ox, per_tile, tile: int, cs: int, back: int):
    """Expands N tiles into N * (tile/cs)^2 cells of cs x cs, origins
    advancing with the cell as FramePlan.fill_luma lays them out.  oy/ox
    are window origins (`back` samples before the block), the cells'
    y0/x0 block origins.  Returns (y0, x0, per-tile arrays repeated per
    cell), contiguous int32."""
    if tile % cs:
        raise ValueError(f"tile {tile} is not a multiple of the kernel's "
                         f"{cs}x{cs} cell")
    nc = tile // cs
    d = torch.arange(nc, device=oy.device, dtype=torch.int32) * cs
    n = oy.shape[0]
    y0 = (oy.to(torch.int32)[:, None, None] + back + d[:, None]).expand(
        n, nc, nc).reshape(-1)
    x0 = (ox.to(torch.int32)[:, None, None] + back + d[None, :]).expand(
        n, nc, nc).reshape(-1)
    rep = [a.to(torch.int32).repeat_interleave(nc * nc) for a in per_tile]
    return (y0.contiguous(), x0.contiguous(), *rep)


def _cells_to_tiles(cells, n: int, tile: int, cs: int):
    nc = tile // cs
    return cells.reshape(n, nc, nc, cs, cs).permute(0, 1, 3, 2, 4).reshape(
        n, tile, tile)


def _stack16(ref):
    """A [Hp,Wp] plane as the kernels' int16 [1,Hp,Wp] reference stack."""
    return ref.to(torch.int16).contiguous()[None]


def mc_luma_tiles(ref, oy, ox, frac_v, frac_h, tile: int = 4,
                  bipred: int = 0, bitdepth: int = 8):
    """MC a batch of tile x tile luma blocks (thor_tpu/ops/mc.py:
    mc_luma_tiles, mc_pallas.py:mc_luma_tiles_pallas).

    ref: padded reference plane [Hp,Wp], integer samples in
    0..2^bitdepth-1.  oy/ox: [N] window origins = pad + block_y + ver_int
    - 2 (top-left of the (tile+5)-wide window); every window must lie
    inside the plane.  frac_v/frac_h: [N] in 0..3.  Returns [N,tile,tile]
    int32.  On a CUDA tensor each tile becomes (tile/4)^2 cells of the
    luma kernel, launched once; on a CPU tensor the plain version runs on
    whole tiles."""
    zero = torch.zeros_like(frac_v)
    op, fs = _tile_ops(frac_v, frac_h, bipred)
    if ref.device.type == "cpu":
        return mc_cells_luma_plain(ref[None], zero, oy + 2, ox + 2, op,
                                   frac_v, frac_h, fs, tile, bitdepth)
    y0, x0, rsel, op, vf, hf, fs = _tiles_to_cells(
        oy, ox, (zero, op, frac_v, frac_h, fs), tile, 4, 2)
    out = mc_cells_luma(_stack16(ref), rsel, y0, x0, op, vf, hf, fs, 4,
                        bitdepth)
    return _cells_to_tiles(out, oy.shape[0], tile, 4)


def _chroma_tile_cells(oy, ox, frac_v, frac_h, tile: int):
    zero = torch.zeros_like(frac_v)
    op, _ = _tile_ops(frac_v, frac_h, None)
    y0, x0, rsel, op, vf, hf = _tiles_to_cells(
        oy, ox, (zero, op, frac_v, frac_h), tile, 2, 1)
    return rsel, y0, x0, op, vf, hf


def mc_chroma_tiles(ref, oy, ox, frac_v, frac_h, tile: int = 2,
                    bitdepth: int = 8):
    """MC a batch of tile x tile chroma blocks of one plane (4-tap
    eighth-pel; thor_tpu/ops/mc.py:mc_chroma_tiles, mc_pallas.py:
    mc_chroma_tiles_pallas).  oy/ox: [N] window origins = pad_c + block_y
    + ver_int - 1, every window inside the plane; frac_v/frac_h in 0..7.
    Returns [N,tile,tile] int32.  On a CUDA tensor: one launch of the
    chroma kernel's one-plane case over (tile/2)^2 cells a tile."""
    if ref.device.type == "cpu":
        op, _ = _tile_ops(frac_v, frac_h, None)
        return mc_cells_chroma_plain(ref[None], torch.zeros_like(frac_v),
                                     oy + 1, ox + 1, op, frac_v, frac_h,
                                     tile, bitdepth)
    cells = _chroma_tile_cells(oy, ox, frac_v, frac_h, tile)
    out = mc_cells_chroma(_stack16(ref), *cells, 2, bitdepth)
    return _cells_to_tiles(out, oy.shape[0], tile, 2)


def mc_chroma_uv_tiles(ref_u, ref_v, oy, ox, frac_v, frac_h, tile: int = 2,
                       bitdepth: int = 8):
    """mc_chroma_tiles for U and V sharing the per-tile metadata
    (mc_pallas.py:mc_chroma_uv_tiles_pallas): on a CUDA tensor one launch
    of the chroma kernel's two-plane case.  Returns (pred_u, pred_v)."""
    if ref_u.device.type == "cpu":
        return tuple(mc_chroma_tiles(r, oy, ox, frac_v, frac_h, tile,
                                     bitdepth) for r in (ref_u, ref_v))
    cells = _chroma_tile_cells(oy, ox, frac_v, frac_h, tile)
    pu, pv = mc_cells_chroma_uv(_stack16(ref_u), _stack16(ref_v), *cells, 2,
                                bitdepth)
    n = oy.shape[0]
    return _cells_to_tiles(pu, n, tile, 2), _cells_to_tiles(pv, n, tile, 2)
