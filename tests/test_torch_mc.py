"""thor_tpu_torch's motion compensation against thor_tpu's, exactly.

The port's MC has a CUDA kernel and a plain torch version behind one
wrapper; on the CPU the wrapper runs the plain version, which is held
here to the JAX gathers of thor_tpu/dec/device_pixels.py and, through
cells cut from whole tiles, to the contract of the Pallas kernels
(thor_tpu/ops/mc.py:mc_luma_tiles/mc_chroma_tiles, their plain twins, as
tests/test_ops_vs_spec.py holds them).  The kernels themselves are held
to the plain version on a card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from thor_tpu.dec import device_pixels as JDP
from thor_tpu.ops import mc as JMC
from thor_tpu_torch.dec import device_pixels as PDP
from thor_tpu_torch.ops import mc as PMC

torch.set_num_threads(1)


def _cells(rng, n, R, Hp, Wp, cs, nfrac, luma):
    """Random cell metadata, origins reaching past every plane border
    and a few indices out of range (JAX's gather clamps them)."""
    c = {"rsel": rng.integers(-1, R + 1, n),
         "y0": rng.integers(-8, Hp + 8, n), "x0": rng.integers(-8, Wp + 8, n),
         "op": rng.integers(0, 4, n), "vf": rng.integers(-1, nfrac + 1, n),
         "hf": rng.integers(-1, nfrac + 1, n)}
    if luma:
        c["fs"] = rng.integers(-1, 3, n)
    # most cells inside the plane, as on the decoder's path
    inner = rng.random(n) < 0.7
    c["y0"] = np.where(inner, rng.integers(2, Hp - cs - 3, n), c["y0"])
    c["x0"] = np.where(inner, rng.integers(2, Wp - cs - 3, n), c["x0"])
    return {k: v.astype(np.int32) for k, v in c.items()}


def _t(c, keys):
    return [torch.from_numpy(c[k]) for k in keys]


LUMA = ("rsel", "y0", "x0", "op", "vf", "hf", "fs")
CHROMA = ("rsel", "y0", "x0", "op", "vf", "hf")


@pytest.mark.parametrize("bitdepth", [8, 10])
def test_mc_cells_luma(bitdepth):
    rng = np.random.default_rng(bitdepth)
    R, Hp, Wp, n = 3, 40, 56, 400
    ref = rng.integers(0, 1 << bitdepth, (R, Hp, Wp)).astype(np.int32)
    c = _cells(rng, n, R, Hp, Wp, 4, 4, True)
    want = np.asarray(JDP.mc_cells_luma(ref, *[c[k] for k in LUMA], 4,
                                        bitdepth))
    ref16 = torch.from_numpy(ref.astype(np.int16))
    got = PDP.mc_cells_luma(ref16, *_t(c, LUMA), 4, bitdepth)
    assert got.dtype == torch.int32 and got.shape == (n, 4, 4)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(PMC.mc_cells_luma_plain(
        torch.from_numpy(ref), *_t(c, LUMA), 4, bitdepth).numpy(), want)


@pytest.mark.parametrize("bitdepth", [8, 10])
def test_mc_cells_chroma_uv(bitdepth):
    """U and V in one call equal two single-plane JAX calls."""
    rng = np.random.default_rng(20 + bitdepth)
    R, Hp, Wp, n = 2, 30, 44, 400
    refu, refv = (rng.integers(0, 1 << bitdepth, (R, Hp, Wp)).astype(
        np.int32) for _ in range(2))
    c = _cells(rng, n, R, Hp, Wp, 2, 8, False)
    args = [c[k] for k in CHROMA]
    want_u = np.asarray(JDP.mc_cells_chroma(refu, *args, 2, bitdepth))
    want_v = np.asarray(JDP.mc_cells_chroma(refv, *args, 2, bitdepth))
    pu, pv = PDP.mc_cells_chroma_uv(
        torch.from_numpy(refu.astype(np.int16)),
        torch.from_numpy(refv.astype(np.int16)), *_t(c, CHROMA), 2,
        bitdepth)
    assert np.array_equal(pu.numpy(), want_u)
    assert np.array_equal(pv.numpy(), want_v)
    one = PDP.mc_cells_chroma(torch.from_numpy(refv), *_t(c, CHROMA), 2,
                              bitdepth)
    assert np.array_equal(one.numpy(), want_v)


def _tiles_as_cells(oy, ox, tile, cs, back):
    """Cell origins of whole tiles whose read windows start at (oy, ox):
    [N * (tile/cs)^2] in tile-major, then row-major cell order."""
    k = tile // cs
    a = np.arange(k) * cs
    y0 = oy[:, None, None] + back + a[None, :, None]
    x0 = ox[:, None, None] + back + a[None, None, :]
    return (np.broadcast_to(y0, (len(oy), k, k)).reshape(-1),
            np.broadcast_to(x0, (len(oy), k, k)).reshape(-1))


def _cells_as_tiles(p, n, tile, cs):
    k = tile // cs
    return p.reshape(n, k, k, cs, cs).permute(0, 1, 3, 2, 4).reshape(
        n, tile, tile)


@pytest.mark.parametrize("bipred", [0, 1, 2])
def test_mc_luma_cells_pallas_contract(bipred):
    """16x16 luma tiles (the Pallas kernel's default) cut into 4x4 cells
    equal ops/mc.py:mc_luma_tiles."""
    rng = np.random.default_rng(30 + bipred)
    pad, W, H, tile, N = 32, 96, 64, 16, 24
    ref = rng.integers(0, 256, (H + 2 * pad, W + 2 * pad)).astype(np.int32)
    ys = rng.integers(0, H - tile + 1, N)
    xs = rng.integers(0, W - tile + 1, N)
    mvy, mvx = rng.integers(-40, 41, N), rng.integers(-40, 41, N)
    fv, fh = (mvy & 3).astype(np.int32), (mvx & 3).astype(np.int32)
    oy = (pad + ys + (mvy >> 2) - 2).astype(np.int32)
    ox = (pad + xs + (mvx >> 2) - 2).astype(np.int32)
    want = np.asarray(JMC.mc_luma_tiles(ref, oy, ox, fv, fh, tile=tile,
                                        bipred=bipred))
    per = (tile // 4) ** 2
    y0, x0 = _tiles_as_cells(oy, ox, tile, 4, 2)
    cfv, cfh = np.repeat(fv, per), np.repeat(fh, per)
    lowpass = (cfv == 2) & (cfh == 2) & (bipred < 2)
    op = np.where(lowpass, PMC.OP_LOWPASS,
                  np.where((cfv == 0) & (cfh == 0), PMC.OP_COPY,
                           PMC.OP_SIXTAP))
    cells = [np.zeros(N * per), y0, x0, op, cfv, cfh,
             np.full(N * per, int(bipred > 0))]
    cells = [torch.from_numpy(np.ascontiguousarray(a, np.int32))
             for a in cells]
    got = PDP.mc_cells_luma(torch.from_numpy(ref[None].astype(np.int16)),
                            *cells, 4, 8)
    assert np.array_equal(_cells_as_tiles(got, N, tile, 4).numpy(), want)


def test_mc_chroma_cells_pallas_contract():
    """8x8 chroma tiles (the Pallas kernels' default) cut into 2x2 cells
    equal ops/mc.py:mc_chroma_tiles, for U and V at once."""
    rng = np.random.default_rng(40)
    pad, W, H, tile, N = 16, 48, 32, 8, 24
    refu, refv = (rng.integers(0, 256, (H + 2 * pad, W + 2 * pad)).astype(
        np.int32) for _ in range(2))
    ys = rng.integers(0, H - tile + 1, N)
    xs = rng.integers(0, W - tile + 1, N)
    mvy, mvx = rng.integers(-40, 41, N), rng.integers(-40, 41, N)
    fv, fh = (mvy & 7).astype(np.int32), (mvx & 7).astype(np.int32)
    oy = (pad + ys + (mvy >> 3) - 1).astype(np.int32)
    ox = (pad + xs + (mvx >> 3) - 1).astype(np.int32)
    per = (tile // 2) ** 2
    y0, x0 = _tiles_as_cells(oy, ox, tile, 2, 1)
    cfv, cfh = np.repeat(fv, per), np.repeat(fh, per)
    op = np.where((cfv == 0) & (cfh == 0), PMC.OP_COPY, PMC.OP_SIXTAP)
    cells = [torch.from_numpy(np.ascontiguousarray(a, np.int32))
             for a in (np.zeros(N * per), y0, x0, op, cfv, cfh)]
    pu, pv = PDP.mc_cells_chroma_uv(
        torch.from_numpy(refu[None].astype(np.int16)),
        torch.from_numpy(refv[None].astype(np.int16)), *cells, 2, 8)
    for ref, got in ((refu, pu), (refv, pv)):
        want = np.asarray(JMC.mc_chroma_tiles(ref, oy, ox, fv, fh,
                                              tile=tile))
        assert np.array_equal(_cells_as_tiles(got, N, tile, 2).numpy(),
                              want)


def test_wrapper_takes_plain_version_only_on_cpu():
    """A tensor that is neither on the CPU nor on a CUDA device gets no
    fallback: the wrapper raises."""
    meta = torch.empty((1, 16, 16), dtype=torch.int16, device="meta")
    cell = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        PMC.mc_cells_luma(meta, *[cell] * 7, 4, 8)
    with pytest.raises(ValueError):
        PMC.mc_cells_chroma_uv(meta, meta, *[cell] * 6, 2, 8)
