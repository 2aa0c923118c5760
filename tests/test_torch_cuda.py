"""The CUDA kernels against their plain torch versions, on a card.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports no JAX, so that it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py sets up JAX for the other tests).
"""
import numpy as np
import pytest
import torch

from thor_tpu_torch import tables as T
from thor_tpu_torch.kernels import build
from thor_tpu_torch.ops import mc as MC

LUMA = ("rsel", "y0", "x0", "op", "vf", "hf", "fs")
CHROMA = ("rsel", "y0", "x0", "op", "vf", "hf")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card run: chip_smoke.py)")
    return torch.device("cuda")


def _cells(rng, n, R, Hp, Wp, cs, nfrac, luma, dev):
    """Cells inside the planes, past every border, and with indices out of
    range (clamped as JAX's gather clamps them)."""
    c = {"rsel": rng.integers(-1, R + 1, n),
         "y0": rng.integers(-8, Hp + 8, n), "x0": rng.integers(-8, Wp + 8, n),
         "op": rng.integers(0, 4, n), "vf": rng.integers(-1, nfrac + 1, n),
         "hf": rng.integers(-1, nfrac + 1, n)}
    if luma:
        c["fs"] = rng.integers(-1, 3, n)
    inner = rng.random(n) < 0.7
    c["y0"] = np.where(inner, rng.integers(2, Hp - cs - 3, n), c["y0"])
    c["x0"] = np.where(inner, rng.integers(2, Wp - cs - 3, n), c["x0"])
    keys = LUMA if luma else CHROMA
    return [torch.from_numpy(c[k].astype(np.int32)).to(dev) for k in keys]


@pytest.mark.cuda
@pytest.mark.parametrize("bitdepth", [8, 10])
def test_luma_kernel_equals_plain(cuda, bitdepth):
    rng = np.random.default_rng(50 + bitdepth)
    R, Hp, Wp, n = 2, 200, 264, 5000
    ref = torch.from_numpy(rng.integers(0, 1 << bitdepth, (R, Hp, Wp))
                           .astype(np.int16)).to(cuda)
    cells = _cells(rng, n, R, Hp, Wp, 4, 4, True, cuda)
    before = MC.LUMA_LAUNCHES
    got = MC.mc_cells_luma(ref, *cells, 4, bitdepth)
    torch.cuda.synchronize()
    assert MC.LUMA_LAUNCHES == before + 1
    assert torch.equal(got, MC.mc_cells_luma_plain(ref, *cells, 4, bitdepth))


@pytest.mark.cuda
@pytest.mark.parametrize("bitdepth", [8, 10])
def test_chroma_kernel_equals_plain(cuda, bitdepth):
    rng = np.random.default_rng(60 + bitdepth)
    R, Hp, Wp, n = 2, 120, 152, 5000
    u, v = (torch.from_numpy(rng.integers(0, 1 << bitdepth, (R, Hp, Wp))
                             .astype(np.int16)).to(cuda) for _ in range(2))
    cells = _cells(rng, n, R, Hp, Wp, 2, 8, False, cuda)
    before = MC.CHROMA_UV_LAUNCHES, MC.CHROMA_LAUNCHES
    pu, pv = MC.mc_cells_chroma_uv(u, v, *cells, 2, bitdepth)
    assert (MC.CHROMA_UV_LAUNCHES, MC.CHROMA_LAUNCHES) == (before[0] + 1,
                                                           before[1])
    one = MC.mc_cells_chroma(v, *cells, 2, bitdepth)
    torch.cuda.synchronize()
    assert (MC.CHROMA_UV_LAUNCHES, MC.CHROMA_LAUNCHES) == (before[0] + 1,
                                                           before[1] + 1)
    assert torch.equal(pu, MC.mc_cells_chroma_plain(u, *cells, 2, bitdepth))
    assert torch.equal(pv, MC.mc_cells_chroma_plain(v, *cells, 2, bitdepth))
    assert torch.equal(one, pv)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    ref = torch.zeros((1, 32, 32), dtype=torch.int32, device=cuda)
    cell = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):        # the kernel reads int16 planes
        MC.mc_cells_luma(ref, *[cell] * 7, 4, 8)
    ref16 = ref.to(torch.int16)
    with pytest.raises(ValueError):        # metadata on the host
        MC.mc_cells_luma(ref16, *[cell.cpu()] * 7, 4, 8)
    with pytest.raises(ValueError):        # planes of two shapes
        MC.mc_cells_chroma_uv(ref16, ref16[:, :16], *[cell] * 6, 2, 8)


def _stacks(rng, bitdepth, R, Hp, Wp, n, dev):
    return [torch.from_numpy(rng.integers(0, 1 << bitdepth, (R, Hp, Wp))
                             .astype(np.int16)).to(dev) for _ in range(n)]


def _block_cells(rng, gh, gw, cs, pad, blk, nfrac, luma, dev, rsel=None,
                 mv=8, shift=(0, 0)):
    """Cells of a raster 4x4 (or 2x2) grid in blocks of blk x blk cells
    that share one motion vector, reference and fractions, as a real
    stream's plan has them; `shift` moves every origin."""
    n = gh * gw
    gy, gx = np.divmod(np.arange(n), gw)
    b = (gy // blk) * ((gw + blk - 1) // blk) + gx // blk
    nb = b.max() + 1
    mvy, mvx = rng.integers(-mv, mv + 1, nb), rng.integers(-mv, mv + 1, nb)
    c = {"rsel": rng.integers(0, 2, nb)[b] if rsel is None else rsel,
         "y0": gy * cs + pad + mvy[b] + shift[0],
         "x0": gx * cs + pad + mvx[b] + shift[1],
         "op": rng.integers(0, 4, nb)[b],
         "vf": rng.integers(0, nfrac, nb)[b],
         "hf": rng.integers(0, nfrac, nb)[b]}
    if luma:
        c["fs"] = rng.integers(0, 2, nb)[b]
    keys = LUMA if luma else CHROMA
    return [torch.from_numpy(np.broadcast_to(c[k], (n,)).astype(np.int32))
            .contiguous().to(dev) for k in keys]


def _run_both(luma, bitdepth, refs, cells):
    """Kernel against plain version, tolerance 0."""
    if luma:
        got = [MC.mc_cells_luma(refs[0], *cells, 4, bitdepth)]
        want = [MC.mc_cells_luma_plain(refs[0], *cells, 4, bitdepth)]
    else:
        got = list(MC.mc_cells_chroma_uv(refs[0], refs[1], *cells, 2,
                                         bitdepth))
        got.append(MC.mc_cells_chroma(refs[1], *cells, 2, bitdepth))
        want = [MC.mc_cells_chroma_plain(r, *cells, 2, bitdepth)
                for r in (refs[0], refs[1], refs[1])]
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# (name, gh, gw, blk, rsel, mv): shapes of the cell groups
SCENES = [
    ("one_box", 16, 64, 16, 0, 2),        # a group's windows share a box
    ("blocks", 16, 64, 2, None, 8),       # MVs and refs per 2x2 block
    ("plane_edge", 16, 64, 16, 0, 2),     # windows clamp at the top left
    ("far_edge", 16, 64, 16, 0, 2),       # ... and at the bottom right
    ("whole_rows", 16, 64, 4, 0, 2),      # every vertical position whole
    ("mixed_rsel", 16, 64, 16, "mixed", 2),
    ("ragged", 5, 13, 4, 0, 2),           # N = 65: not a multiple of 32
    ("one_cell", 1, 1, 1, 0, 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("luma", [True, False], ids=["luma", "chroma"])
@pytest.mark.parametrize("bitdepth", [8, 10, 12])
@pytest.mark.parametrize("scene", SCENES, ids=[s[0] for s in SCENES])
def test_kernel_paths_equal_plain(cuda, scene, bitdepth, luma):
    """Both row readers of each kernel (16-byte loads inside the plane's
    columns, clamped gathers past them), the warp's choice of rows at
    whole-sample vertical positions, all four ops (OP_NONE included), the
    ragged last group and N = 1, at 8, 10 and 12 bits."""
    name, gh, gw, blk, rsel, mv = scene
    rng = np.random.default_rng([SCENES.index(scene), bitdepth, int(luma)])
    cs, pad = (4, 160) if luma else (2, 80)
    # planes a multiple of 8 samples wide, as the decoder's are
    Hp, Wp = gh * cs + 2 * pad, (gw * cs + 2 * pad + 7) // 8 * 8
    refs = _stacks(rng, bitdepth, 2, Hp, Wp, 1 if luma else 2, cuda)
    n = gh * gw
    if rsel == "mixed":
        rsel = rng.integers(0, 2, n)
    shift = {"plane_edge": (-pad - cs,) * 2,
             "far_edge": (pad + cs,) * 2}.get(name, (0, 0))
    cells = _block_cells(rng, gh, gw, cs, pad, blk, 4 if luma else 8, luma,
                         cuda, rsel=rsel, mv=mv, shift=shift)
    if name == "whole_rows":
        cells[LUMA.index("vf")].zero_()
    _run_both(luma, bitdepth, refs, cells)


@pytest.mark.cuda
@pytest.mark.parametrize("luma", [True, False], ids=["luma", "chroma"])
def test_unaligned_planes_take_the_gather_path(cuda, luma):
    """A plane width that is not a multiple of 8 samples rules out the
    aligned 16-byte row loads: every row is gathered, and stays exact."""
    rng = np.random.default_rng(7)
    cs, pad = (4, 160) if luma else (2, 80)
    gh, gw = 8, 30
    Hp, Wp = gh * cs + 2 * pad, gw * cs + 2 * pad + 3
    refs = _stacks(rng, 10, 2, Hp, Wp, 1 if luma else 2, cuda)
    cells = _block_cells(rng, gh, gw, cs, pad, 8, 4 if luma else 8, luma,
                         cuda, rsel=0)
    _run_both(luma, 10, refs, cells)


@pytest.mark.cuda
def test_constant_taps_equal_tables(cuda):
    lib = build.load()
    bank = np.zeros(48, np.int32)
    lowpass = np.zeros(16, np.int32)
    chroma = np.zeros(32, np.int32)
    assert lib.thor_mc_luma_taps(bank.ctypes.data, lowpass.ctypes.data) == 0
    assert lib.thor_mc_chroma_taps(chroma.ctypes.data) == 0
    assert (bank.reshape(2, 4, 6) == np.stack([T.COEFFS_STANDARD,
                                                T.COEFFS_BIPRED])).all()
    assert (lowpass.reshape(4, 4) == T.LOWPASS_K).all()
    assert (chroma.reshape(8, 4) == T.COEFFS_CHROMA).all()


@pytest.mark.cuda
def test_kernels_take_only_the_main_path_cell_sizes(cuda):
    ref = torch.zeros((1, 64, 64), dtype=torch.int16, device=cuda)
    cell = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="4x4"):
        MC.mc_cells_luma(ref, *[cell] * 7, 8, 8)
    with pytest.raises(ValueError, match="2x2"):
        MC.mc_cells_chroma_uv(ref, ref, *[cell] * 6, 4, 8)


def _tile_inputs(rng, n, Hp, Wp, tile, taps, nfrac, bitdepth, nplanes):
    """n tiles whose windows lie inside the plane, every fraction pair
    present; numpy arrays (refs..., oy, ox, fv, fh)."""
    refs = [rng.integers(0, 1 << bitdepth, (Hp, Wp)).astype(np.int32)
            for _ in range(nplanes)]
    oy = rng.integers(0, Hp - tile - taps + 1, n).astype(np.int32)
    ox = rng.integers(0, Wp - tile - taps + 1, n).astype(np.int32)
    k = np.arange(n) % (nfrac * nfrac)
    return refs + [oy, ox, (k // nfrac).astype(np.int32),
                   (k % nfrac).astype(np.int32)]


def _on(dev, arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("bitdepth", [8, 10])
@pytest.mark.parametrize("bipred", [0, 1, 2])
def test_luma_tiles_on_the_card_equal_plain(cuda, bipred, bitdepth):
    """mc_luma_tiles: one launch of the luma kernel over 16 cells a tile,
    equal to the plain version on whole tiles (the CPU route)."""
    rng = np.random.default_rng([1, bipred, bitdepth])
    args = _tile_inputs(rng, 396, 416, 480, 16, 5, 4, bitdepth, 1)
    before = MC.LUMA_LAUNCHES
    got = MC.mc_luma_tiles(*_on(cuda, args), tile=16, bipred=bipred,
                           bitdepth=bitdepth)
    torch.cuda.synchronize()
    assert MC.LUMA_LAUNCHES == before + 1
    want = MC.mc_luma_tiles(*_on("cpu", args), tile=16, bipred=bipred,
                            bitdepth=bitdepth)
    assert got.shape == (396, 16, 16) and torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("bitdepth", [8, 10])
def test_chroma_tiles_on_the_card_equal_plain(cuda, bitdepth):
    """N = 396 tiles (CIF): mc_chroma_tiles launches the one-plane kernel
    once a plane, mc_chroma_uv_tiles the U+V kernel once; both equal the
    plain version."""
    rng = np.random.default_rng([2, bitdepth])
    args = _tile_inputs(rng, 396, 208, 240, 8, 3, 8, bitdepth, 2)
    refu, refv, *meta = _on(cuda, args)
    before = MC.CHROMA_LAUNCHES, MC.CHROMA_UV_LAUNCHES
    one_u = MC.mc_chroma_tiles(refu, *meta, tile=8, bitdepth=bitdepth)
    one_v = MC.mc_chroma_tiles(refv, *meta, tile=8, bitdepth=bitdepth)
    assert (MC.CHROMA_LAUNCHES, MC.CHROMA_UV_LAUNCHES) == (before[0] + 2,
                                                           before[1])
    pu, pv = MC.mc_chroma_uv_tiles(refu, refv, *meta, tile=8,
                                   bitdepth=bitdepth)
    torch.cuda.synchronize()
    assert (MC.CHROMA_LAUNCHES, MC.CHROMA_UV_LAUNCHES) == (before[0] + 2,
                                                           before[1] + 1)
    cu, cv, *cmeta = _on("cpu", args)
    for got, ref in ((one_u, cu), (one_v, cv), (pu, cu), (pv, cv)):
        want = MC.mc_chroma_tiles(ref, *cmeta, tile=8, bitdepth=bitdepth)
        assert got.shape == (396, 8, 8) and torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("height,width,kernels", [
    (288, 352, (1, 2, 0)),       # 396 tiles: the one-plane kernel twice
    (64, 128, (1, 0, 1))])       # 32 tiles: the U+V kernel
def test_tile_pipeline_on_the_card_equals_cpu(cuda, height, width, kernels):
    from thor_tpu_torch.models import pipeline as PP
    args, _, _ = PP.make_example_full(height, width, 32, seed=4)
    kw = dict(height=height, width=width, qp=32, clpf_strengths=(2, 1, 4))
    before = MC.LUMA_LAUNCHES, MC.CHROMA_LAUNCHES, MC.CHROMA_UV_LAUNCHES
    got = PP.decode_p_frame_420(*args, device=cuda, **kw)
    torch.cuda.synchronize()
    after = MC.LUMA_LAUNCHES, MC.CHROMA_LAUNCHES, MC.CHROMA_UV_LAUNCHES
    assert tuple(a - b for a, b in zip(after, before)) == kernels
    want = PP.decode_p_frame_420(*args, device="cpu", **kw)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("ratio,pos", [(2, 1), (4, 3)])
def test_interpolate_frames_on_the_card_equals_cpu(cuda, ratio, pos):
    """128x96: two pyramid levels; (4, 3) swaps the references."""
    from thor_tpu_torch.frame import new_ref_frame
    from thor_tpu_torch.ops.tempinterp import interpolate_frames
    rng = np.random.default_rng([3, ratio, pos])
    w, h = 128, 96
    base = np.clip(np.linspace(20, 235, w)[None, :] +
                   np.linspace(0, 40, h)[:, None] +
                   rng.integers(-12, 12, (h, w)), 0, 255)
    refs = []
    for shift in (0, 5):
        f = new_ref_frame(w, h)
        f.y[:, :] = np.roll(base, shift, axis=1).astype(f.dtype)
        f.u[:, :] = rng.integers(0, 256, (h // 2, w // 2)).astype(f.dtype)
        f.v[:, :] = rng.integers(0, 256, (h // 2, w // 2)).astype(f.dtype)
        f.pad_frame()
        refs.append(f)
    outs = []
    for dev in (cuda, "cpu"):
        out = new_ref_frame(w, h)
        interpolate_frames(out, refs[0], refs[1], ratio, pos, device=dev)
        outs.append(out)
    for plane in ("y_full", "u_full", "v_full"):
        np.testing.assert_array_equal(getattr(outs[0], plane),
                                      getattr(outs[1], plane), plane)


# (H, W, sub, mono, bd, deblocking, (s_y, s_u, s_v)): 4:2:0, 4:4:4 and mono
FILTER_CASES = [
    (96, 128, 1, False, 8, True, (1, 2, 3)),
    (96, 128, 1, False, 10, True, (0, 0, 0)),
    (64, 128, 1, False, 10, False, (3, 0, 1)),
    (96, 128, 0, False, 8, True, (2, 3, 0)),
    (64, 64, 0, False, 10, True, (0, 1, 2)),
    (96, 128, 0, True, 8, True, (1, 0, 0)),
    (64, 128, 0, True, 10, False, (0, 0, 0)),
]


def filters_exec_inputs(case, seed=0):
    """Numpy inputs of one filters_exec call, made from a seed: the planes
    as int16, every mask and map at the shape the decoder's host side
    gives it (the (1, 1) placeholders where a stream has no such plane or
    the filter is off), and the static keyword arguments.
    tests/test_torch_fallbacks.py sends the same inputs through thor_tpu."""
    H, W, sub, mono, bd, deblocking, (s_y, s_u, s_v) = case
    rng = np.random.default_rng([seed, H, W, sub, int(mono), bd])
    ph, pw = H >> sub, W >> sub

    def plane(h, w):
        # smooth ramps with noise, so that deblock and CDEF both act
        base = (np.add.outer(np.arange(h) * 3, np.arange(w) * 2) +
                rng.integers(-20, 21, (h, w)) * (rng.random((h, w)) < 0.3))
        return (base % (1 << bd)).astype(np.int16)

    def mask(h, w, p=0.6):
        return rng.random((h, w)) < p

    one = np.zeros((1, 1), bool)
    nby, nbx = (H + 7) // 8, (W + 7) // 8
    chroma = not mono
    u, v = ((plane(ph, pw), plane(ph, pw)) if chroma
            else (np.zeros((1, 1), np.int16),) * 2)
    sec = np.array([0, 1, 2, 4], np.int32)
    args = [
        plane(H, W), u, v,
        mask(H // 4, W // 8 - 1) if deblocking else one,
        mask(H // 8 - 1, W // 4) if deblocking else one,
        mask(H // 8, W // 8 - 1) if deblocking and chroma else one,
        mask(H // 8 - 1, W // 8) if deblocking and chroma else one,
        rng.integers(0, 32, (nby, nbx)).astype(np.int32),
        sec[rng.integers(0, 4, (nby, nbx))], mask(H, W),
        (rng.integers(0, 32, (nby, nbx)).astype(np.int32) if chroma
         else np.zeros((1, 1), np.int32)),
        (sec[rng.integers(0, 4, (nby, nbx))] if chroma
         else np.zeros((1, 1), np.int32)),
        mask(ph, pw) if chroma else one, mask(ph, pw) if chroma else one,
        mask(H, W) if s_y else one,
        mask(ph, pw) if s_u and chroma else one,
        mask(ph, pw) if s_v and chroma else one]
    qp = int(rng.integers(20, 52))
    kw = dict(qp=qp, qpc=int(T.CHROMA_QP[qp]) if sub else qp, bd=bd, sub=sub,
              mono=mono, deblocking=deblocking,
              cdef_damping=int(rng.integers(3, 7)), cs=bd - 8, s_y=s_y,
              s_u=s_u, s_v=s_v, qpclpf=qp >> 4)
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", FILTER_CASES, ids=str)
def test_filters_exec_on_the_card_equals_cpu(cuda, case):
    from thor_tpu_torch.ops import filters as OF
    args, kw = filters_exec_inputs(case)
    got = OF.filters_exec(*_on(cuda, args), **kw)
    want = OF.filters_exec(*_on("cpu", args), **kw)
    assert got.dtype == torch.int16 and torch.equal(got.cpu(), want)


def _golden(name):
    import os
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                        name)
    with open(base + ".bit", "rb") as f:
        data = f.read()
    with open(base + "_rec.yuv", "rb") as f:
        return data, f.read()


@pytest.mark.cuda
def test_frame_exec_on_the_card_equals_cpu(cuda, monkeypatch):
    """The two-stage executor's device half on the plans of a golden's P
    frames (with and without bipred), the card against the CPU; K1 once or
    twice a frame, K2 twice or four times, K3 never."""
    from thor_tpu_torch import decode_stream
    from thor_tpu_torch.dec import device_pixels as DP
    seen = []
    orig = DP.build_exec_inputs

    def keep(dec, plan, refs):
        out = orig(dec, plan, refs)
        seen.append(out)
        return out

    monkeypatch.setattr(DP, "build_exec_inputs", keep)
    data, golden = _golden("small256_LDB_medium_complexity")
    _, frames = decode_stream(data, device="cpu", fused=False)
    assert b"".join(frames) == golden and len(seen) == 7
    assert {s["has_avg"] for _, s in seen} == {True, False}

    def on(dev, a):
        if isinstance(a, dict):
            return {k: on(dev, v) for k, v in a.items()}
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for arrs, static in seen:
        before = MC.LUMA_LAUNCHES, MC.CHROMA_LAUNCHES, MC.CHROMA_UV_LAUNCHES
        got = DP.frame_exec(**on(cuda, arrs), **static)
        torch.cuda.synchronize()
        after = MC.LUMA_LAUNCHES, MC.CHROMA_LAUNCHES, MC.CHROMA_UV_LAUNCHES
        lists = 2 if static["has_avg"] else 1
        assert tuple(a - b for a, b in zip(after, before)) == (
            lists, 2 * lists, 0)
        want = DP.frame_exec(**on("cpu", arrs), **static)
        assert got.dtype == torch.int16 and torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("name,fused", [
    ("tiny64_ldblc", False), ("small256_LDB_high_efficiency", True),
    ("c444_128", True)])
def test_unfused_routes_decode_on_the_card(cuda, name, fused):
    """Two-stage frames and host records with the card's filters_exec:
    byte-equal to the golden, no frame on the fused route."""
    from thor_tpu_torch import decode_stream
    from thor_tpu_torch.dec import decoder as PD
    data, golden = _golden(name)
    PD.ROUTE_FRAMES.update(dict.fromkeys(PD.ROUTE_FRAMES, 0))
    _, frames = decode_stream(data, device=cuda, fused=fused)
    assert b"".join(frames) == golden
    assert PD.ROUTE_FRAMES["fused"] == 0
