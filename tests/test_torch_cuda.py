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
from thor_tpu_torch import trace as TR
from thor_tpu_torch.kernels import build
from thor_tpu_torch.ops import mc as MC
from torch_intra_cases import intra_planes, quadtree_recs, wave_inputs

LUMA = ("rsel", "y0", "x0", "op", "vf", "hf", "fs")
CHROMA = ("rsel", "y0", "x0", "op", "vf", "hf")


def launches():
    """(luma, one-plane chroma, chroma U+V) MC kernel launches so far."""
    return tuple(TR.counter(f"mc.{k}_launches")
                 for k in ("luma", "chroma", "chroma_uv"))


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
    before = launches()[0]
    got = MC.mc_cells_luma(ref, *cells, 4, bitdepth)
    torch.cuda.synchronize()
    assert launches()[0] == before + 1
    assert torch.equal(got, MC.mc_cells_luma_plain(ref, *cells, 4, bitdepth))


@pytest.mark.cuda
@pytest.mark.parametrize("bitdepth", [8, 10])
def test_chroma_kernel_equals_plain(cuda, bitdepth):
    rng = np.random.default_rng(60 + bitdepth)
    R, Hp, Wp, n = 2, 120, 152, 5000
    u, v = (torch.from_numpy(rng.integers(0, 1 << bitdepth, (R, Hp, Wp))
                             .astype(np.int16)).to(cuda) for _ in range(2))
    cells = _cells(rng, n, R, Hp, Wp, 2, 8, False, cuda)
    before = launches()
    pu, pv = MC.mc_cells_chroma_uv(u, v, *cells, 2, bitdepth)
    assert launches()[1:] == (before[1], before[2] + 1)
    one = MC.mc_cells_chroma(v, *cells, 2, bitdepth)
    torch.cuda.synchronize()
    assert launches()[1:] == (before[1] + 1, before[2] + 1)
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
    before = launches()[0]
    got = MC.mc_luma_tiles(*_on(cuda, args), tile=16, bipred=bipred,
                           bitdepth=bitdepth)
    torch.cuda.synchronize()
    assert launches()[0] == before + 1
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
    before = launches()[1:]
    one_u = MC.mc_chroma_tiles(refu, *meta, tile=8, bitdepth=bitdepth)
    one_v = MC.mc_chroma_tiles(refv, *meta, tile=8, bitdepth=bitdepth)
    assert launches()[1:] == (before[0] + 2, before[1])
    pu, pv = MC.mc_chroma_uv_tiles(refu, refv, *meta, tile=8,
                                   bitdepth=bitdepth)
    torch.cuda.synchronize()
    assert launches()[1:] == (before[0] + 2, before[1] + 1)
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
    before = launches()
    got = PP.decode_p_frame_420(*args, device=cuda, **kw)
    torch.cuda.synchronize()
    after = launches()
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
        before = launches()
        got = DP.frame_exec(**on(cuda, arrs), **static)
        torch.cuda.synchronize()
        after = launches()
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
    TR.reset(*PD.ROUTE_COUNTERS)
    _, frames = decode_stream(data, device=cuda, fused=fused)
    assert b"".join(frames) == golden
    assert PD.route_frames()["fused"] == 0


# ------------------------------------------- the intra wave scan kernel

def _intra_route(dev, planes, res, segs, segcls, bd, cfl, sizes):
    from thor_tpu_torch.dec import device_frame as PDF
    H, W = res[0].shape[0] - 8, res[0].shape[1] - 16
    cut = ((H, W), (H // 2, W // 2), (H // 2, W // 2))
    rt = [torch.from_numpy(r).to(dev)[:h, :w] for r, (h, w) in zip(res, cut)]
    out = PDF._intra_waves(*[torch.from_numpy(p.copy()).to(dev)
                             for p in planes], segs, segcls, *rt, bd, cfl,
                           sizes)
    return [t.cpu() for t in out]


def intra_frames(kind):
    """(H, W, sb, apron, lanes, generation sizes, modes) of each frame of
    one card case."""
    if kind == "uniform":    # one size a frame, every mode and mode -1
        return [(H, W, max(64, n), 136, 64, (n,), None)
                for n, H, W in ((8, 128, 128), (16, 128, 128),
                                (32, 128, 128), (64, 192, 256),
                                (128, 384, 512))]
    sizes = (8, 16, 32, 64, 128)
    return [{"quadtree": (256, 384, 128, 136, 64, sizes, (-1, 11)),
             # write windows end on the planes' last row and column
             "edge": (256, 384, 128, 120, 64, sizes, (-1, 11)),
             # no apron: reads and writes clamp (a block a segment)
             "clamped": (256, 384, 128, 0, 1, sizes, (-1, 11))}[kind]]


@pytest.mark.cuda
@pytest.mark.parametrize("cfl", [False, True])
@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("kind", ["quadtree", "uniform", "edge", "clamped"])
def test_intra_wave_kernel_equals_the_torch_route(cuda, kind, bd, cfl):
    """_intra_waves on the card (csrc/intra_wave.cu, one launch a
    segment) equals its CPU route, the torch loop, bit for bit: random
    quadtree frames of sizes 8-128 with blocks on row 0 and column 0 and
    every ur/dl pair, frames of one size with all 10 modes and one out of
    range, write windows that end on the apron's edge, and clamped reads
    and writes; dec.intra_kernel_segments counts the segments."""
    from thor_tpu_torch.dec import device_frame as PDF
    from thor_tpu_torch.dec import native_parse as NP
    rng = np.random.default_rng(1500 + 10 * bd + cfl)
    remapped = set()
    for H, W, sb, apron, lanes, gen, modes in intra_frames(kind):
        recs = quadtree_recs(rng, H, W, gen, sb, modes or (0, 10))
        if modes is None:
            recs[:, NP.B_INTRA_MODE] = np.arange(len(recs)) % 12 - 1
        sizes = tuple(s for s in PDF.INTRA_SIZES if s <= min(H, W))
        nseg, segs, segcls = wave_inputs(recs, H, W, sizes, sb, lanes)
        if kind == "quadtree":
            act = segs[:, :, 0] > 0
            assert set(zip(segs[act, 5], segs[act, 6])) == {
                (0, 0), (0, 1), (1, 0), (1, 1)}
        planes, res = intra_planes(rng, H, W, bd, apron)
        before = TR.counter("dec.intra_kernel_segments")
        got = _intra_route(cuda, planes, res, segs, segcls, bd, cfl, sizes)
        torch.cuda.synchronize()
        assert TR.counter("dec.intra_kernel_segments") == before + nseg
        want = _intra_route("cpu", planes, res, segs, segcls, bd, cfl,
                            sizes)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (kind, H, W)
        if cfl:
            off = _intra_route(cuda, planes, res, segs, segcls, bd, False,
                               sizes)
            remapped |= {c for c in (1, 2)
                         if not torch.equal(off[c], got[c])}
    assert remapped == ({1, 2} if cfl else set())   # CFL engaged in U, V


# ------------------------------------------------------ the turbo encoder

def _enc_frames(rng, h, w, bd=8):
    hi = (1 << bd) - 1
    base = (np.linspace(0, hi * 0.7, w)[None, :] +
            np.linspace(0, hi * 0.2, h)[:, None])
    org = np.clip(base + rng.integers(-hi // 16, hi // 16, (h, w)), 0,
                  hi).astype(np.int32)
    ref = np.pad(np.clip(np.roll(org, (3, -5), axis=(0, 1)) +
                         rng.integers(-4, 5, (h, w)), 0, hi), 160,
                 mode="edge").astype(np.int32)
    orgp = np.zeros((h + 130, w + 130), np.int32)
    orgp[:h, :w] = org
    return org, orgp, ref


def _both(fn, dev, *arrays, **kw):
    """fn on the card and on the CPU over the same numpy inputs; every
    output equal."""
    def on(d, a):
        if isinstance(a, np.ndarray):
            return torch.from_numpy(a).to(d)
        return a.to(d) if isinstance(a, torch.Tensor) else a

    outs = []
    for d in (dev, torch.device("cpu")):
        r = fn(*[on(d, a) for a in arrays],
               **{k: on(d, a) for k, a in kw.items()})
        outs.append([t.cpu() for t in (r if isinstance(r, tuple) else (r,))])
    for g, w in zip(*outs):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("tb", [False, True])
def test_turbo_decisions_on_the_card_equal_cpu(cuda, tb):
    """The decision pass's functions (enc/turbo.py) on the card equal
    themselves on the CPU: motion search, inter (tb trial on and off),
    skip, intra (4 and 10 modes) and bipred costs."""
    from thor_tpu_torch.enc import turbo as PT
    rng = np.random.default_rng(70 + tb)
    H, W = 64, 128
    org, orgp, ref = _enc_frames(rng, H, W)
    _, _, ref2 = _enc_frames(rng, H, W)
    lam = torch.tensor(np.float32(49.03))
    orgh, refh = (PT.scale2(torch.from_numpy(a)).numpy() for a in (org, ref))
    _both(PT.prepass_half, cuda, orgh, refh, H // 2, W // 2)
    mvh = PT.prepass_half(torch.from_numpy(orgh), torch.from_numpy(refh),
                          H // 2, W // 2).numpy()
    _both(PT.refine16, cuda, org, ref, mvh, H, W, 8)
    mv16 = PT.refine16(torch.from_numpy(org), torch.from_numpy(ref),
                       torch.from_numpy(mvh), H, W, 8).numpy()
    _both(PT.upsize_mv, cuda, org, ref, mv16, H, W, 32, 8)
    for s in (8, 16, 32, 64):
        n = (H // s) * (W // s)
        mv = rng.integers(-40, 40, (n, 2)).astype(np.int32)
        mv2 = rng.integers(-40, 40, (n, 2)).astype(np.int32)
        _both(PT.eval_inter, cuda, org, ref, mv, lam, 30, H, W, s, 8,
              tb_trial=tb)
        _both(PT.eval_skip, cuda, org, ref, mv, lam, H, W, s, 8)
        _both(PT.eval_bipred, cuda, org, ref, ref2, mv, mv2, lam, 34, H, W,
              s, 8, tb_trial=tb)
        for nim in (4, 10):
            _both(PT.eval_intra, cuda, orgp, org, lam, 27, H, W, s, 8,
                  nim=nim)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_turbo_ops_on_the_card_equal_cpu(cuda, size):
    """Forward transform, quantizer (plain and weighted) and the exact bit
    count on the card equal themselves on the CPU."""
    from thor_tpu_torch.ops import coeff_cost as PC
    from thor_tpu_torch.ops import quant as PQ
    from thor_tpu_torch.ops import transform as PTR
    rng = np.random.default_rng(80 + size)
    qs = min(size, 16)
    res = rng.integers(-1023, 1024, (64, size, size)).astype(np.int32)
    for fast in (False, True):
        _both(PTR.fwd_transform_batch, cuda, res, size, fast, 10)
    co = (rng.normal(0, 400, (64, qs, qs)) *
          (rng.random((64, qs, qs)) < 0.4)).astype(np.int16)
    wm = rng.integers(16, 160, (qs, qs)).astype(np.int64)
    for intra in (0, 1):
        for qp in (4, 33, 51):
            _both(PQ.quantize_batch, cuda, co, qp, size, intra)
            _both(PQ.quantize_batch, cuda, co, qp, size, intra,
                  wmatrix=wm, weighted=True)
    sc = (rng.integers(-30, 31, (64, qs * qs)) *
          (rng.random((64, qs * qs)) < 0.3)).astype(np.int32)
    for chroma in (0, 1):
        for intra in (0, 1):
            _both(PC.coeff_bits_batch, cuda, sc, size, chroma, intra)


@pytest.mark.cuda
def test_turbo_encodes_on_the_card_equal_thor_tpus_streams(cuda):
    """The LC configuration of tests/test_torch_turbo.py encoded on the
    card: thor_tpu's stream (tests/torch_turbo/lc.bit), with the luma and
    the one-plane chroma kernel launched by the finalizer."""
    import hashlib
    import json
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as CS
    from thor_tpu_torch import encode_sequence
    from thor_tpu_torch.enc.params import EncParams
    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_turbo")
    with open(os.path.join(fix, "fixtures.json")) as f:
        meta = json.load(f)
    W, H, N, seed, kw = CS.TURBO_FIXTURES["lc"]
    before = launches()
    bs, rec = encode_sequence(
        EncParams(width=W, height=H, num_frames=N, turbo=1,
                  **dict(CS.LC_KW, **kw)),
        CS.fixture_clip(W, H, N, seed), device=cuda)
    with open(os.path.join(fix, "lc.bit"), "rb") as f:
        assert bs == f.read()
    assert hashlib.sha256(rec).hexdigest() == meta["lc"]["rec_sha256"]
    after = launches()
    # one P frame: the luma kernel once, the one-plane kernel for U and V
    assert (after[0] - before[0], after[1] - before[1],
            after[2] - before[2]) == (1, 2, 0)


@pytest.mark.cuda
def test_exact_encoder_on_the_card_writes_the_golden(cuda):
    """tiny64_ldblc with the exact host-RDO encoder (turbo=0) and its frame
    tail on the card: the reference's golden stream and recon, and no MC
    kernel launched (the host RDO predicts in numpy)."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as CS
    from thor_tpu_torch import encode_sequence
    from thor_tpu_torch.enc.params import parse_config_file
    gdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "golden")
    p = parse_config_file(os.path.join(gdir, "config_LDB_low_complexity.txt"),
                          width=64, height=64, num_frames=6, qp=32,
                          frame_rate=30.0)
    before = launches()
    bs, rec = encode_sequence(p, CS.make_tiny64(6), device=cuda)
    with open(os.path.join(gdir, "tiny64_ldblc.bit"), "rb") as f:
        assert bs == f.read()
    with open(os.path.join(gdir, "tiny64_ldblc_rec.yuv"), "rb") as f:
        assert rec == f.read()
    assert launches() == before


@pytest.mark.cuda
def test_device_encoder_on_the_card_equals_thor_tpus(cuda):
    """The wavefront device encoder (device_enc=1) on the card, on
    tests/test_torch_device_lc.py's 128x128 configuration: thor_tpu's
    device-route stream and recon (tests/torch_device_lc/lc128.bit), both
    frames through device_lc, and no MC kernel launched (device_lc reads
    its MC from the variant stacks)."""
    import hashlib
    import json
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as CS
    from thor_tpu_torch import encode_sequence
    from thor_tpu_torch.enc import device_lc as D
    from thor_tpu_torch.enc.params import EncParams
    name, W, H, N, seed = CS.DEVENC_FIXTURE
    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_device_lc")
    with open(os.path.join(fix, "fixtures.json")) as f:
        meta = json.load(f)[name]
    frames = []
    dev = D.encode_frame_device
    D.encode_frame_device = lambda enc: frames.append(enc.fi.frame_num) or \
        dev(enc)
    before = launches()
    try:
        bs, rec = encode_sequence(
            EncParams(width=W, height=H, num_frames=N, device_enc=1,
                      **CS.LC_KW), CS.fixture_clip(W, H, N, seed, roll=2),
            device=cuda)
    finally:
        D.encode_frame_device = dev
    with open(os.path.join(fix, name + ".bit"), "rb") as f:
        assert bs == f.read()
    assert hashlib.sha256(rec).hexdigest() == meta["rec_sha256"]
    assert frames == list(range(N))
    assert launches() == before


# ------------------------------------------- device encoder's CUDA graphs

def _devenc_fixture(name):
    """chip_smoke's clip of a tests/torch_device_lc configuration, and
    thor_tpu's stream and recon sha256 of it."""
    import json
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as CS
    from thor_tpu_torch.enc.params import EncParams
    _, W, H, N, seed = {c[0]: c for c in CS.DEVENC_FIXTURES +
                        (CS.DEVENC_REUSE,)}[name]
    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_device_lc")
    with open(os.path.join(fix, "fixtures.json")) as f:
        meta = json.load(f)[name]
    with open(os.path.join(fix, name + ".bit"), "rb") as f:
        want = f.read()
    return (EncParams(width=W, height=H, num_frames=N, device_enc=1,
                      **CS.LC_KW), CS.fixture_clip(W, H, N, seed, roll=2),
            want, meta["rec_sha256"])


def _graph_log(monkeypatch):
    """A fresh graph cache, and per frame_megakernel call on the card the
    captures and replays it made: [[captures, replays], ...]."""
    import collections
    from thor_tpu_torch.enc import device_lc as D
    monkeypatch.setattr(D.DiagonalGraph, "_cache",
                        collections.OrderedDict())
    log = []
    run, capture, replay = (D.DiagonalGraph.run, D.DiagonalGraph.capture,
                            D.DiagonalGraph.replay)

    def counted_run(self, *a):
        log.append([0, 0])
        return run(self, *a)

    def counted(fn, i):
        def call(self):
            log[-1][i] += 1
            return fn(self)
        return call
    monkeypatch.setattr(D.DiagonalGraph, "run", counted_run)
    monkeypatch.setattr(D.DiagonalGraph, "capture", counted(capture, 0))
    monkeypatch.setattr(D.DiagonalGraph, "replay", counted(replay, 1))
    return log


@pytest.mark.cuda
@pytest.mark.parametrize("name,graphs", [
    ("lc128", [[0, 0], [0, 0]]),        # one diagonal: the eager warm-up
    ("edges264", [[1, 4], [1, 4]])])     # D = 5: capture, then 4 replays
def test_graph_route_on_the_card_equals_thor_tpus(cuda, monkeypatch, name,
                                                  graphs):
    """frame_megakernel on the card (the default route): thor_tpu's
    stream and recon, through one capture and D - 1 replays a frame.
    Each frame's run (copies in, the eager warm-up, the capture, the
    replays, the copies out) goes under
    torch.cuda.set_sync_debug_mode("error"), so a hidden synchronisation
    (a bool mask, nonzero, .item(), an upload) raises."""
    import hashlib
    from thor_tpu_torch import encode_sequence
    from thor_tpu_torch.enc import device_lc as D
    log = _graph_log(monkeypatch)
    run = D.DiagonalGraph.run

    def strict(self, *a):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return run(self, *a)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    monkeypatch.setattr(D.DiagonalGraph, "run", strict)
    p, yuv, want, rec_sha = _devenc_fixture(name)
    bs, rec = encode_sequence(p, yuv, device=cuda)
    assert bs == want
    assert hashlib.sha256(rec).hexdigest() == rec_sha
    assert log == graphs


@pytest.mark.cuda
def test_graph_replays_over_frames_it_did_not_capture(cuda, monkeypatch):
    """edges264x4 (I, P with one reference, P and P with two): frame 3
    replays the graph captured on frame 2 (D = 5 replays), and the
    stream and recon are thor_tpu's."""
    import hashlib
    from thor_tpu_torch import encode_sequence
    log = _graph_log(monkeypatch)
    p, yuv, want, rec_sha = _devenc_fixture("edges264x4")
    bs, rec = encode_sequence(p, yuv, device=cuda)
    assert bs == want
    assert hashlib.sha256(rec).hexdigest() == rec_sha
    assert log == [[1, 4], [1, 4], [1, 4], [0, 5]]


@pytest.mark.cuda
def test_graph_route_from_threads_at_once(cuda, monkeypatch):
    """edges264, lc128 and edges264 again through encode_streams_sharded
    at once (a thread each): captures and launches of other threads
    overlap, the two edges264 jobs share one cache entry; each stream and
    recon is thor_tpu's."""
    import hashlib
    from thor_tpu_torch.enc.multistream import encode_streams_sharded
    _graph_log(monkeypatch)
    names = ("edges264", "lc128", "edges264")
    fix = [_devenc_fixture(n) for n in names]
    out = encode_streams_sharded([(p, yuv) for p, yuv, _, _ in fix],
                                 devices=[cuda], lanes=False)
    for name, (bs, rec), (_, _, want, rec_sha) in zip(names, out, fix):
        assert bs == want, name
        assert hashlib.sha256(rec).hexdigest() == rec_sha, name


@pytest.mark.cuda
def test_graph_cache_keeps_the_most_recent(cuda, monkeypatch):
    """With room for one graph, edges264's P frame evicts the I frame's
    graph (after its last replay) and captures its own; the stream and
    recon are still thor_tpu's."""
    import hashlib
    from thor_tpu_torch import encode_sequence
    from thor_tpu_torch.enc import device_lc as D
    log = _graph_log(monkeypatch)
    monkeypatch.setattr(D.DiagonalGraph, "KEEP", 1)
    dropped = []
    drop = D.DiagonalGraph.drop
    monkeypatch.setattr(D.DiagonalGraph, "drop",
                        lambda self: dropped.append(self.cfg["is_i"]) or
                        drop(self))
    p, yuv, want, rec_sha = _devenc_fixture("edges264")
    bs, rec = encode_sequence(p, yuv, device=cuda)
    assert bs == want
    assert hashlib.sha256(rec).hexdigest() == rec_sha
    assert log == [[1, 4], [1, 4]]
    assert dropped == [True]
    assert len(D.DiagonalGraph._cache) == 1


@pytest.mark.cuda
def test_a_failing_capture_raises(cuda, monkeypatch):
    """A graph that fails to instantiate fails the encode with its cause;
    the host loop is not taken instead."""
    from thor_tpu_torch import encode_sequence
    from thor_tpu_torch.enc import device_lc as D
    _graph_log(monkeypatch)
    loops = []
    monkeypatch.setattr(D, "run_diagonal", lambda *a: loops.append(1))

    def fail(self):
        raise RuntimeError("instantiate refused (forced)")
    monkeypatch.setattr(torch.cuda.CUDAGraph, "instantiate", fail)
    p, yuv, _, _ = _devenc_fixture("edges264")
    with pytest.raises(RuntimeError, match="forced"):
        encode_sequence(p, yuv, device=cuda)
    assert loops == []


# ------------------------------------------- multi-stream decode and lanes

@pytest.mark.cuda
def test_batched_frame_exec_on_the_card_equals_cpu(cuda, monkeypatch):
    """frame_exec_batch over two streams' plans (small256's P frames, with
    and without bipred, paired with the next frame), padded as the
    multi-stream decode pads them: the card against the CPU; K1 once per
    MC list and K2 once per plane and list for both streams, K3 never."""
    from thor_tpu_torch import decode_stream
    from thor_tpu_torch.dec import device_pixels as DP
    from thor_tpu_torch.dec import multistream as MS
    seen = []
    orig = DP.build_exec_inputs

    def keep(dec, plan, refs):
        out = orig(dec, plan, refs)
        seen.append((MS.pad_stacks(dict(out[0])), out[1]))
        return out

    monkeypatch.setattr(DP, "build_exec_inputs", keep)
    data, golden = _golden("small256_LDB_medium_complexity")
    _, frames = decode_stream(data, device="cpu", fused=False)
    assert b"".join(frames) == golden and len(seen) == 7
    for (a0, s0), (a1, s1) in zip(seen, seen[1:]):
        has_avg = s0["has_avg"] or s1["has_avg"]
        sig = {k: v for k, v in s0.items() if k != "has_avg"}
        before = launches()
        got = DP.frame_exec_batch([DP.upload(a, cuda) for a in (a0, a1)],
                                  has_avg=has_avg, **sig)
        torch.cuda.synchronize()
        after = launches()
        lists = 2 if has_avg else 1
        assert tuple(a - b for a, b in zip(after, before)) == (
            lists, 2 * lists, 0)
        want = DP.frame_exec_batch([DP.upload(a, "cpu") for a in (a0, a1)],
                                   has_avg=has_avg, **sig)
        assert got.shape[0] == 2 and torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_pair_decode_on_the_card(cuda, monkeypatch):
    """tiny64_ldblc and tiny64_rc decoded in lockstep on the card: each
    its golden, one batch of both streams per P frame (K1 5, K2 10)."""
    from thor_tpu_torch.dec import device_pixels as DP
    from thor_tpu_torch.dec import multistream as MS
    names = ("tiny64_ldblc", "tiny64_rc")
    batches = []
    orig = DP.frame_exec_batch

    def counted(batch, **kw):
        batches.append(len(batch))
        return orig(batch, **kw)
    monkeypatch.setattr(DP, "frame_exec_batch", counted)
    before = launches()
    outs = MS.decode_streams_sharded([_golden(n)[0] for n in names],
                                     device=cuda)
    after = launches()
    for n, frames in zip(names, outs):
        assert b"".join(frames) == _golden(n)[1]
    assert batches == [2] * 5
    assert tuple(a - b for a, b in zip(after, before)) == (5, 10, 0)


@pytest.mark.cuda
def test_lanes_encode_on_the_card_equals_thor_tpus_stream(cuda):
    """tests/test_torch_turbo.py's ra_bframes with GOP-lane prefetch on the
    card: thor_tpu's sequential turbo stream and recon, >= 2 decision
    passes in flight."""
    import hashlib
    import json
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as CS
    from thor_tpu_torch import encode_sequence_lanes
    from thor_tpu_torch.enc.params import EncParams
    fix = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_turbo")
    with open(os.path.join(fix, "fixtures.json")) as f:
        meta = json.load(f)["ra_bframes"]
    W, H, N, seed, kw = CS.TURBO_FIXTURES["ra_bframes"]
    bs, rec, stats = encode_sequence_lanes(
        EncParams(width=W, height=H, num_frames=N, turbo=1,
                  **dict(CS.LC_KW, **kw)),
        CS.fixture_clip(W, H, N, seed), devices=[cuda])
    with open(os.path.join(fix, "ra_bframes.bit"), "rb") as f:
        assert bs == f.read()
    assert hashlib.sha256(rec).hexdigest() == meta["rec_sha256"]
    assert stats["max_in_flight"] >= 2 and stats["prefetched"] > 0


@pytest.mark.cuda
def test_kernel_library_loads_once_from_threads(cuda, monkeypatch):
    """8 stream threads ask for the kernel library at once: it is built
    and bound once, and every thread gets the same handle."""
    import sys
    import threading
    binds = []
    orig = build._bind
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_bind", lambda lib: binds.append(1) or
                        orig(lib))
    start = threading.Barrier(8)
    got = [None] * 8

    def run(i):
        start.wait(timeout=60)
        got[i] = build.load()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)   # switch threads as often as possible
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(binds) == 1
    assert all(g is got[0] for g in got) and got[0] is not None


# ------------------------------------------------------ the lockstep ME

def _me_scene(search, pad, rng):
    """(function name, numpy args, keywords) of one lockstep search on a
    128x96 frame: random blocks and candidates, a quarter of the blocks at
    the four frame corners with candidates past the clip bound (at pad
    144 their windows leave the plane, and dynamic_slice's rule
    applies)."""
    from thor_tpu_torch.frame import YuvFrame
    W, H, N = 128, 96, 32
    i32 = np.int32

    def plane():
        fr = YuvFrame(W, H, 420, pad, 8, 8)
        fr.y[:] = rng.integers(0, 256, (H, W))
        fr.pad_frame()
        return fr.y_full.astype(i32)

    size = 16
    ys = (rng.integers(0, (H - size) // 8, N) * 8).astype(i32)
    xs = (rng.integers(0, (W - size) // 8, N) * 8).astype(i32)
    ys[::4], xs[::4] = np.resize([0, 0, H - size, H - size], N // 4), \
        np.resize([0, W - size, 0, W - size], N // 4)
    cand = rng.integers(-12, 13, (N, 6, 2))
    cand[::4] = rng.choice([-200, 200], (N // 4, 6, 2))
    cand = cand.astype(i32)
    mvp = rng.integers(-20, 21, (N, 2)).astype(i32)
    lam = rng.uniform(1.0, 8.0, N)
    cn = rng.integers(0, 5, N).astype(i32)
    ref = plane()
    geo = dict(width=size, height=size, size=size, sign=int(rng.integers(2)),
               fwidth=W, fheight=H, bitdepth=8, mvc_y=-9, mvc_x=5)
    org = rng.integers(0, 256, (N, size, size)).astype(i32)
    me = (org, ref, pad, ys, xs, mvp[:, 0], mvp[:, 1], lam, cand[:, :4, 0],
          cand[:, :4, 1], np.maximum(cn, 1))
    if search == "fast":
        del geo["mvc_y"], geo["mvc_x"]
        return "motion_estimate_batch", me, geo
    if search == "telescope":
        return "motion_estimate_batch", me, dict(geo, telescope=True,
                                                 widesad32=True)
    if search == "speed0":
        return "motion_estimate_batch", me, dict(geo, telescope=True,
                                                 speed0=True)
    if search == "bi":
        return "motion_estimate_bi_batch", (
            org, ref, plane(), pad, ys, xs, mvp[:, 0], mvp[:, 1], lam,
            cand[:, :4, 0], cand[:, :4, 1], cn), dict(geo, bipred=1)
    boy = (rng.integers(0, 2, N) * 8).astype(i32)
    box = (rng.integers(0, 2, N) * 8).astype(i32)
    return "motion_estimate_sync_batch", (
        org[:, :8, :8].copy(), ref, pad, ys, xs, boy, box, mvp[:, 0],
        mvp[:, 1], lam, cand[:, :, 0], cand[:, :, 1]), dict(
            geo, width=8, height=8)


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [160, 144])
@pytest.mark.parametrize("search,k1", [("fast", 0), ("telescope", 0),
                                       ("speed0", 16), ("bi", 110),
                                       ("sync", 55)])
def test_lockstep_searches_on_the_card_equal_cpu(cuda, search, k1, pad):
    """ops/me_batch.py's searches on the card equal themselves on the
    CPU, with K1 launched once per mc_luma_tiles call (none on the fast
    and telescope paths) and K2, K3 never."""
    from thor_tpu_torch.ops import me_batch as ME
    fn, args, kw = _me_scene(search, pad, np.random.default_rng(
        len(search) + pad))
    before = launches()
    got = getattr(ME, fn)(*args, **kw, device=cuda)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(launches(), before)) == (k1, 0, 0)
    want = getattr(ME, fn)(*args, **kw, device="cpu")
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_block_kernels_and_candidates_on_the_card_equal_cpu(cuda):
    """ops/enc_kernels.py's plain kernels and ops/enc_cand.py's tables on
    the card equal themselves on the CPU."""
    from thor_tpu_torch.ops import enc_cand as EC
    from thor_tpu_torch.ops import enc_kernels as EK
    rng = np.random.default_rng(90)
    a, b = (rng.integers(-1023, 1024, (40, 16, 16)).astype(np.int32)
            for _ in range(2))
    for fn in (EK.sad_batch, EK.ssd_batch, EK.avg_batch):
        _both(fn, cuda, a, b)
    _both(EK.scale_down2x2, cuda, a[0])
    W, H = 200, 136
    ys, xs = (g.ravel().astype(np.int32) for g in np.meshgrid(
        np.arange(0, H, 8), np.arange(0, W, 8), indexing="ij"))
    grids = [rng.integers(-1, 2, (H // 4, W // 4)).astype(np.int32)
             for _ in range(7)]
    for size, sb in ((8, 64), (16, 128), (64, 64)):
        for fn in (EC.upright_available, EC.downleft_available):
            _both(fn, cuda, ys, xs, size, W, H, sb)
        _both(EC.mv_pred_batch, cuda, ys, xs, size, W, H, sb, *grids[:2])
        _both(lambda y, x, *g: EC.two_candidates_batch(
            y, x, size, W, H, sb, dict(zip(EC.DD_FIELDS, g))), cuda, ys,
            xs, *grids)
        _both(EC.block_contexts_batch, cuda, ys, xs, size, W, H, 1,
              *grids[:4])
