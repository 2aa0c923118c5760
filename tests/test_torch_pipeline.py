"""thor_tpu_torch's tile pipeline against thor_tpu's, exactly (tolerance
0: integer arithmetic).

The tile MC functions, the static-qp dequantization, the reconstruction
and the two whole-frame functions of thor_tpu_torch/models/pipeline.py run
on the CPU (where the MC wrappers use their plain versions) on inputs made
from a seed with numpy, against thor_tpu's XLA formulations
(thor_tpu/ops/mc.py, `platform="cpu"`).  On a card the same functions go
through the CUDA kernels (tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from thor_tpu.models import pipeline as JP
from thor_tpu.ops import mc as JMC
from thor_tpu.ops import transform as JT
from thor_tpu_torch import entry as PE
from thor_tpu_torch.models import pipeline as PP
from thor_tpu_torch.ops import mc as PMC
from thor_tpu_torch.ops import transform as PT

torch.set_num_threads(1)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _tiles(rng, n, Hp, Wp, tile, taps, nfrac):
    """n tiles whose windows lie inside the plane, every (fv, fh) pair
    present (tile k takes pair k mod nfrac^2)."""
    oy = rng.integers(0, Hp - tile - taps + 1, n).astype(np.int32)
    ox = rng.integers(0, Wp - tile - taps + 1, n).astype(np.int32)
    k = np.arange(n) % (nfrac * nfrac)
    return oy, ox, (k // nfrac).astype(np.int32), (k % nfrac).astype(np.int32)


def test_unit_taps_at_fraction_zero():
    """The tile functions send fraction (0,0) to the kernels' copy op:
    tap row 0 of every bank must be the unit tap."""
    from thor_tpu_torch import tables as T
    for bank in (T.COEFFS_STANDARD, T.COEFFS_BIPRED):
        assert list(bank[0]) == [0, 0, 64, 0, 0, 0]
    assert list(T.COEFFS_CHROMA[0]) == [0, 64, 0, 0]


@pytest.mark.parametrize("bitdepth", [8, 10])
@pytest.mark.parametrize("bipred", [0, 1, 2])
def test_mc_luma_tiles(bipred, bitdepth):
    rng = np.random.default_rng(100 + 10 * bipred + bitdepth)
    Hp, Wp, n = 72, 88, 64
    ref = rng.integers(0, 1 << bitdepth, (Hp, Wp)).astype(np.int32)
    oy, ox, fv, fh = _tiles(rng, n, Hp, Wp, 16, 5, 4)
    want = np.asarray(JMC.mc_luma_tiles(ref, oy, ox, fv, fh, tile=16,
                                        bipred=bipred, bitdepth=bitdepth))
    got = PMC.mc_luma_tiles(*_t(ref, oy, ox, fv, fh), tile=16, bipred=bipred,
                            bitdepth=bitdepth)
    assert got.dtype == torch.int32 and got.shape == (n, 16, 16)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("bitdepth", [8, 10])
def test_mc_chroma_tiles(bitdepth):
    """All 64 fractions; the one-plane function, and U and V in one call
    against two single-plane JAX calls."""
    rng = np.random.default_rng(200 + bitdepth)
    Hp, Wp, n = 48, 56, 128
    refu, refv = (rng.integers(0, 1 << bitdepth, (Hp, Wp)).astype(np.int32)
                  for _ in range(2))
    oy, ox, fv, fh = _tiles(rng, n, Hp, Wp, 8, 3, 8)
    wu, wv = (np.asarray(JMC.mc_chroma_tiles(r, oy, ox, fv, fh, tile=8,
                                             bitdepth=bitdepth))
              for r in (refu, refv))
    got = PMC.mc_chroma_tiles(*_t(refu, oy, ox, fv, fh), tile=8,
                              bitdepth=bitdepth)
    assert got.dtype == torch.int32 and got.shape == (n, 8, 8)
    assert np.array_equal(got.numpy(), wu)
    gu, gv = PMC.mc_chroma_uv_tiles(*_t(refu, refv, oy, ox, fv, fh), tile=8,
                                    bitdepth=bitdepth)
    assert np.array_equal(gu.numpy(), wu) and np.array_equal(gv.numpy(), wv)


@pytest.mark.parametrize("tile,cs,back,luma", [(16, 4, 2, True),
                                               (8, 2, 1, False)])
def test_tiles_through_cells_equal_whole_tiles(tile, cs, back, luma):
    """The expansion that feeds the CUDA kernels (a tile as (tile/cs)^2
    cells with advancing origins, folded back) gives the plain version on
    whole tiles, which the tests above hold to thor_tpu."""
    rng = np.random.default_rng(300 + tile)
    Hp, Wp, n = 64, 80, 48
    ref = rng.integers(0, 256, (Hp, Wp)).astype(np.int32)
    nfrac = 4 if luma else 8
    oy, ox, fv, fh = _t(*_tiles(rng, n, Hp, Wp, tile, 2 * back + 1, nfrac))
    stack = torch.from_numpy(ref.astype(np.int16))[None]
    zero = torch.zeros_like(fv)
    for bipred in ((0, 1, 2) if luma else (None,)):
        op, fs = PMC._tile_ops(fv, fh, bipred)
        if luma:
            want = PMC.mc_luma_tiles(torch.from_numpy(ref), oy, ox, fv, fh,
                                     tile, bipred, 8)
            y0, x0, *meta = PMC._tiles_to_cells(
                oy, ox, (zero, op, fv, fh, fs), tile, cs, back)
            rsel, opc, vf, hf, fsc = meta
            cells = PMC.mc_cells_luma(stack, rsel, y0, x0, opc, vf, hf, fsc,
                                      cs, 8)
        else:
            want = PMC.mc_chroma_tiles(torch.from_numpy(ref), oy, ox, fv, fh,
                                       tile, 8)
            cells = PMC.mc_cells_chroma(
                stack, *PMC._chroma_tile_cells(oy, ox, fv, fh, tile), cs, 8)
        got = PMC._cells_to_tiles(cells, n, tile, cs)
        assert torch.equal(got, want)


@pytest.mark.parametrize("size", [4, 8, 16, 32])
@pytest.mark.parametrize("qp", [3, 22, 32, 51])
def test_dequantize_batch(size, qp):
    """Unweighted and weighted, values large enough for the int16 wrap."""
    rng = np.random.default_rng(size * 100 + qp)
    qs = min(size, 16)
    coeff = rng.integers(-3000, 3000, (33, size, size)).astype(np.int32)
    iw = rng.integers(16, 256, (qs, qs)).astype(np.int32)
    want = np.asarray(JT.dequantize_batch(coeff, qp, size))
    got = PT.dequantize_batch(torch.from_numpy(coeff), qp, size)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    want = np.asarray(JT.dequantize_batch(coeff, qp, size, iw, weighted=True))
    got = PT.dequantize_batch(torch.from_numpy(coeff), qp, size,
                              torch.from_numpy(iw), weighted=True)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("bitdepth", [8, 10])
def test_reconstruct_batch(bitdepth):
    """Predictions past the int16 range wrap before the add."""
    rng = np.random.default_rng(bitdepth)
    res = rng.integers(-2000, 2000, (40, 8, 8)).astype(np.int32)
    pred = rng.integers(-70000, 70000, (40, 8, 8)).astype(np.int32)
    want = np.asarray(JT.reconstruct_batch(res, pred, bitdepth))
    got = PT.reconstruct_batch(*_t(res, pred), bitdepth)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("height,width", [(64, 128), (288, 352)])
def test_make_examples_equal_thor_tpu(height, width):
    for got, want in ((PP.make_example(height, width, seed=3),
                       JP.make_example(height, width, seed=3)),
                      (PP.make_example_full(height, width, seed=3)[0],
                       JP.make_example_full(height, width, seed=3)[0])):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("height,width", [(64, 128), (288, 352)])
def test_decode_inter_frame_16(height, width):
    args = PP.make_example(height, width, qp=32, seed=5)
    want = np.asarray(JP.decode_inter_frame_16(
        *args, height=height, width=width, qp=32, platform="cpu"))
    got = PP.decode_inter_frame_16(*args, height=height, width=width, qp=32,
                                   device="cpu")
    assert got.dtype == torch.int32 and got.shape == (height, width)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("height,width,bitdepth,qp", [
    (64, 128, 8, 32), (64, 128, 10, 35), (288, 352, 8, 32)])
def test_decode_p_frame_420(height, width, bitdepth, qp):
    """64x128 has 32 tiles (the U+V branch), CIF 396 (one plane at a
    time); on the CPU both run the plain versions."""
    args, _, _ = PP.make_example_full(height, width, qp, seed=7,
                                      bitdepth=bitdepth)
    kw = dict(height=height, width=width, qp=qp, bitdepth=bitdepth,
              clpf_strengths=(2, 1, 4), cdef_damping=(6, 5))
    want = JP.decode_p_frame_420(*args, platform="cpu", **kw)
    got = PP.decode_p_frame_420(*args, device="cpu", **kw)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_chroma_branch_follows_the_tile_count(monkeypatch):
    """decode_p_frame_420 calls the U+V function when the tile count is a
    multiple of 16, else the one-plane function once per plane."""
    calls = []
    uv, one = PP.mc_chroma_uv_tiles, PP.mc_chroma_tiles
    monkeypatch.setattr(PP, "mc_chroma_uv_tiles",
                        lambda *a, **k: calls.append("uv") or uv(*a, **k))
    monkeypatch.setattr(PP, "mc_chroma_tiles",
                        lambda *a, **k: calls.append("one") or one(*a, **k))
    for (h, w), want in (((64, 128), ["uv"]), ((48, 80), ["one", "one"])):
        calls.clear()
        args, _, _ = PP.make_example_full(h, w, 32, seed=1)
        PP.decode_p_frame_420(*args, height=h, width=w, device="cpu")
        assert calls == want


def test_entry_runs_on_the_cpu():
    """entry() returns the CIF forward step and its arguments on the
    device asked for; without a card it must be asked for the CPU."""
    import __graft_entry__ as G
    fn, args = PE.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    y, u, v = fn(*args)
    assert y.shape == (288, 352) and u.shape == v.shape == (144, 176)
    jfn, jargs = G.entry()
    assert fn.keywords["clpf_strengths"] == jfn.keywords["clpf_strengths"]
    for a, j in zip(args, jargs):
        assert np.array_equal(a.numpy(), np.asarray(j))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            PE.entry()
