"""thor_tpu_torch's temporal interpolation against thor_tpu's, exactly.

Each stage (`me_bi_level`, `merge_level`, `interp_exec`) and the whole
`interpolate_frames` run on the CPU on planes made from a seed with numpy,
against the JAX functions of thor_tpu/ops/tempinterp.py on the same planes
(tolerance 0).  The stage tests use the two pyramid levels of a 64x64
frame, so that the JAX side compiles each function once for all of them.
"""
import numpy as np
import pytest
import torch

from thor_tpu.frame import YuvFrame as JFrame
from thor_tpu.ops import tempinterp as JTI
from thor_tpu.tables import PADDING_Y
from thor_tpu_torch.frame import YuvFrame as PFrame
from thor_tpu_torch.ops import tempinterp as PTI

torch.set_num_threads(1)


def _mk(cls, w, h, seed, bitdepth=8, moving=True):
    """Two frames, the second the first shifted 5 samples (or equal), as
    tests/test_tempinterp_device.py makes them."""
    rng = np.random.default_rng(seed)
    f0 = cls(w, h, 420, PADDING_Y, bitdepth, bitdepth)
    f1 = cls(w, h, 420, PADDING_Y, bitdepth, bitdepth)
    maxv = (1 << bitdepth) - 1
    base = np.clip(np.linspace(20, maxv - 20, w)[None, :] +
                   np.linspace(0, 40, h)[:, None] +
                   rng.integers(-12, 12, (h, w)), 0, maxv)
    f0.y[:, :] = base.astype(f0.dtype)
    f1.y[:, :] = (np.roll(base, 5, axis=1) if moving
                  else base).astype(f1.dtype)
    for f in (f0, f1):
        f.u[:, :] = rng.integers(0, maxv + 1, (h // 2, w // 2)
                                 ).astype(f.dtype)
        f.v[:, :] = rng.integers(0, maxv + 1, (h // 2, w // 2)
                                 ).astype(f.dtype)
        f.pad_frame()
    return f0, f1


def _both(w, h, ratio, pos, seed, bitdepth=8, moving=True):
    outs = []
    for cls, fn, kw in ((JFrame, JTI.interpolate_frames, {}),
                        (PFrame, PTI.interpolate_frames,
                         {"device": "cpu"})):
        f0, f1 = _mk(cls, w, h, seed, bitdepth, moving)
        out = cls(w, h, 420, PADDING_Y, bitdepth, bitdepth)
        fn(out, f0, f1, ratio, pos, **kw)
        outs.append(out)
    want, got = outs
    for p in ("y_full", "u_full", "v_full"):
        np.testing.assert_array_equal(getattr(got, p), getattr(want, p), p)
    return got


@pytest.mark.parametrize("ratio,pos", [(2, 1), (4, 1), (4, 3), (8, 5),
                                       (3, 1), (3, 2)])
def test_interpolate_frames(ratio, pos):
    _both(64, 64, ratio, pos, seed=ratio * 10 + pos)


def test_interpolate_frames_10bit():
    _both(64, 64, 4, 1, seed=2, bitdepth=10)


def test_interpolate_frames_equal_frames_skip(monkeypatch):
    """Two equal frames: the skip test fires (the background map of the
    finest level is all ones) and the result is the frame itself."""
    seen = []
    orig = PTI.me_bi_level

    def spy(*a, **k):
        r = orig(*a, **k)
        seen.append(r[2])
        return r

    monkeypatch.setattr(PTI, "me_bi_level", spy)
    got = _both(64, 64, 2, 1, seed=9, moving=False)
    assert len(seen) == 2 and bool((seen[-1] == 1).all())
    f0, _ = _mk(PFrame, 64, 64, 9, moving=False)
    np.testing.assert_array_equal(got.y, f0.y)


def _level(lvl, seed, wt=(3, 1)):
    """Planes and geometry of pyramid level `lvl` (0 or 1) of a 64x64
    pair, with a seeded guide and seeded MV grids."""
    from thor_tpu.spec.tempinterp import _downscale_luma
    rng = np.random.default_rng(seed)
    f0, f1 = _mk(JFrame, 64, 64, seed)
    if lvl:
        d0, d1 = (JFrame(32, 32, 420, 32, 8, 8) for _ in range(2))
        _downscale_luma(f0, d0)
        _downscale_luma(f1, d1)
        f0, f1 = d0, d1
    w = 64 >> lvl
    geo = dict(w=w, h=w, pad=f0.pad, bw=2 * ((w + 15) // 16),
               bh=2 * ((w + 15) // 16))
    grids = [rng.integers(-40, 41, (geo["bh"], geo["bw"], 2)).astype(
        np.int32) for _ in range(3)]
    return f0, f1, geo, grids, wt


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a.astype(np.int32)))


@pytest.mark.parametrize("lvl,wt", [(0, (1, 1)), (0, (3, 1)), (1, (1, 1)),
                                    (1, (5, 3))])
def test_me_bi_level(lvl, wt):
    """Level 0 is guided (2 refinement steps), level 1 is not (16)."""
    f0, f1, geo, (guide, _, _), (wt0, wt1) = _level(lvl, 40 + lvl, wt)
    y0, y1 = (f.y_full.astype(np.int32) for f in (f0, f1))
    want = JTI.me_bi_level(y0, y1, guide, np.int32(wt0), np.int32(wt1),
                           guided=lvl == 0, **geo)
    got = PTI.me_bi_level(_t(y0), _t(y1), _t(guide), wt0, wt1,
                          guided=lvl == 0, **geo)
    for g, w_, name in zip(got, want, ("mv1", "mv0", "bgmap")):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_), name)


@pytest.mark.parametrize("lvl,wt", [(0, (1, 1)), (0, (1, 3)), (1, (2, 1))])
def test_merge_level(lvl, wt):
    f0, f1, geo, (_, mv1, mv0), (wt0, wt1) = _level(lvl, 50 + lvl, wt)
    # neighbours that repeat, so that the duplicate filter has work
    mv1[::2] = mv1[1::2]
    y0, y1 = (f.y_full.astype(np.int32) for f in (f0, f1))
    want = JTI.merge_level(y0, y1, mv1, mv0, np.int32(wt0), np.int32(wt1),
                           **geo)
    got = PTI.merge_level(_t(y0), _t(y1), _t(mv1), _t(mv0), wt0, wt1, **geo)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


@pytest.mark.parametrize("wt,big", [((1, 1), False), ((3, 1), False),
                                    ((1, 1), True)])
def test_interp_exec(wt, big):
    """`big` vectors push windows out of range on one side or both (the
    one-sided copy and the clipped average)."""
    f0, f1, geo, (_, mv1, mv0), (wt0, wt1) = _level(0, 60, wt)
    if big:
        mv1 *= 12
        mv0 *= -9
    planes = [getattr(f, p).astype(np.int32)
              for p in ("y_full", "u_full", "v_full") for f in (f0, f1)]
    kw = dict(pad_c=f0.pad_c, mono=False, **geo)
    want = JTI.interp_exec(*planes, mv0, mv1, np.int32(wt0), np.int32(wt1),
                           **kw)
    got = PTI.interp_exec(*[_t(p) for p in planes], _t(mv0), _t(mv1), wt0,
                          wt1, **kw)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def test_upscale_mv1_keeps_the_flat_index():
    rng = np.random.default_rng(3)
    src = rng.integers(-50, 50, (4, 6, 2)).astype(np.int32)
    want = np.asarray(JTI._upscale_mv1(src, 10, 12, 6, 4))
    got = PTI._upscale_mv1(_t(src), 10, 12, 6, 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_interpolate_frames_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    f0, f1 = _mk(PFrame, 64, 64, 1)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        PTI.interpolate_frames(PFrame(64, 64, 420, PADDING_Y, 8, 8), f0, f1,
                               2, 1)
