"""thor_tpu_torch's loop filters and copied host helpers against
thor_tpu's, exactly (numpy-seeded inputs through both, on the CPU)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thor_tpu.dec import device_frame as JDF
from thor_tpu.dec import device_pixels as JDP
from thor_tpu.ops import filters as JOF
from thor_tpu.spec import inter
from thor_tpu.tables import CHROMA_QP
from thor_tpu_torch import decode_stream
from thor_tpu_torch.dec import device_frame as PDF
from thor_tpu_torch.dec import device_pixels as PDP
from thor_tpu_torch.ops import filters as POF

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _random_dd(rng, W, H, modes=(0, 0, 1, 2, 4)):
    dd = inter.DeblockData(W, H)
    n = dd.size.shape[0]
    dd.size[:] = rng.choice([8, 16, 32, 64], n)
    dd.tb_split[:] = rng.integers(0, 2, n)
    dd.pb_part[:] = rng.integers(0, 4, n)
    dd.cbp_y[:] = rng.integers(0, 2, n)
    dd.mode[:] = rng.choice(list(modes), n)
    dd.mv0[:] = rng.integers(-8, 9, (n, 2))
    dd.mv1[:] = rng.integers(-8, 9, (n, 2))
    return dd


def _eq(got, want):
    return np.array_equal(got.numpy(), np.asarray(want))


T = torch.from_numpy


@pytest.mark.parametrize("bd", [8, 10])
def test_deblock_planes(bd):
    rng = np.random.default_rng(3 + bd)
    W, H = 128, 96
    dd = _random_dd(rng, W, H)
    qp = int(rng.integers(20, 52))
    y = rng.integers(0, 1 << bd, (H, W)).astype(np.int32)
    mv, mh = JOF.deblock_masks_y(dd, W, H)
    assert _eq(POF.deblock_plane_y(T(y), T(mv), T(mh), qp, bd),
               JOF.deblock_plane_y(y, mv, mh, qp, bd))
    qpc = int(CHROMA_QP[qp])
    mvc, mhc = JOF.deblock_masks_uv(dd, W, H)
    u = rng.integers(0, 1 << bd, (H // 2, W // 2)).astype(np.int32)
    assert _eq(POF.deblock_plane_uv(T(u), T(mvc), T(mhc), qpc, 1, bd),
               JOF.deblock_plane_uv(u, mvc, mhc, qpc, 1, bd))


@pytest.mark.parametrize("strength,damping", [(1, 4), (2, 5), (4, 3),
                                              (8, 6)])
def test_clpf_plane(strength, damping):
    rng = np.random.default_rng(strength * 10 + damping)
    x = rng.integers(0, 1 << 10, (40, 56)).astype(np.int32)
    mask = rng.random((40, 56)) < 0.7
    assert _eq(POF.clpf_plane(T(x), T(mask), strength, damping),
               JOF.clpf_plane(x, mask, strength, damping))


def test_log2i_matches_clz():
    v = np.array([0, 1, 2, 3, 7, 8, 255, 256, (1 << 23) - 1, 1 << 23,
                  (1 << 24) + 1, (1 << 31) - 1, -1, -(1 << 31)], np.int32)
    assert _eq(POF._log2i_j(T(v)), JOF._log2i_j(jnp.asarray(v)))


@pytest.mark.parametrize("coeff_shift", [0, 2])
def test_cdef_dirs_with_ties(coeff_shift):
    """Random 8x8 blocks plus blocks whose direction costs tie: flat
    blocks (all costs 0), symmetric patterns, and transposes, where the
    first maximum must win."""
    rng = np.random.default_rng(70 + coeff_shift)
    hi = (1 << (8 + coeff_shift)) - 1
    blocks = [rng.integers(0, hi + 1, (8, 8)) for _ in range(20)]
    blocks += [np.full((8, 8), v) for v in (0, 128 << coeff_shift, hi)]
    i, j = np.mgrid[0:8, 0:8]
    stripes = ((i + j) % 2) * (64 << coeff_shift)
    blocks += [stripes, stripes.T, ((i // 4 + j // 4) % 2) * hi,
               (i == j) * hi, (i + j == 7) * hi, np.maximum(i, j) * 9]
    src = np.concatenate([np.concatenate(blocks[k:k + 4], 1)
                          for k in range(0, 28, 4)], 0).astype(np.int32)
    want_d, want_v = JOF.cdef_dirs(src, coeff_shift)
    got_d, got_v = POF.cdef_dirs(T(src), coeff_shift)
    assert _eq(got_d, want_d) and _eq(got_v, want_v)


@pytest.mark.parametrize("bd", [8, 10])
def test_cdef_plane(bd):
    rng = np.random.default_rng(11 + bd)
    W, H, cs = 128, 96, bd - 8
    dd = _random_dd(rng, W, H)
    nfb = ((H + 63) // 64) * ((W + 63) // 64)
    presets = [{"level": int(rng.integers(0, 16)),
                "sec_strength": int(rng.integers(0, 4))} for _ in range(nfb)]
    dmp = int(rng.integers(4, 7))
    y = rng.integers(0, 1 << bd, (H, W)).astype(np.int32)
    u = rng.integers(0, 1 << bd, (H // 2, W // 2)).astype(np.int32)
    dirs, var = JOF.cdef_dirs(y, cs)
    lv0, sec0, m0 = JOF.cdef_block_maps(dd, presets, W, H, 0, 1)
    lv1, sec1, m1 = JOF.cdef_block_maps(dd, presets, W, H, 1, 1)
    tdirs, tvar = T(np.array(dirs)), T(np.array(var))
    assert _eq(POF.cdef_plane(T(y), tdirs, tvar, T(lv0), T(sec0), T(m0), 8,
                              0, dmp, dmp, cs),
               JOF.cdef_plane(y, dirs, var, lv0, sec0, m0, 8, 0, dmp, dmp,
                              cs))
    assert _eq(POF.cdef_plane(T(u), tdirs, tvar, T(lv1), T(sec1), T(m1), 4,
                              1, dmp - 1, dmp - 1, cs),
               JOF.cdef_plane(u, dirs, var, lv1, sec1, m1, 4, 1, dmp - 1,
                              dmp - 1, cs))


def test_edge_pad():
    x = np.arange(35, dtype=np.int16).reshape(5, 7)
    assert np.array_equal(POF.edge_pad(T(x), 3).numpy(),
                          np.pad(x, 3, mode="edge"))


def _same(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def test_copied_host_helpers_on_tiny64(monkeypatch):
    """Each numpy helper the port copies out of a JAX module gives what
    the original gives, on every frame of tiny64_ldblc: the port's decode
    calls the copies, and a spy calls the originals on the same inputs."""
    calls = {}

    def spy(module, name, original):
        copy = getattr(module, name)

        def both(*args, **kwargs):
            got = copy(*args, **kwargs)
            assert _same(got, original(*args, **kwargs)), name
            calls[name] = calls.get(name, 0) + 1
            return got
        monkeypatch.setattr(module, name, both)

    for name in ("deblock_masks_y", "deblock_masks_uv", "clpf_pixel_mask",
                 "cdef_block_maps"):
        spy(POF, name, getattr(JOF, name))
    spy(PDF, "build_wave_segments", JDF.build_wave_segments)
    with open(os.path.join(GOLDEN, "tiny64_ldblc.bit"), "rb") as f:
        _, frames = decode_stream(f.read(), device="cpu")
    assert len(frames) == 6
    assert calls["build_wave_segments"] == 6
    assert calls["cdef_block_maps"] == 18
    assert calls["deblock_masks_y"] == 6 and calls["clpf_pixel_mask"] > 0


def test_copied_plan_helpers():
    """FramePlan, the MC planning helpers and the segment buckets."""
    rng = np.random.default_rng(80)
    W, H = 64, 48
    jp, pp = JDP.FramePlan(W, H), PDP.FramePlan(W, H)
    for _ in range(40):
        args = [int(a) for a in rng.integers(-700, 700, 2)] + [
            int(rng.integers(0, H - 8)) // 4 * 4,
            int(rng.integers(0, W - 8)) // 4 * 4]
        bw, bh, sign = 8, 8, int(rng.integers(0, 2))
        cm = JDP._clip_mv(*args, W, H, bw, bh, sign)
        assert PDP._clip_mv(*args, W, H, bw, bh, sign) == cm
        bip = int(rng.integers(0, 3))
        pl = JDP._plan_luma(*cm, *args[2:], bw, bh, sign, bip, W, H,
                            *args[2:])
        assert PDP._plan_luma(*cm, *args[2:], bw, bh, sign, bip, W, H,
                              *args[2:]) == pl
        pc = JDP._plan_chroma(*cm, args[2] >> 1, args[3] >> 1, 4, 4, sign,
                              W >> 1, H >> 1, args[2] >> 1, args[3] >> 1)
        assert PDP._plan_chroma(*cm, args[2] >> 1, args[3] >> 1, 4, 4, sign,
                                W >> 1, H >> 1, args[2] >> 1,
                                args[3] >> 1) == pc
        for plan in (jp, pp):
            plan.fill_luma(0, args[2], args[3], bw, bh, pl)
            plan.fill_chroma(1, args[2], args[3], bw, bh, pc)
            plan.add_tb("y", 8, args[2], args[3], 30,
                        np.full((8, 8), 3, np.int16))
    for attr in ("ly", "ch", "coef", "qp4", "ls4"):
        a, b = getattr(jp, attr), getattr(pp, attr)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    for attr in ("avg", "inter"):
        assert np.array_equal(getattr(jp, attr), getattr(pp, attr))
    assert [PDF._bucket(n) for n in (1, 8, 9, 2048)] == \
        [JDF._bucket(n) for n in (1, 8, 9, 2048)]
    assert (PDF.LY_KEYS, PDF.CH_KEYS, PDF.INTRA_SIZES) == \
        (JDF.LY_KEYS, JDF.CH_KEYS, JDF.INTRA_SIZES)
