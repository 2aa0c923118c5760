"""thor_tpu_torch's intra prediction, CFL and intra wave scan against
thor_tpu's, exactly (numpy-seeded inputs through both, on the CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thor_tpu.dec import device_frame as JDF
from thor_tpu.dec import native_parse as NP
from thor_tpu.ops import intra_batch as JIB
from thor_tpu_torch.dec import device_frame as PDF
from thor_tpu_torch.ops import intra_batch as PIB

torch.set_num_threads(1)


def _refs_inputs(rng, size, L, H, W, bd):
    plane = rng.integers(0, 1 << bd, (H + size + 1, W + size + 1)).astype(
        np.int32)
    cb_y = rng.integers(0, H - size + 1, L) // 4 * 4
    cb_x = rng.integers(0, W - size + 1, L) // 4 * 4
    cb_y[:2], cb_x[1:3] = 0, 0          # frame-edge rules
    ur, dl = rng.random(L) < 0.5, rng.random(L) < 0.5
    return plane, cb_y.astype(np.int32), cb_x.astype(np.int32), ur, dl


@pytest.mark.parametrize("size", [4, 8, 16, 32, 64, 128])
def test_make_refs_batch(size):
    rng = np.random.default_rng(size)
    plane, cy, cx, ur, dl = _refs_inputs(rng, size, 12, 160, 192, 8)
    want = JIB.make_refs_batch(jnp.asarray(plane), jnp.asarray(cy),
                               jnp.asarray(cx), size, jnp.asarray(ur),
                               jnp.asarray(dl), 8)
    got = PIB.make_refs_batch(torch.from_numpy(plane), torch.from_numpy(cy),
                              torch.from_numpy(cx), size,
                              torch.from_numpy(ur), torch.from_numpy(dl), 8)
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("size", [4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("bd", [8, 10])
def test_predict_all_modes(size, bd):
    """Every mode at every size, then the per-lane mode selection."""
    rng = np.random.default_rng(10 * size + bd)
    L = 9
    left = rng.integers(0, 1 << bd, (L, 2 * size)).astype(np.int32)
    top = rng.integers(0, 1 << bd, (L, 2 * size)).astype(np.int32)
    tl = rng.integers(0, 1 << bd, L).astype(np.int32)
    yp = (rng.integers(0, 3, L) * 8).astype(np.int32)
    xp = (rng.integers(0, 3, L) * 8).astype(np.int32)
    want = np.asarray(JIB.predict_all_modes(left, top, tl, yp, xp, size, bd,
                                            10))
    got = PIB.predict_all_modes(*map(torch.from_numpy, (left, top, tl, yp,
                                                         xp)), size, bd, 10)
    assert np.array_equal(got.numpy(), want)
    mode = rng.integers(-1, 11, L).astype(np.int32)
    sel = np.asarray(JIB.select_mode(jnp.asarray(want), jnp.asarray(mode)))
    assert np.array_equal(PIB.select_mode(got, torch.from_numpy(mode))
                          .numpy(), sel)


def _cfl_cases(rng, n, bd):
    """Blocks that hit each CFL branch: negative numerators (luma and
    chroma trending opposite ways), flat luma (ssyy == 0), skipped
    (prediction equals reconstruction) and random."""
    nc = n // 2
    hi = (1 << bd) - 1
    cases = []
    ramp = np.add.outer(np.arange(n), np.arange(n)) * hi // (2 * n - 2)
    ramp_c = np.add.outer(np.arange(nc), np.arange(nc)) * hi // (2 * nc - 2)
    shifted = np.clip(ramp + 40, 0, hi)        # residual large: no skip
    cases.append((ramp, hi - ramp_c, ramp_c, shifted))
    cases.append((np.full((n, n), 77), ramp_c, ramp_c,
                  np.full((n, n), 900).clip(0, hi)))
    cases.append((ramp, ramp_c, hi - ramp_c, ramp))
    cases.append((ramp, ramp_c, ramp_c, shifted))
    for _ in range(4):
        cases.append((rng.integers(0, hi + 1, (n, n)),
                      rng.integers(0, hi + 1, (nc, nc)),
                      rng.integers(0, hi + 1, (nc, nc)),
                      rng.integers(0, hi + 1, (n, n))))
    return [tuple(np.asarray(a, np.int32) for a in c) for c in cases]


@pytest.mark.parametrize("n", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("bd", [8, 10])
def test_cfl(n, bd):
    cases = _cfl_cases(np.random.default_rng(n + bd), n, bd)
    f = jax.jit(jax.vmap(lambda p, u, v, r: JDF._cfl_j(p, u, v, r, n, bd)))
    stack = [np.stack(a) for a in zip(*cases)]
    with jax.enable_x64():
        want_u, want_v = f(*stack)
    got_u, got_v = PDF._cfl_j(*[torch.from_numpy(a) for a in stack], n, bd)
    assert np.array_equal(got_u.numpy(), np.asarray(want_u))
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))
    # the crafted blocks reach the remap with a negative numerator and
    # the ssyy == 0 gate
    assert not np.array_equal(np.asarray(want_u)[0], stack[1][0])
    assert np.array_equal(np.asarray(want_u)[1], stack[1][1])


def _quadtree_recs(rng, H, W, sizes):
    """Intra block records tiling an H x W frame, in coding order."""
    recs = []

    def split(y, x, s):
        if s > sizes[0] and (s > sizes[-1] or rng.random() < 0.6):
            h = s // 2
            for dy, dx in ((0, 0), (0, h), (h, 0), (h, h)):
                split(y + dy, x + dx, h)
            return
        r = np.zeros(NP.BREC_W, np.int32)
        r[NP.B_YPOS], r[NP.B_XPOS], r[NP.B_SIZE] = y, x, s
        r[NP.B_MODE] = JDF.MODE_INTRA
        r[NP.B_INTRA_MODE] = rng.integers(0, 10)
        recs.append(r)

    for y in range(0, H, 64):
        for x in range(0, W, 64):
            split(y, x, 64)
    return np.stack(recs)


@pytest.mark.parametrize("cfl", [False, True])
def test_intra_waves(cfl):
    """The whole intra scan of one 64x128 frame whose inter cells are
    already reconstructed (random base planes)."""
    from thor_tpu.spec import inter
    rng = np.random.default_rng(60 + cfl)
    H, W, bd = 64, 128, 8
    sizes = (8, 16, 32, 64)
    recs = _quadtree_recs(rng, H, W, sizes)
    seg_list = JDF.build_wave_segments(recs, H, W, sizes)
    port_list = PDF.build_wave_segments(recs, H, W, sizes)
    assert len(port_list) == len(seg_list) and all(
        a[0] == b[0] and np.array_equal(a[1], b[1])
        for a, b in zip(seg_list, port_list))
    scap = JDF._bucket(len(seg_list))
    segs = np.zeros((scap, JDF.LANES, 7), np.int32)
    segcls = np.zeros(scap, np.int32)
    for si, (cls, idx) in enumerate(seg_list):
        segcls[si] = cls
        for li, ri in enumerate(idx):
            y, x, s = (int(recs[ri, k]) for k in (NP.B_YPOS, NP.B_XPOS,
                                                  NP.B_SIZE))
            segs[si, li] = (1, y, x, int(np.log2(s)),
                            recs[ri, NP.B_INTRA_MODE],
                            inter.get_upright_available(y, x, s, s, W, H, 64),
                            inter.get_downleft_available(y, x, s, s, W, H,
                                                         64))
    AP = JDF.AP
    planes = [rng.integers(0, 256, (h + AP, w + AP)).astype(np.int32)
              for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    res = [rng.integers(-60, 60, (h, w)).astype(np.int32)
           for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    with jax.enable_x64():
        want = JDF._intra_waves(*map(jnp.asarray, planes), jnp.asarray(segs),
                                jnp.asarray(segcls), *map(jnp.asarray, res),
                                bd, cfl, sizes)
    got = PDF._intra_waves(*[torch.from_numpy(p.copy()) for p in planes],
                           segs, segcls, *map(torch.from_numpy, res), bd,
                           cfl, sizes)
    for w, g in zip(want, got):
        assert np.array_equal(g.numpy(), np.asarray(w))
