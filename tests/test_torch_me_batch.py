"""thor_tpu_torch's lockstep motion search (ops/me_batch.py), its
candidate tables (ops/enc_cand.py) and the plain block kernels of
ops/enc_kernels.py against thor_tpu's, exactly (tolerance 0: integer
outputs, float64 costs rounded once).

Inputs come from numpy seeds and go through the JAX function and its
torch port on the CPU.  Live against thor_tpu: `sad_batch`, `ssd_batch`
(10-bit inputs), `avg_batch` (negative inputs), `scale_down2x2`, the
five enc_cand functions (block sizes 8-64, superblocks of 64 and 128,
positions on every frame edge and superblock corner, random dd grids
with repeated values, so that the dedup drops candidates),
`clip_mv_batch` at the +-MAX_MV_EXT bound, and `motion_estimate_batch`
at (16, 0) and (32, 0) as tests/test_me_batch.py runs them, with flat
blocks (every candidate ties), blocks at the four frame corners with
candidates past the clip bound, and those corners again at a pad of 144,
where lax.dynamic_slice clamps the search windows.

thor_tpu's compiles of the telescope, speed0, bi-prediction and sync
searches take minutes on the CPU, so those cases (`STORED`) compare
with thor_tpu's outputs kept in tests/torch_me_batch/ref.npz, which
`python tests/test_torch_me_batch.py` writes (thor_tpu's searches run op
by op, as their un-jitted Python bodies).  The `slow`
`test_stored_outputs_are_thor_tpus` recomputes them so, holds them
equal to the file, and holds five of them to the jitted searches too.
The STORED cases at the encoder's pad of 160 are also held, block by
block, to the port's host search (enc/me.py: motion_estimate,
motion_estimate_bi, motion_estimate_sync; tests/test_torch_host.py
holds it byte-equal to thor_tpu's).  `python
tests/test_torch_me_batch.py me1080` prints thor_tpu's hashes of
chip_smoke.py's phase 12 (ME1080_SHA256), which the `slow`
`test_me1080_hashes_are_thor_tpus` recomputes.
"""
import os
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from thor_tpu.ops import enc_cand as RC
from thor_tpu.ops import enc_kernels as RK
from thor_tpu.ops import me_batch as RM
from thor_tpu_torch.enc import me as HM
from thor_tpu_torch.frame import YuvFrame
from thor_tpu_torch.ops import enc_cand as PC
from thor_tpu_torch.ops import enc_kernels as PK
from thor_tpu_torch.ops import mc as PMC
from thor_tpu_torch.ops import me_batch as PM

torch.set_num_threads(1)
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_me_batch", "ref.npz")


def T(a):
    return torch.from_numpy(np.array(a))


def eq(got, want):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            eq(g, w)
        return
    w = np.asarray(want)
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert g.shape == w.shape
    np.testing.assert_array_equal(g, w)


# ------------------------------------------------------ block kernels

def _kernel_case(kind):
    rng = np.random.default_rng(len(kind))
    if kind == "scale_down2x2":
        return (rng.integers(0, 256, (96, 128)).astype(np.int32),)
    bd = 10 if kind == "ssd10" else 8
    lo = -(1 << bd) if kind == "avg" else 0
    return tuple(rng.integers(lo, 1 << bd, (40, 16, 16)).astype(np.int32)
                 for _ in range(2))


@pytest.mark.parametrize("kind", ["sad", "ssd8", "ssd10", "avg",
                                  "scale_down2x2"])
def test_block_kernels(kind):
    fn = {"sad": "sad_batch", "ssd8": "ssd_batch", "ssd10": "ssd_batch",
          "avg": "avg_batch"}.get(kind, kind)
    args = _kernel_case(kind)
    want = getattr(RK, fn)(*args)
    got = getattr(PK, fn)(*map(T, args))
    eq(got, want)
    assert got.dtype == getattr(torch, str(np.asarray(want).dtype))


# ------------------------------------------------------ candidate tables

W_CAND, H_CAND = 200, 136      # neither a multiple of 64: edge SBs


def _positions(size):
    """Every block of `size` in the frame: positions on every frame edge
    and superblock corner."""
    ys, xs = np.meshgrid(np.arange(0, H_CAND, size),
                         np.arange(0, W_CAND, size), indexing="ij")
    return ys.ravel().astype(np.int32), xs.ravel().astype(np.int32)


def _grids(seed, lo, hi, n=1):
    rng = np.random.default_rng(seed)
    shape = (-(-H_CAND // 4), -(-W_CAND // 4))
    return [rng.integers(lo, hi, shape).astype(np.int32) for _ in range(n)]


CAND_CASES = [(s, sb) for sb in (64, 128) for s in (8, 16, 32, 64)]


@pytest.mark.parametrize("size,sb_size", CAND_CASES)
def test_availability(size, sb_size):
    ys, xs = _positions(size)
    for fn in ("upright_available", "downleft_available"):
        eq(getattr(PC, fn)(T(ys), T(xs), size, W_CAND, H_CAND, sb_size),
           getattr(RC, fn)(jnp.asarray(ys), jnp.asarray(xs), size, W_CAND,
                           H_CAND, sb_size))


@pytest.mark.parametrize("size,sb_size", CAND_CASES)
def test_mv_pred_and_two_candidates(size, sb_size):
    ys, xs = _positions(size)
    mv0y, mv0x = _grids(size + sb_size, -40, 41, 2)
    eq(PC.mv_pred_batch(T(ys), T(xs), size, W_CAND, H_CAND, sb_size,
                        T(mv0y), T(mv0x)),
       RC.mv_pred_batch(jnp.asarray(ys), jnp.asarray(xs), size, W_CAND,
                        H_CAND, sb_size, jnp.asarray(mv0y),
                        jnp.asarray(mv0x)))
    # few distinct values, so that neighbours repeat and the dedup drops
    # the second candidate of some blocks
    g = _grids(7 * size + sb_size, -1, 2, 7)
    dd = dict(zip(PC.DD_FIELDS, g))
    cand, n = PC.two_candidates_batch(T(ys), T(xs), size, W_CAND, H_CAND,
                                      sb_size, {k: T(v) for k, v in
                                                dd.items()})
    eq((cand, n), RC.two_candidates_batch(
        jnp.asarray(ys), jnp.asarray(xs), size, W_CAND, H_CAND, sb_size,
        {k: jnp.asarray(v) for k, v in dd.items()}))
    assert (n == 1).any() and (n == 2).any()


@pytest.mark.parametrize("size,enable", [(8, 1), (16, 1), (64, 1),
                                         (128, 1), (16, 0)])
def test_block_contexts(size, enable):
    W, H = 328, 200          # room for a 128 block off every edge
    ys, xs = np.meshgrid(np.arange(0, H, 8), np.arange(0, W, 8),
                         indexing="ij")
    ys, xs = ys.ravel().astype(np.int32), xs.ravel().astype(np.int32)
    rng = np.random.default_rng(size + enable)
    sz, *cbp = (rng.integers(lo, hi, (H // 4, W // 4)).astype(np.int32)
                for lo, hi in ((4, 129), (0, 2), (0, 2), (0, 2)))
    got = PC.block_contexts_batch(T(ys), T(xs), size, W, H, enable, T(sz),
                                  *map(T, cbp))
    eq(got, RC.block_contexts_batch(
        jnp.asarray(ys), jnp.asarray(xs), size, W, H, enable,
        jnp.asarray(sz), *map(jnp.asarray, cbp)))
    assert (got[0] >= 0).any() == bool(enable)


@pytest.mark.parametrize("sign", [0, 1])
def test_clip_mv_at_the_bound(sign):
    W, H, size = 128, 96, 16
    ext = PM.MAX_MV_EXT
    ys = np.repeat(np.array([0, 0, H - size, H - size], np.int32), 9)
    xs = np.repeat(np.array([0, W - size, 0, W - size], np.int32), 9)
    d = np.tile(np.array([-7, -4, -1, 0, 1, 3, 4, 8, 400], np.int32), 4)
    mvy = np.where(ys == 0, -4 * ext - 4 * ys, 4 * (H + ext - ys - size))
    mvx = np.where(xs == 0, -4 * ext - 4 * xs, 4 * (W + ext - xs - size))
    mvy, mvx = (mvy + np.sign(mvy) * d).astype(np.int32), \
        (mvx + np.sign(mvx) * d[::-1]).astype(np.int32)
    if sign:
        mvy, mvx = -mvy, -mvx
    eq(PM.clip_mv_batch(T(mvy), T(mvx), T(ys), T(xs), W, H, size, size,
                        sign),
       RM.clip_mv_batch(jnp.asarray(mvy), jnp.asarray(mvx),
                        jnp.asarray(ys), jnp.asarray(xs), W, H, size,
                        size, sign))


# ------------------------------------------------------ the searches

def _frame(rng, W, H, pad, flat=False):
    fr = YuvFrame(W, H, 420, pad, 8, 8)
    fr.y[:] = 100 if flat else rng.integers(0, 256, (H, W))
    fr.pad_frame()
    return fr


def _blocks(rng, kind, N, W, H, size):
    """(ys, xs, orgs) of one scene: random positions and blocks, flat
    blocks, or blocks at the four frame corners."""
    if kind == "corners":
        ys = np.resize([0, 0, H - size, H - size], N)
        xs = np.resize([0, W - size, 0, W - size], N)
    else:
        ys = rng.integers(0, (H - size) // 8, N) * 8
        xs = rng.integers(0, (W - size) // 8, N) * 8
    orgs = rng.integers(0, 256, (N, size, size)).astype(np.int32)
    if kind == "flat":
        orgs[:] = 100
    return ys.astype(np.int32), xs.astype(np.int32), orgs


def _far(rng, kind, shape, lim):
    """Full-pel candidates: within +-lim, or, at the corners, past the
    clip bound (clip_mv_batch brings them back to it)."""
    c = rng.integers(-lim, lim + 1, shape)
    if kind == "corners":
        c = np.sign(c + 0.5).astype(np.int64) * rng.integers(150, 260, shape)
    return c


def _lams(rng, kind, N, hi):
    lams = rng.uniform(1.0, hi, N)
    if kind == "flat":          # every cost ties on half of the blocks
        lams[::2] = 0.0
    return lams


def me_case(kind="random", size=16, sign=0, pad=160, telescope=False,
            widesad32=False, speed0=False):
    """motion_estimate_batch's inputs as tests/test_me_batch.py makes them
    (the same seeds and draws for kind "random"); returns (args, kw,
    frame, host parameters)."""
    if telescope and not speed0:       # test_motion_estimate_batch_telescope
        rng = np.random.default_rng(31 + widesad32)
        W, H, N, maxc, mvc, lo, hi = 192, 128, 16, 2, (6, -10), 20, 8.0
    elif speed0:                       # test_motion_estimate_batch_speed0
        rng = np.random.default_rng(23 + size + sign)
        W, H, N, maxc, mvc, lo, hi = 128, 96, 8, 3, (3, -5), 12, 6.0
    else:                              # test_motion_estimate_batch
        rng = np.random.default_rng(7 + size + sign)
        W, H, N, maxc, mvc, lo, hi = 128, 96, 24, 4, (0, 0), 20, 8.0
    if kind == "corners":
        mvc = (-4 * 200, 4 * 200)
    fr = _frame(rng, W, H, pad, kind == "flat")
    ys, xs, orgs = _blocks(rng, kind, N, W, H, size)
    mvps = rng.integers(-lo, lo + 1, (N, 2))
    lams = _lams(rng, kind, N, hi)
    cn = rng.integers(0 if speed0 else 1, maxc + 1, N)
    lim = 10 if speed0 else 12
    cy = _far(rng, kind, (N, maxc), lim)
    cx = _far(rng, kind, (N, maxc), lim)
    i32 = np.int32
    args = (orgs, fr.y_full.astype(i32), pad, ys, xs, mvps[:, 0].astype(i32),
            mvps[:, 1].astype(i32), lams, cy.astype(i32), cx.astype(i32),
            cn.astype(i32))
    kw = dict(width=size, height=size, size=size, sign=sign, fwidth=W,
              fheight=H, bitdepth=8, maxcand=maxc)
    speed = 0 if speed0 else (1 if widesad32 or not telescope else 2)
    if telescope or speed0:
        kw.update(telescope=True, widesad32=widesad32, mvc_y=mvc[0],
                  mvc_x=mvc[1])
    if speed0:
        kw.update(speed0=True, bipred=0)
    host = dict(frames=(fr,), mvc=mvc, speed=speed,
                bipred=int(telescope and not speed0))
    return args, kw, host


def bi_case(kind="random", sign=0, bip=1, pad=160):
    """test_motion_estimate_bi_batch's inputs (the same draws)."""
    rng = np.random.default_rng(13 + sign + bip)
    W, H, size, N, maxc = 128, 96, 16, 10, 4
    mvc = (-4 * 200, 4 * 200) if kind == "corners" else (5, -7)
    r0 = _frame(rng, W, H, pad, kind == "flat")
    r1 = _frame(rng, W, H, pad, kind == "flat")
    ys, xs, orgs = _blocks(rng, kind, N, W, H, size)
    mvps = rng.integers(-12, 13, (N, 2))
    lams = _lams(rng, kind, N, 6.0)
    cn = rng.integers(0, maxc + 1, N)
    cy = _far(rng, kind, (N, maxc), 10)
    cx = _far(rng, kind, (N, maxc), 10)
    i32 = np.int32
    args = (orgs, r0.y_full.astype(i32), r1.y_full.astype(i32), pad, ys, xs,
            mvps[:, 0].astype(i32), mvps[:, 1].astype(i32), lams,
            cy.astype(i32), cx.astype(i32), cn.astype(i32))
    kw = dict(width=size, height=size, size=size, sign=sign, fwidth=W,
              fheight=H, bitdepth=8, bipred=bip, mvc_y=mvc[0], mvc_x=mvc[1])
    return args, kw, dict(frames=(r0, r1), mvc=mvc, speed=1, bipred=bip)


def sync_case(kind="random", sign=0, bip=0, pad=160, sub=False):
    """test_motion_estimate_sync_batch's inputs (the same draws); `sub`:
    8x8 sub-PUs at offsets 0 and 8 of their 16x16 parents."""
    rng = np.random.default_rng(17 + sign)
    W, H, size, N = 128, 96, 16, 10
    mvc = (-4 * 200, 4 * 200) if kind == "corners" else (5, -7)
    fr = _frame(rng, W, H, pad, kind == "flat")
    ys, xs, orgs = _blocks(rng, kind, N, W, H, size)
    mvps = rng.integers(-12, 13, (N, 2))
    lams = _lams(rng, kind, N, 6.0)
    cands = np.stack([_far(rng, kind, (N, 6), 10),
                      _far(rng, kind, (N, 6), 10)], axis=2)
    cy = cands[:, :, 0].copy()
    cx = cands[:, :, 1].copy()
    cy[:, 4] = mvps[:, 0]
    cx[:, 4] = mvps[:, 1]
    cy[:, 5] = 0
    cx[:, 5] = 0
    boy = box = np.zeros(N, np.int32)
    bw = size
    if sub:
        boy = rng.integers(0, 2, N).astype(np.int32) * 8
        box = rng.integers(0, 2, N).astype(np.int32) * 8
        orgs = orgs[:, :8, :8].copy()
        bw = 8
    i32 = np.int32
    args = (orgs, fr.y_full.astype(i32), pad, ys, xs, boy, box,
            mvps[:, 0].astype(i32), mvps[:, 1].astype(i32), lams,
            cy.astype(i32), cx.astype(i32))
    kw = dict(width=bw, height=bw, size=size, sign=sign, fwidth=W,
              fheight=H, bitdepth=8, bipred=bip, mvc_y=mvc[0], mvc_x=mvc[1])
    return args, kw, dict(frames=(fr,), mvc=mvc, speed=1, bipred=bip)


# name: (search, inputs); the slow cases of tests/test_me_batch.py, the
# same searches on flat blocks and at the frame corners, sync on 8x8
# sub-PUs, and the corners at a pad of 144 (host search not comparable:
# its windows leave the plane)
STORED = {
    "telescope-widesad32": ("me", lambda: me_case(telescope=True,
                                                  widesad32=True)),
    "telescope": ("me", lambda: me_case(telescope=True)),
    "speed0-16-0": ("me", lambda: me_case(size=16, sign=0, speed0=True)),
    "speed0-8-1": ("me", lambda: me_case(size=8, sign=1, speed0=True)),
    "speed0-32-0": ("me", lambda: me_case(size=32, sign=0, speed0=True)),
    "speed0-flat": ("me", lambda: me_case("flat", speed0=True)),
    "speed0-corners": ("me", lambda: me_case("corners", speed0=True)),
    "bi-0-1": ("bi", lambda: bi_case(sign=0, bip=1)),
    "bi-1-1": ("bi", lambda: bi_case(sign=1, bip=1)),
    "bi-0-2": ("bi", lambda: bi_case(sign=0, bip=2)),
    "bi-flat": ("bi", lambda: bi_case("flat")),
    "bi-corners": ("bi", lambda: bi_case("corners", sign=1)),
    "sync-0-0": ("sync", lambda: sync_case(sign=0, bip=0)),
    "sync-1-1": ("sync", lambda: sync_case(sign=1, bip=1)),
    "sync-flat": ("sync", lambda: sync_case("flat")),
    "sync-corners": ("sync", lambda: sync_case("corners", sign=1)),
    "sync-subpu": ("sync", lambda: sync_case(sub=True)),
    "speed0-corners-pad144": ("me", lambda: me_case("corners", speed0=True,
                                                    pad=144)),
    "bi-corners-pad144": ("bi", lambda: bi_case("corners", pad=144)),
    "sync-corners-pad144": ("sync", lambda: sync_case("corners", pad=144)),
}
SEARCH = {"me": "motion_estimate_batch", "bi": "motion_estimate_bi_batch",
          "sync": "motion_estimate_sync_batch"}


def port(kind, args, kw):
    return getattr(PM, SEARCH[kind])(*args, **kw, device="cpu")


def thor_tpu(kind, args, kw, jit=True):
    """thor_tpu's search; jit=False runs its Python body op by op (the
    XLA compile of a whole exact search takes tens of minutes on the CPU;
    op by op, each operation is compiled alone, in seconds in all)."""
    fn = getattr(RM, SEARCH[kind])
    return tuple(np.asarray(a) for a in (fn if jit else fn.__wrapped__)(
        *args, **kw))


def host(kind, args, kw, h):
    """The port's host search, block by block, as tests/test_me_batch.py
    runs thor_tpu's."""
    params = types.SimpleNamespace(encoder_speed=h["speed"])
    out = []
    if kind == "bi":
        orgs, _, _, _, ys, xs, mvpy, mvpx, lams, cy, cx, cn = args
    elif kind == "sync":
        orgs, _, _, ys, xs, boy, box, mvpy, mvpx, lams, cy, cx = args
    else:
        orgs, _, _, ys, xs, mvpy, mvpx, lams, cy, cx, cn = args
    for i in range(orgs.shape[0]):
        pos = (int(ys[i]), int(xs[i]), kw["size"], kw["width"],
               kw["height"], h["mvc"], (int(mvpy[i]), int(mvpx[i])),
               float(lams[i]), params, kw["sign"], kw["fwidth"],
               kw["fheight"])
        cands = [(int(cy[i, j]), int(cx[i, j])) for j in range(cy.shape[1])]
        if kind == "bi":
            r = HM.motion_estimate_bi(orgs[i], *h["frames"], *pos,
                                      cands + [(0, 0)] * 2, [int(cn[i])],
                                      h["bipred"], 8)
        elif kind == "sync":
            r = HM.motion_estimate_sync(orgs[i], *h["frames"], *pos, cands,
                                        [4], h["bipred"], 8,
                                        (int(boy[i]), int(box[i])))
        else:
            r = HM.motion_estimate(orgs[i], *h["frames"], *pos, cands,
                                   [int(cn[i])], h["bipred"], 8)
        out.append((r[0], r[1][0], r[1][1]))
    return tuple(np.array(c) for c in zip(*out))


@pytest.mark.parametrize("case", [("random", 16, 0), ("random", 32, 0),
                                  ("flat", 16, 0), ("corners", 16, 0),
                                  ("corners-pad144", 32, 0)],
                         ids=lambda c: "-".join(map(str, c)))
def test_motion_estimate_batch(case):
    kind, size, sign = case
    pad = 144 if kind.endswith("pad144") else 160
    args, kw, _ = me_case(kind.split("-")[0], size, sign, pad)
    got = port("me", args, kw)
    eq(got, thor_tpu("me", args, kw))
    if kind == "flat":        # lambda 0: the first candidate, cost 0
        assert (got[0][::2] == 0).all()


@pytest.fixture(scope="module")
def stored():
    return np.load(FIXTURE)


@pytest.mark.parametrize("name", list(STORED))
def test_stored_searches(name, stored):
    kind, make = STORED[name]
    args, kw, h = make()
    before = PMC.LUMA_LAUNCHES
    got = port(kind, args, kw)
    assert PMC.LUMA_LAUNCHES == before       # the CPU runs the plain MC
    eq(got, tuple(stored[f"{name}/{k}"] for k in ("sad", "mv_y", "mv_x")))
    if not name.endswith("pad144"):
        eq(got, host(kind, args, kw, h))


@pytest.mark.parametrize("fn", [
    "sad_batch", "ssd_batch", "avg_batch", "scale_down2x2",
    "upright_available", "downleft_available", "mv_pred_batch",
    "two_candidates_batch", "block_contexts_batch",
    "motion_estimate_batch", "motion_estimate_bi_batch",
    "motion_estimate_sync_batch"])
def test_numpy_inputs_mean_the_card(fn, monkeypatch):
    """Given numpy arrays and no device=, each function means CUDA and
    raises where torch sees no card; device="cpu" runs it here."""
    a = np.zeros((2, 8, 8), np.int32)
    p = np.zeros(2, np.int32)
    g = np.zeros((4, 4), np.int32)
    calls = {
        "sad_batch": lambda **d: PK.sad_batch(a, a, **d),
        "ssd_batch": lambda **d: PK.ssd_batch(a, a, **d),
        "avg_batch": lambda **d: PK.avg_batch(a, a, **d),
        "scale_down2x2": lambda **d: PK.scale_down2x2(a[0], **d),
        "upright_available": lambda **d: PC.upright_available(
            p, p, 8, 16, 16, 64, **d),
        "downleft_available": lambda **d: PC.downleft_available(
            p, p, 8, 16, 16, 64, **d),
        "mv_pred_batch": lambda **d: PC.mv_pred_batch(
            p, p, 8, 16, 16, 64, g, g, **d),
        "two_candidates_batch": lambda **d: PC.two_candidates_batch(
            p, p, 8, 16, 16, 64, dict.fromkeys(PC.DD_FIELDS, g), **d),
        "block_contexts_batch": lambda **d: PC.block_contexts_batch(
            p, p, 8, 16, 16, 1, g, g, g, g, **d),
    }
    if fn.startswith("motion"):
        kind = {"motion_estimate_batch": "me",
                "motion_estimate_bi_batch": "bi"}.get(fn, "sync")
        args, kw, _ = STORED[{"me": "speed0-8-1", "bi": "bi-0-1",
                              "sync": "sync-0-0"}[kind]][1]()
        calls[fn] = lambda **d: getattr(PM, fn)(*args, **kw, **d)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[fn]()
    out = calls[fn](device="cpu")
    assert all(t.device.type == "cpu" for t in
               (out if isinstance(out, tuple) else (out,)))


def test_tensors_on_two_devices_raise():
    a = torch.zeros((2, 8, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        PK.sad_batch(a, a.to("meta"))


# STORED cases whose jitted thor_tpu search compiles in under a minute
JITTED = ("bi-0-1", "bi-1-1", "bi-0-2", "sync-0-0", "sync-1-1")


@pytest.mark.slow
def test_stored_outputs_are_thor_tpus(stored):
    """Recomputes STORED with thor_tpu op by op and holds it equal to
    tests/torch_me_batch/ref.npz, then the JITTED cases through thor_tpu's
    jitted searches (minutes of XLA compile)."""
    for name, want in reference().items():
        np.testing.assert_array_equal(stored[name], want, err_msg=name)
    for name in JITTED:
        kind, make = STORED[name]
        args, kw, _ = make()
        eq(thor_tpu(kind, args, kw),
           tuple(stored[f"{name}/{k}"] for k in ("sad", "mv_y", "mv_x")))


def reference():
    out = {}
    for name, (kind, make) in STORED.items():
        args, kw, _ = make()
        for k, v in zip(("sad", "mv_y", "mv_x"),
                        thor_tpu(kind, args, kw, jit=False)):
            out[f"{name}/{k}"] = v
    return out


def me1080_digests():
    """thor_tpu's outputs on chip_smoke.py's phase 12 inputs (the bench
    stream's first three frames decoded by the port on the CPU), hashed
    as the smoke hashes them."""
    import chip_smoke as CS
    inputs = CS.me1080_inputs(CS.bench_frames(3, "cpu"))
    return {name: CS.me_digest(*(np.asarray(a) for a in getattr(
        RM, fn).__wrapped__(*args, **kw)))
        for name, (fn, args, kw) in inputs.items()}


@pytest.mark.slow
def test_me1080_hashes_are_thor_tpus():
    """chip_smoke.ME1080_SHA256 are thor_tpu's (minutes on the CPU)."""
    import chip_smoke as CS
    assert me1080_digests() == CS.ME1080_SHA256


if __name__ == "__main__":
    import sys
    if sys.argv[1:] == ["me1080"]:
        print(me1080_digests())
    else:
        os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
        np.savez_compressed(FIXTURE, **reference())
        print(f"wrote {FIXTURE}")
