"""The turbo encoder's device functions in thor_tpu_torch against
thor_tpu's, exactly.

Inputs come from numpy seeds and go through the JAX function and its
torch port on the CPU; the encoder is integer arithmetic with float32
costs built in one order, so the comparison is exact (tolerance 0).
Geometries are small (64x128 decision frames, one or two block sizes per
function).  Besides random content, the cases hold flat content, where
every candidate ties (the first minimum must win, as in JAX), and a
10-bit 128x128 worst case whose SSDs pass 2^31 (thor_tpu runs JAX with
64-bit types, where the sum of int32 values is int64: nothing wraps, and
the port's sums must not wrap either).

The transform, quantizer, MV-bit, scale2 and CDEF-sum cases run thor_tpu
live.  The JAX compiles of the bit counter, the motion search, the
mode-cost evaluators and `_coef_plane` take minutes on the CPU, so
those cases (`STORED`) compare with thor_tpu's outputs kept in
tests/torch_turbo/ops_ref.npz; the `slow` fixture test of
tests/test_torch_turbo.py recomputes them with thor_tpu and holds them
equal to the file, and
`python tests/test_torch_turbo_ops.py` writes it.
"""
import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from thor_tpu.enc import turbo as RT
from thor_tpu.enc import turbo_final as RF
from thor_tpu.ops import coeff_cost as RC
from thor_tpu.ops import filters as ROF
from thor_tpu.ops import me_batch as RM
from thor_tpu.ops import quant as RQ
from thor_tpu.ops import transform as RTR
from thor_tpu_torch.enc import turbo as PT
from thor_tpu_torch.enc import turbo_final as PF
from thor_tpu_torch.ops import coeff_cost as PC
from thor_tpu_torch.ops import filters as POF
from thor_tpu_torch.ops import me_batch as PM
from thor_tpu_torch.ops import quant as PQ
from thor_tpu_torch.ops import transform as PTR

torch.set_num_threads(1)
H, W = 64, 128
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_turbo", "ops_ref.npz")


def T(a):
    return torch.from_numpy(np.array(a))


def eq(got, want):
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            eq(g, w)
        return
    w = np.asarray(want)
    g = got.numpy()
    assert g.shape == w.shape
    np.testing.assert_array_equal(g, w)


def _frames(kind, bd=8, h=H, w=W, seed=0):
    """(org [h,w], org padded [h+130,w+130], reference [h+320,w+320])
    int32: a textured original and a shifted, noisy reference, or flat
    planes where every candidate ties."""
    rng = np.random.default_rng(seed)
    hi = (1 << bd) - 1
    if kind == "flat":
        org = np.full((h, w), hi // 3, np.int32)
        ref = np.full((h + 320, w + 320), hi // 3, np.int32)
    else:
        base = (np.linspace(0, hi * 0.7, w)[None, :] +
                np.linspace(0, hi * 0.2, h)[:, None])
        org = np.clip(base + rng.integers(-hi // 16, hi // 16, (h, w)), 0,
                      hi).astype(np.int32)
        shifted = np.roll(org, (3, -5), axis=(0, 1))
        ref = np.pad(np.clip(shifted + rng.integers(-4, 5, (h, w)), 0, hi),
                     160, mode="edge").astype(np.int32)
    orgp = np.zeros((h + 130, w + 130), np.int32)
    orgp[:h, :w] = org
    return org, orgp, ref


def _mvs(n, seed, spread=40):
    rng = np.random.default_rng(seed)
    return rng.integers(-spread, spread, (n, 2)).astype(np.int32)


# ---------------------------------------------------------------- ops

@pytest.mark.parametrize("size", [4, 8, 16, 32, 64, 128])
def test_fwd_transform_batch(size):
    rng = np.random.default_rng(size)
    for fast in (False, True):
        for bd in (8, 10):
            hi = (1 << bd) - 1
            x = rng.integers(-hi, hi + 1, (6, size, size)).astype(np.int32)
            x[0] = hi          # saturating stage clips
            x[1] = -hi
            eq(PTR.fwd_transform_batch(T(x), size, fast, bd),
               RTR.fwd_transform_batch(jnp.asarray(x), size, fast, bd))


@pytest.mark.parametrize("size", [4, 8, 16, 32])
@pytest.mark.parametrize("weighted", [False, True])
def test_quantize_batch(size, weighted):
    rng = np.random.default_rng(size * 2 + weighted)
    qs = min(size, 16)
    x = (rng.normal(0, 400, (24, qs, qs)) *
         (rng.random((24, qs, qs)) < rng.random((24, 1, 1)))).astype(np.int16)
    x[0] = 0
    x[1, 0, 0] = 32767
    x[2] = -32768
    wm = rng.integers(16, 160, (qs, qs)).astype(np.int64)
    for intra in (0, 1):
        for qp in (0, 17, 32, 51):
            if weighted:
                want = RQ.quantize_batch(jnp.asarray(x), qp, size, intra,
                                         wmatrix=jnp.asarray(wm),
                                         weighted=True)
                got = PQ.quantize_batch(T(x), qp, size, intra,
                                        wmatrix=T(wm), weighted=True)
            else:
                want = RQ.quantize_batch(jnp.asarray(x), qp, size, intra)
                got = PQ.quantize_batch(T(x), qp, size, intra)
            assert got[0].dtype == torch.int16
            eq(got, want)


def test_quote_mv_bits_and_clip_mv():
    rng = np.random.default_rng(5)
    d = rng.integers(-400, 400, (2, 2000)).astype(np.int32)
    eq(PM.quote_mv_bits_batch(T(d[0]), T(d[1])),
       RM.quote_mv_bits_batch(jnp.asarray(d[0]), jnp.asarray(d[1])))
    pos = rng.integers(0, 1000, (2, 2000)).astype(np.int32)
    for sign in (0, 1):
        eq(PM.clip_mv_batch(T(d[0] * 4), T(d[1] * 4), T(pos[0]), T(pos[1]),
                            1920, 1080, 16, 16, sign),
           RM.clip_mv_batch(jnp.asarray(d[0] * 4), jnp.asarray(d[1] * 4),
                            jnp.asarray(pos[0]), jnp.asarray(pos[1]),
                            1920, 1080, 16, 16, sign))


def test_scale2():
    x = np.random.default_rng(7).integers(0, 1024, (64, 96)).astype(
        np.int32)
    eq(PT.scale2(T(x)), RT.scale2(jnp.asarray(x)))


# ---------------------------------------------------------------- finalizer

@pytest.mark.parametrize("plane", [0, 1])
def test_cdef_search_sums(plane):
    rng = np.random.default_rng(20 + plane)
    hp, wp = 32, 48
    src = rng.integers(0, 256, (hp, wp)).astype(np.int32)
    org = np.clip(src + rng.integers(-6, 7, (hp, wp)), 0, 255).astype(
        np.int32)
    dirs, var = ROF.cdef_dirs(jnp.asarray(src), 0)
    dirs, var = np.asarray(dirs), np.asarray(var)
    levels = np.array([0, 1, 3, 7, 15, 2], np.int32)
    secs = np.array([0, 1, 2, 3, 1, 0], np.int32)
    damp = 5 - plane
    eq(POF.cdef_search_sums(T(src), T(org), T(dirs), T(var), levels.tolist(),
                            secs.tolist(), plane, 8, damp, damp, 0),
       ROF.cdef_search_sums(jnp.asarray(src), jnp.asarray(org),
                            jnp.asarray(dirs), jnp.asarray(var),
                            jnp.asarray(levels), jnp.asarray(secs), plane, 8,
                            damp, damp, 0))


# ------------------------------------------- cases held to stored outputs

LAM = np.float32(0.8 * 61.2922)


def _coeff_bits_case(size, chroma, intra):
    rng = np.random.default_rng(size + 10 * chroma + 100 * intra)
    qs = min(size, 16)
    n2 = qs * qs
    x = (rng.integers(-40, 41, (40, n2)) *
         (rng.random((40, n2)) < rng.random((40, 1)) ** 2)).astype(np.int32)
    x[0] = 0                       # all-zero row
    x[1] = 0
    x[1, 0] = 1                    # single DC of 1 (chroma prologue case)
    x[2] = 0
    x[2, n2 - 1] = -7              # single coefficient at the end
    x[3] = 0
    x[3, n2 // 3] = 200
    return (lambda: PC.coeff_bits_batch(T(x), size, chroma, intra),
            lambda: RC.coeff_bits_batch(jnp.asarray(x), size, chroma, intra))


def _motion_case(kind, stage):
    """prepass_half -> refine16 -> upsize_mv(32), each stage from thor_tpu's
    output of the stage before (kept in the file too)."""
    org, _, ref = _frames(kind)
    orgh = np.asarray(PT.scale2(T(org)))
    refh = np.asarray(PT.scale2(T(ref)))
    if stage == "prepass_half":
        return (lambda: PT.prepass_half(T(orgh), T(refh), H // 2, W // 2),
                lambda: RT.prepass_half(jnp.asarray(orgh), jnp.asarray(refh),
                                        H // 2, W // 2))
    if stage == "refine16":
        mvh = _stored(f"motion_{kind}_prepass_half")
        return (lambda: PT.refine16(T(org), T(ref), T(mvh), H, W, 8),
                lambda: RT.refine16(jnp.asarray(org), jnp.asarray(ref),
                                    jnp.asarray(mvh), H, W, 8))
    mv16 = _stored(f"motion_{kind}_refine16")
    return (lambda: PT.upsize_mv(T(org), T(ref), T(mv16), H, W, 32, 8),
            lambda: RT.upsize_mv(jnp.asarray(org), jnp.asarray(ref),
                                 jnp.asarray(mv16), H, W, 32, 8))


def _inter_case(kind, s, tb):
    org, _, ref = _frames(kind, seed=s)
    mv = _mvs((H // s) * (W // s), s)
    return (lambda: PT.eval_inter(T(org), T(ref), T(mv), torch.tensor(LAM),
                                  30, H, W, s, 8, tb_trial=tb),
            lambda: RT.eval_inter(jnp.asarray(org), jnp.asarray(ref),
                                  jnp.asarray(mv), jnp.float32(LAM), 30, H,
                                  W, s, 8, tb_trial=tb))


def _skip_case(kind):
    org, _, ref = _frames(kind, seed=3)
    s = 16
    mv = _mvs((H // s) * (W // s), 4)
    return (lambda: PT.eval_skip(T(org), T(ref), T(mv), torch.tensor(LAM),
                                 H, W, s, 8),
            lambda: RT.eval_skip(jnp.asarray(org), jnp.asarray(ref),
                                 jnp.asarray(mv), jnp.float32(LAM), H, W, s,
                                 8))


def _intra_case(kind, nim):
    org, orgp, _ = _frames(kind, seed=nim)
    s = 16
    return (lambda: PT.eval_intra(T(orgp), T(org), torch.tensor(LAM), 27, H,
                                  W, s, 8, nim=nim),
            lambda: RT.eval_intra(jnp.asarray(orgp), jnp.asarray(org),
                                  jnp.float32(LAM), 27, H, W, s, 8, nim=nim))


def _bipred_case(tb):
    org, _, refA = _frames("textured", seed=8)
    _, _, refB = _frames("textured", seed=9)
    s = 16
    n = (H // s) * (W // s)
    mvA, mvB = _mvs(n, 10), _mvs(n, 11)
    return (lambda: PT.eval_bipred(T(org), T(refA), T(refB), T(mvA), T(mvB),
                                   torch.tensor(LAM), 34, H, W, s, 8,
                                   tb_trial=tb),
            lambda: RT.eval_bipred(jnp.asarray(org), jnp.asarray(refA),
                                   jnp.asarray(refB), jnp.asarray(mvA),
                                   jnp.asarray(mvB), jnp.float32(LAM), 34, H,
                                   W, s, 8, tb_trial=tb))


def _coef_plane_case(is_i, speed):
    rng = np.random.default_rng(12 + is_i)
    hp, wp = 128, 256
    res = rng.integers(-255, 256, (hp, wp)).astype(np.int32)
    ls4 = np.zeros((hp // 4, wp // 4), np.int32)
    # a mosaic of TB sizes 8..128 (and unused cells)
    ls4[:32, :32] = 7
    ls4[:16, 32:48] = 6
    ls4[16:32, 32:40] = 5
    ls4[16:32, 40:48] = 4
    ls4[:8, 48:64] = 3
    sizes = (8, 16, 32, 64, 128)
    return (lambda: PF._coef_plane(T(res), T(ls4), 30, is_i, sizes, speed, 8),
            lambda: RF._coef_plane(jnp.asarray(res), jnp.asarray(ls4), 30,
                                   is_i, sizes, speed, 8))


def _wrap_case(fn, tb=False):
    """10-bit, s=128: the skip SSD of a white block over a black reference
    (16384 * 1023^2) and the inter SSD of a checkerboard that qp 51
    flattens pass 2^31; thor_tpu's int64 sums keep them whole."""
    n = 128
    org = np.full((n, n), 1023, np.int32)
    checker = ((np.arange(n)[:, None] + np.arange(n)[None, :]) % 2 * 1023
               ).astype(np.int32)
    ref = np.zeros((n + 320, n + 320), np.int32)
    mv = np.zeros((1, 2), np.int32)
    lam = np.float32(5647.2498)
    if fn == "skip":
        return (lambda: PT.eval_skip(T(org), T(ref), T(mv), torch.tensor(lam),
                                     n, n, n, 10),
                lambda: RT.eval_skip(jnp.asarray(org), jnp.asarray(ref),
                                     jnp.asarray(mv), jnp.float32(lam), n, n,
                                     n, 10))
    return (lambda: PT.eval_inter(T(checker), T(ref), T(mv),
                                  torch.tensor(lam), 51, n, n, n, 10,
                                  tb_trial=tb),
            lambda: RT.eval_inter(jnp.asarray(checker), jnp.asarray(ref),
                                  jnp.asarray(mv), jnp.float32(lam), 51, n, n,
                                  n, 10, tb_trial=tb))


STORED = {}
for _size in (4, 8, 16, 32):
    for _chroma in (0, 1):
        for _intra in (0, 1):
            STORED[f"coeff_bits_{_size}_{_chroma}_{_intra}"] = (
                _coeff_bits_case, (_size, _chroma, _intra))
for _kind in ("textured", "flat"):
    for _stage in ("prepass_half", "refine16", "upsize_mv32"):
        STORED[f"motion_{_kind}_{_stage}"] = (_motion_case, (_kind, _stage))
    for _s in (8, 32):
        for _tb in (False, True):
            STORED[f"eval_inter_{_kind}_{_s}_{int(_tb)}"] = (
                _inter_case, (_kind, _s, _tb))
    STORED[f"eval_skip_{_kind}"] = (_skip_case, (_kind,))
    for _nim in (4, 10):
        STORED[f"eval_intra_{_kind}_{_nim}"] = (_intra_case, (_kind, _nim))
for _tb in (False, True):
    STORED[f"eval_bipred_{int(_tb)}"] = (_bipred_case, (_tb,))
for _is_i in (False, True):
    for _speed in (0, 2):
        STORED[f"coef_plane_{int(_is_i)}_{_speed}"] = (
            _coef_plane_case, (_is_i, _speed))
STORED["wrap10_eval_skip_128"] = (_wrap_case, ("skip",))
STORED["wrap10_eval_inter_128_0"] = (_wrap_case, ("inter", False))
STORED["wrap10_eval_inter_128_1"] = (_wrap_case, ("inter", True))

_FIX = {}


def _stored(name):
    """thor_tpu's output of case `name` (one array, or a tuple)."""
    if not _FIX:
        with np.load(FIXTURE) as z:
            _FIX.update({k: z[k] for k in z.files})
    if name in _FIX:
        return _FIX[name]
    parts = []
    while f"{name}/{len(parts)}" in _FIX:
        parts.append(_FIX[f"{name}/{len(parts)}"])
    assert parts, f"{name} is not in {FIXTURE}"
    return tuple(parts)


def _case(name):
    fn, args = STORED[name]
    return fn(*args)


@pytest.mark.parametrize("name", list(STORED))
def test_against_stored_thor_tpu_outputs(name):
    got = _case(name)[0]()
    eq(got, _stored(name))
    if name.startswith("eval_intra_flat"):   # every mode ties: DC wins
        assert (got[1] == 0).all()
    if name == "wrap10_eval_skip_128":       # the SSD did not wrap
        assert float(got[0][0]) >= 16384 * 1023 ** 2


def _thor_tpu_outputs():
    """Every stored case computed by thor_tpu, in STORED's order (the
    motion stages read the stage before from _FIX)."""
    out = {}
    _FIX.clear()
    for name in STORED:
        r = _case(name)[1]()
        if isinstance(r, (tuple, list)):
            for i, a in enumerate(r):
                out[f"{name}/{i}"] = np.asarray(a)
        else:
            out[name] = np.asarray(r)
        _FIX.clear()
        _FIX.update(out)
    return out


def check_stored_outputs():
    """Recompute every stored case with thor_tpu: the file must hold
    exactly its outputs (run by tests/test_torch_turbo.py's `slow`
    fixture test)."""
    with np.load(FIXTURE) as z:
        want = {k: z[k] for k in z.files}
    got = _thor_tpu_outputs()
    _FIX.clear()
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], k)


if __name__ == "__main__":
    np.savez_compressed(FIXTURE, **_thor_tpu_outputs())
    sys.exit(0)
