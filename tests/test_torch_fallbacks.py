"""The decoder's unfused routes in thor_tpu_torch against thor_tpu's,
exactly (tolerance 0: the codec is integer), on the CPU: the unfused loop
filters (`filters_exec`, `deblock_exec`), the two-stage executor
(`frame_exec`, `execute` with `merge_exec_output`) on the parsed plans of a
golden's P frames, and the Python syntax walk against the native parse.
thor_tpu's side runs as its own tests run it on the CPU (JAX_PLATFORMS=cpu).
"""
import copy
import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda import FILTER_CASES, filters_exec_inputs
from thor_tpu.dec import device_pixels as JDP
from thor_tpu.ops import filters as JOF
from thor_tpu_torch import decode_stream
from thor_tpu_torch import trace as TR
from thor_tpu_torch.dec import decoder as PD
from thor_tpu_torch.dec import device_frame as PDF
from thor_tpu_torch.dec import device_pixels as PDP
from thor_tpu_torch.dec import native_parse as PNP
from thor_tpu_torch.ops import filters as POF

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
T = torch.from_numpy


def _read(name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


def _eq(got, want):
    want = np.asarray(want)
    return (got.numpy().dtype == want.dtype and got.shape == want.shape
            and np.array_equal(got.numpy(), want))


@pytest.mark.parametrize("case", FILTER_CASES, ids=str)
def test_filters_exec(case):
    """4:2:0, 4:4:4 and mono; 8 and 10 bits; deblocking on and off; each
    CLPF strength zero and non-zero; the packed int16 layout."""
    args, kw = filters_exec_inputs(case)
    got = POF.filters_exec(*[T(a) for a in args], **kw)
    want = JOF.filters_exec(*[jnp.asarray(a) for a in args], **kw)
    H, W, sub, mono = case[:4]
    assert got.shape == ((H, W) if mono else (H + (H >> sub) * (2 - sub), W))
    assert _eq(got, want)


@pytest.mark.parametrize("case", [c for c in FILTER_CASES if c[5]][::2],
                         ids=str)
def test_deblock_exec(case):
    args, kw = filters_exec_inputs(case, seed=1)
    kw = {k: kw[k] for k in ("qp", "qpc", "bd", "sub", "mono")}
    got = POF.deblock_exec(*[T(a) for a in args[:7]], **kw)
    want = JOF.deblock_exec(*[jnp.asarray(a) for a in args[:7]], **kw)
    assert _eq(got, want)
    assert not np.array_equal(got.numpy()[:case[0]], args[0])  # it acted


def _tree(fn, a):
    if isinstance(a, dict):
        return {k: _tree(fn, v) for k, v in a.items()}
    return fn(a)


@pytest.fixture(scope="module")
def two_stage_frames():
    """The P frames of small256_LDB_medium_complexity on the two-stage
    route: what `execute` was given for each (the decoder with its state
    at that moment, the plan, the references), kept by a spy."""
    seen = []
    orig = PDP.execute

    def spy(dec, plan, slots, refs):
        shim = copy.copy(dec)
        shim.rec = copy.deepcopy(dec.rec)
        seen.append((shim, plan, slots, [copy.deepcopy(r) for r in refs]))
        return orig(dec, plan, slots, refs)

    PDP.execute = spy
    try:
        _, frames = decode_stream(
            _read("small256_LDB_medium_complexity.bit"), device="cpu",
            fused=False)
    finally:
        PDP.execute = orig
    assert b"".join(frames) == _read("small256_LDB_medium_complexity_rec.yuv")
    assert len(seen) == 7
    return seen


@pytest.mark.parametrize("bipred", [False, True])
def test_frame_exec(two_stage_frames, bipred):
    """frame_exec on a parsed plan: the first P frame without a second MC
    list and the first with one (the bipred average)."""
    dec, plan, _, refs = next(f for f in two_stage_frames
                              if bool(f[1].avg.any()) == bipred)
    arrs, static = PDP.build_exec_inputs(dec, plan, refs)
    jarrs, jstatic = JDP.build_exec_inputs(dec, plan, refs)
    assert static == jstatic and static["has_avg"] == bipred
    want = JDP.frame_exec(**_tree(jnp.asarray, jarrs), **jstatic)
    got = PDP.frame_exec(**_tree(T, arrs), **static)
    assert _eq(got, want)
    assert got.numpy().any()


def test_execute_and_merge(two_stage_frames):
    """execute + merge_exec_output: the same cells of dec.rec written, with
    the same values, and the intra cells left alone."""
    for dec, plan, slots, refs in two_stage_frames[:3]:
        jdec, pdec = copy.copy(dec), copy.copy(dec)
        for d in (jdec, pdec):
            d.rec = copy.deepcopy(dec.rec)
            for p in (d.rec.y, d.rec.u, d.rec.v):
                p[:] = 77      # what stays marks a cell not written
        JDP.execute(jdec, plan, slots, refs)
        PDP.execute(pdec, plan, slots, refs)
        for p in ("y", "u", "v"):
            np.testing.assert_array_equal(getattr(pdec.rec, p),
                                          getattr(jdec.rec, p), p)
        inter = np.repeat(np.repeat(plan.inter.astype(bool), 4, 0), 4, 1)
        assert inter.any() and (pdec.rec.y[~inter] == 77).all()


def test_execute_refuses_a_reference_whose_pull_is_pending(two_stage_frames):
    dec, plan, slots, refs = two_stage_frames[0]
    refs = [copy.copy(r) for r in refs]
    refs[0].host_pixels_valid = False
    with pytest.raises(RuntimeError, match="deferred"):
        PDP.build_exec_inputs(dec, plan, refs)


@pytest.mark.parametrize("name", ["plan_block_mc", "_plan_temp"])
def test_copied_mc_planning_equals_thor_tpu(name):
    """The Python walk's MC planning (the native parser plans in C) is
    copied verbatim."""
    assert inspect.getsource(getattr(PDP, name)) == \
        inspect.getsource(getattr(JDP, name))


@pytest.mark.parametrize("name,fused", [
    ("tiny64_ldblc", True), ("hdb9_128", True), ("hdb9_128", False),
    ("c444_128", True), ("small256_LDB_high_efficiency", True)])
def test_python_walk_equals_native_parse(name, fused, monkeypatch):
    """With the native parser returning no records, every frame is walked
    in Python: the same frames and the same bit statistics as the native
    parse gives (the two-stage executor planned from the walk when the
    stream allows it, host pixels otherwise; the MC plan of hdb9_128
    includes bipred and the interpolated reference)."""
    data = _read(name + ".bit")
    want_h, want = decode_stream(data, device="cpu", fused=fused)
    monkeypatch.setattr(PNP, "parse_frame", lambda *a, **k: None)
    TR.reset(*PD.ROUTE_COUNTERS)
    got_h, got = decode_stream(data, device="cpu", fused=fused)
    assert PD.route_frames()["python_walk"] == len(got) == len(want)
    assert got == want and b"".join(got) == _read(name + "_rec.yuv")
    assert vars(got_h.bit_count) == vars(want_h.bit_count)


def test_plan_executor_hook():
    """A callable in Decoder.plan_executor takes the place of
    device_pixels.execute for two-stage frames."""
    calls = []

    class Hooked(PD.Decoder):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.plan_executor = self.hook

        def hook(self, dec, plan, slots, refs):
            calls.append(len(refs))
            PDP.execute(dec, plan, slots, refs)

    orig, PD.Decoder = PD.Decoder, Hooked
    try:
        _, frames = decode_stream(_read("tiny64_ldblc.bit"), device="cpu",
                                  fused=False)
    finally:
        PD.Decoder = orig
    assert b"".join(frames) == _read("tiny64_ldblc_rec.yuv")
    assert len(calls) == 5


def test_fused_and_unfused_frames_alternate(monkeypatch):
    """Every other frame refused by the fused decoder, with a one-entry
    ring: an unfused frame flushes the pending pull before it reads host
    pixels, and the next fused frame uploads the unfused frame, which the
    ring never held."""
    n = [0]

    def every_other(self, dec, blks):
        n[0] += 1
        return n[0] % 2 == 0

    monkeypatch.setattr(PDF.DeviceFrameDecoder, "RING_CAP", 1)
    monkeypatch.setattr(PDF.DeviceFrameDecoder, "eligible", every_other)
    for name in ("tiny64_ldblc", "small256_LDB_medium_complexity"):
        TR.reset(*PD.ROUTE_COUNTERS)
        _, frames = decode_stream(_read(name + ".bit"), device="cpu")
        assert b"".join(frames) == _read(name + "_rec.yuv")
        assert PD.route_frames()["fused"] >= 3
        assert PD.route_frames()["two_stage"] >= 2
