"""thor_tpu_torch's multi-stream decode and tile pipeline against
thor_tpu's, on the CPU, tolerance 0 (the codec is integer).

- The stream-batched executor (device_pixels.frame_exec_batch) on the
  inputs the port's decoders give `Decoder.plan_executor`, padded as
  ShardedExecutor pads them, equals thor_tpu's
  `jax.vmap(frame_exec)` with its forced `has_avg=True`: two 64x64
  streams, a bipred pair, and reference indices out of range in one
  stream of a batch.
- decode_streams_sharded gives every golden of a matched pair, with the
  executor run once per P frame over both streams; streams that differ in
  cadence raise instead of hanging, while a stream that ends does not
  break a rendezvous that already released the others; decode_stream's
  decoder_hook.
- multi_stream_step and multi_stream_full equal thor_tpu's on a one-device
  CPU mesh; the chroma branch follows the per-stream tile count.
- The C library loads once from 8 threads at once.
"""
import copy
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from thor_tpu.dec import device_pixels as JDP
from thor_tpu.models import pipeline as JP
from thor_tpu_torch import _native
from thor_tpu_torch.dec import decoder as PD
from thor_tpu_torch.dec import device_pixels as PDP
from thor_tpu_torch.dec import multistream as PMS
from thor_tpu_torch.models import pipeline as PP

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _read(name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


def _captured(name):
    """build_exec_inputs of each two-stage frame of `name` as the port's
    decoder (fused=False, on the CPU) gives them to plan_executor, padded
    as ShardedExecutor pads them, with the frames' static arguments."""
    seen = []

    def hook(dec):
        def ex(dec, plan, slots, refs):
            arrs, static = PDP.build_exec_inputs(dec, plan, refs)
            seen.append((PMS.pad_stacks(copy.deepcopy(arrs)), static))
            PDP.execute(dec, plan, slots, refs)
        dec.plan_executor = ex

    _, frames = PD.decode_stream(_read(name + ".bit"), device="cpu",
                                 fused=False, decoder_hook=hook)
    assert b"".join(frames) == _read(name + "_rec.yuv")
    return seen


@pytest.fixture(scope="module")
def captured():
    return {n: _captured(n) for n in ("tiny64_ldblc", "tiny64_rc",
                                      "hdb9_128")}


_VMAP = {}


def _thor_tpu_batch(inputs, static):
    """thor_tpu/dec/multistream.py:ShardedExecutor._run's computation on a
    one-device CPU: jax.vmap(frame_exec) over the stacked inputs, with its
    forced has_avg=True."""
    static = dict(static, has_avg=True)
    key = tuple(sorted(static.items()))
    if key not in _VMAP:
        core = JDP.frame_exec.__wrapped__

        def batched(args):
            return jax.vmap(lambda a: core(
                a["ystack"], a["ustack"], a["vstack"], a["lg"],
                a["cg"], a["avg"], a["coef_y"], a["qp4_y"],
                a["ls4_y"], a["coef_u"], a["coef_v"], a["qp4_c"],
                a["ls4_c"], **static))(args)
        _VMAP[key] = jax.jit(batched)
    stacked = jax.tree_util.tree_map(lambda *xs: np.stack(xs), *inputs)
    return np.asarray(_VMAP[key](jax.tree_util.tree_map(jnp.asarray,
                                                        stacked)))


def _port_batch(inputs, static):
    batch = [PDP.upload(a, "cpu") for a in inputs]
    sig = {k: v for k, v in static[0].items() if k != "has_avg"}
    return PDP.frame_exec_batch(
        batch, has_avg=any(s["has_avg"] for s in static), **sig).numpy()


def _pairs(captured, a, b):
    for (ia, sa), (ib, sb) in zip(captured[a], captured[b]):
        assert {k: v for k, v in sa.items() if k != "has_avg"} == \
            {k: v for k, v in sb.items() if k != "has_avg"}
        yield [ia, ib], [sa, sb]


@pytest.mark.parametrize("pair", [("tiny64_ldblc", "tiny64_rc"),
                                  ("hdb9_128", "hdb9_128")])
def test_batched_executor_equals_thor_tpu_vmap(captured, pair):
    """Every two-stage frame of the pair; hdb9_128's B frames average (the
    bipred case), the tiny64 pair's P frames do not."""
    n = 0
    avg = []
    for inputs, static in _pairs(captured, *pair):
        want = _thor_tpu_batch(inputs, static[0])
        got = _port_batch(inputs, static)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        avg.append(any(s["has_avg"] for s in static))
        n += 1
    assert n == len(captured[pair[0]]) == (5 if pair[0] != "hdb9_128"
                                           else 8)
    assert any(avg) == (pair[0] == "hdb9_128")


def test_batched_executor_reference_index_out_of_range(captured):
    """rsel -1, -5 and 7 in one stream of a batch read that stream's own
    (padded) stack, as thor_tpu's vmap does, never the other stream's."""
    inputs, static = next(_pairs(captured, "tiny64_ldblc", "tiny64_rc"))
    inputs = copy.deepcopy(inputs)
    # the two goldens decode to the same pixels: stream 1's references are
    # inverted, so that a read of stream 0's planes would show
    for k in ("ystack", "ustack", "vstack"):
        inputs[1][k] = 255 - inputs[1][k]
    for key in ("r0", "r1"):
        r = inputs[1]["lg"][key]
        r[:3] = (-1, -5, 7)
        r[100:103] = (7, -1, -5)
    inputs[1]["avg"][:200] = 1   # list 1 too
    static = [dict(s, has_avg=True) for s in static]
    want = _thor_tpu_batch(inputs, static[0])
    np.testing.assert_array_equal(_port_batch(inputs, static), want)


@pytest.mark.parametrize("names", [("tiny64_ldblc", "tiny64_rc"),
                                   ("tiny64_ldblc", "tiny64_ldblc")])
def test_decode_streams_sharded(monkeypatch, names):
    batches = _count_batches(monkeypatch)
    outs = PMS.decode_streams_sharded([_read(n + ".bit") for n in names],
                                      device="cpu")
    for n, frames in zip(names, outs):
        assert b"".join(frames) == _read(n + "_rec.yuv")
    assert batches == [2] * 5   # one batch of both streams per P frame


def _count_batches(monkeypatch):
    """Records the stream count of each frame_exec_batch call."""
    batches = []
    orig = PDP.frame_exec_batch

    def counted(batch, **kw):
        batches.append(len(batch))
        return orig(batch, **kw)
    monkeypatch.setattr(PDP, "frame_exec_batch", counted)
    return batches


class _SlowWake(threading.Condition):
    """A condition whose waiters, once woken, let the other threads run
    for a while before they take the lock back."""

    def wait(self, timeout=None):
        woken = super().wait(timeout)
        self.release()
        try:
            time.sleep(0.05)
        finally:
            self.acquire()
        return woken


def test_rendezvous_close_spares_released_waiters():
    """The last arrival releases the round and closes at once, before the
    waiter has woken: the waiter goes on; a later arrival raises."""
    r = PMS.Rendezvous(2)
    box = []
    t = threading.Thread(target=lambda: box.append(r.wait(1)))
    t.start()
    while r.count != 1:
        time.sleep(0.001)
    with r.cond:           # the waiter cannot wake before the close
        r.wait(0)
        r.close()
    t.join(timeout=10)
    assert not t.is_alive() and box == [None]
    with pytest.raises(PMS.CadenceError, match="stream 0"):
        r.wait(0)


def test_matched_pair_decodes_when_waiters_wake_late(monkeypatch):
    """Each released stream wakes only after the releasing one has run on,
    so that a stream may end its decode, and close the rendezvous, before
    the other leaves its last wait: the pair still decodes."""
    class SlowRendezvous(PMS.Rendezvous):
        def __init__(self, n):
            super().__init__(n)
            self.cond = _SlowWake()
    monkeypatch.setattr(PMS, "Rendezvous", SlowRendezvous)
    outs = PMS.decode_streams_sharded([_read("tiny64_ldblc.bit")] * 2,
                                      device="cpu")
    for frames in outs:
        assert b"".join(frames) == _read("tiny64_ldblc_rec.yuv")


def test_streams_of_different_cadence_raise():
    """tiny64_dqp has 4 frames, tiny64_ldblc 6: the shorter stream ends
    and the longer one's next rendezvous raises, within seconds."""
    box = []

    def run():
        try:
            PMS.decode_streams_sharded(
                [_read("tiny64_ldblc.bit"), _read("tiny64_dqp.bit")],
                device="cpu")
        except Exception as e:  # noqa: BLE001
            box.append(e)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive(), "the multi-stream decode hung"
    assert len(box) == 1 and type(box[0]) is RuntimeError
    assert "stream 0" in str(box[0]) and "cadence" in str(box[0])


def test_streams_of_different_geometry_raise():
    with pytest.raises(ValueError, match="geometry"):
        PMS.decode_streams_sharded([_read("tiny64_ldblc.bit"),
                                    _read("hdb9_128.bit")], device="cpu")


def test_decoder_hook_runs_once_before_frame_0(monkeypatch):
    events = []
    orig = PD.Decoder.decode_frame

    def frame(self, s, n):
        events.append(("frame", n))
        return orig(self, s, n)

    monkeypatch.setattr(PD.Decoder, "decode_frame", frame)
    _, frames = PD.decode_stream(
        _read("tiny64_ldblc.bit"), device="cpu",
        decoder_hook=lambda dec: events.append(("hook", type(dec))))
    assert b"".join(frames) == _read("tiny64_ldblc_rec.yuv")
    assert events[0] == ("hook", PD.Decoder)
    assert events[1:] == [("frame", n) for n in range(6)]


def test_multi_stream_step_equals_thor_tpu():
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("stream", "row"))
    jstep, jargs = JP.multi_stream_step(mesh, height=96, width=128,
                                        streams=2)
    step, args = PP.multi_stream_step("cpu", height=96, width=128, streams=2)
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with mesh:
        jrec, jsse = jstep(*jargs)
    rec, sse = step(*args)
    np.testing.assert_array_equal(rec.numpy(), np.asarray(jrec))
    assert int(sse) == int(jsse) > 0


def _jax_full(args, height, width):
    return [np.asarray(p) for p in JP.decode_p_frame_420(
        *[jnp.asarray(a) for a in args], height=height, width=width, qp=32,
        platform="cpu", clpf_strengths=(2, 1, 4))]


def test_multi_stream_full_equals_thor_tpu():
    """streams=1 against thor_tpu's multi_stream_full on a one-device
    mesh; stream 1 of streams=2 against thor_tpu's decode_p_frame_420 on
    make_example_full(seed=1)."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("stream",))
    jstep, jargs = JP.multi_stream_full(mesh, height=64, width=128)
    step, args = PP.multi_stream_full("cpu", height=64, width=128,
                                      streams=1)
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with mesh:
        want = jstep(*jargs)
    for g, w in zip(step(*args), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    step, args = PP.multi_stream_full("cpu", height=64, width=128,
                                      streams=2)
    got = step(*args)
    jargs, _, _ = JP.make_example_full(64, 128, 32, seed=1)
    for g, w in zip(got, _jax_full(jargs, 64, 128)):
        np.testing.assert_array_equal(g[1].numpy(), w)


@pytest.mark.parametrize("height,width,streams,uv", [
    (64, 128, 2, True),     # 32 tiles a stream: the U+V kernel
    (48, 64, 4, False)])    # 12 a stream (48 in all): one plane at a time
def test_multi_stream_full_chroma_follows_the_stream(monkeypatch, height,
                                                     width, streams, uv):
    """The chroma MC takes the U+V form when each stream's tile count is a
    multiple of 16, whatever the batch's; every stream equals its solo
    decode_p_frame_420."""
    calls = []
    for name in ("mc_chroma_uv_tiles", "mc_chroma_tiles"):
        fn = getattr(PP, name)
        monkeypatch.setattr(PP, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    step, args = PP.multi_stream_full("cpu", height=height, width=width,
                                      streams=streams)
    got = step(*args)
    assert calls == (["mc_chroma_uv_tiles"] if uv else
                     ["mc_chroma_tiles"] * 2)
    for s in range(streams):
        solo = PP.decode_p_frame_420(*[a[s] for a in args], height=height,
                                     width=width, qp=32, device="cpu",
                                     clpf_strengths=(2, 1, 4))
        for g, w in zip(got, solo):
            assert torch.equal(g[s], w)


def test_native_library_loads_once_from_threads(monkeypatch):
    """8 threads ask for the C library at once: it is built and bound
    once, and every thread gets the same handle."""
    loads = []
    orig = _native._load
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_load",
                        lambda: loads.append(1) or orig())
    start = threading.Barrier(8)
    got = [None] * 8

    def run(i):
        start.wait(timeout=60)
        got[i] = _native.get_lib()
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
    assert len(loads) == 1
    assert all(g is got[0] for g in got) and got[0] is not None


def test_launch_counts_from_threads_are_exact(monkeypatch):
    """The MC launch counters (trace's counters) lose no count when
    several encoder threads launch at once."""
    from thor_tpu_torch import trace as TR
    TR.reset("mc.luma_launches")

    def run():
        for _ in range(5000):
            TR.count("mc.luma_launches")
    threads = [threading.Thread(target=run) for _ in range(8)]
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
    assert TR.counter("mc.luma_launches") == 8 * 5000
