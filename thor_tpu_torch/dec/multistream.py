"""Multi-stream decode with the pixel pipeline batched over the streams
(torch port of thor_tpu/dec/multistream.py).

Each stream keeps its own host entropy/syntax decoder (bit-serial VLC
cannot parallelise), but the per-frame device work of the two-stage
route - the MC + dequant/itx + reconstruction of
dec/device_pixels.py:frame_exec - runs once for all streams
(`frame_exec_batch`): the luma kernel launches once per MC list and the
one-plane chroma kernel once per plane and list, over every stream's
cells (BASELINE.md config 4, multi-stream transcode).  thor_tpu shards
that batch over a JAX mesh's `stream` axis; on one card "sharded" means
one batch per frame on one device.  Streams run in lockstep threads that
meet at a rendezvous each P/B frame; thread 0 runs the batch.

The streams decode with `fused=False`, so that every P/B frame of a
4:2:0 stream without qmtx and without cfl_inter reaches the executor
(dec/decoder.py).  Streams must share geometry and bit depth, and their
frames must reach the executor in the same cadence (the same frame
types, the natural shape of a transcoding fleet).  Where they differ the
decode raises and does not hang: a stream thread that ends or fails
closes the rendezvous, and a thread that then reaches it, or still waits
at it, raises RuntimeError (a thread already released from it goes on);
frames of different geometry raise ValueError before the batch.

As thor_tpu does, each reference stack is padded to 4 by repeating its
last reference, so that a stream's reference index reads its own stack
as it would in thor_tpu's `vmap`.  Unlike thor_tpu, which runs list 1
for every frame (`has_avg=True`, a uniform compiled signature), the
batch runs it only when some stream of the frame averages: the output
is the same, since the average's mask is zero elsewhere, and a P-only
pair launches the luma kernel once and the one-plane chroma kernel twice
per frame, half the launches of two solo decodes.
"""
from __future__ import annotations

import threading

import numpy as np

from .. import trace as TR
from . import device_pixels as DP
from .decoder import decode_stream, resolve_device

STACK_DEPTH = 4   # thor_tpu pads every stream's reference stacks to 4


class CadenceError(RuntimeError):
    """A stream reached the frame rendezvous after another stream had
    ended or failed."""


class Rendezvous:
    """A reusable barrier for `n` threads that `close()` breaks only for
    the threads of a round it has not yet released: one that reaches it,
    or still waits at it, after the close raises CadenceError, while one
    that the last arrival already released goes on even if it has not
    woken yet (threading.Barrier.abort would break that one too)."""

    def __init__(self, n: int):
        self.n = n
        self.cond = threading.Condition()
        self.count = 0
        self.generation = 0
        self.closed = False

    def wait(self, sid):
        with TR.span("dec.rendezvous"), self.cond:
            gen = self.generation
            if not self.closed:
                self.count += 1
                if self.count == self.n:
                    self.count = 0
                    self.generation += 1
                    self.cond.notify_all()
                    return
                while self.generation == gen and not self.closed:
                    self.cond.wait()
            if self.generation == gen:
                raise CadenceError(
                    f"stream {sid}: another stream ended or failed before "
                    f"this frame's rendezvous: the streams differ in "
                    f"cadence (frame count or frame types), or one of them "
                    f"failed")

    def close(self):
        with self.cond:
            self.closed = True
            self.cond.notify_all()


def pad_stacks(arrs):
    """Pads build_exec_inputs' reference stacks to STACK_DEPTH by
    repeating the last reference (thor_tpu/dec/multistream.py:45-50)."""
    for k in ("ystack", "ustack", "vstack"):
        st = arrs[k]
        if st.shape[0] < STACK_DEPTH:
            reps = np.repeat(st[-1:], STACK_DEPTH - st.shape[0], axis=0)
            arrs[k] = np.concatenate([st, reps], axis=0)
    return arrs


class ShardedExecutor:
    """Per-frame rendezvous: collects every stream's frame_exec inputs and
    runs ONE stream-batched frame_exec_batch on `device` (thor_tpu's
    name: there it is sharded over a mesh; here it is one batch on one
    card)."""

    def __init__(self, n_streams: int, device):
        self.n = n_streams
        self.device = device
        self.rendezvous = Rendezvous(n_streams)
        self.inputs = [None] * n_streams
        self.static = [None] * n_streams
        self.out = None

    def __call__(self, dec, plan, slots, refs):
        sid = dec.stream_id
        arrs, static = DP.build_exec_inputs(dec, plan, refs)
        self.inputs[sid] = pad_stacks(arrs)
        self.static[sid] = static
        self.rendezvous.wait(sid)
        if sid == 0:
            try:
                self.out = self._run()
            except BaseException:
                self.rendezvous.close()
                raise
        self.rendezvous.wait(sid)
        DP.merge_exec_output(dec, plan, self.out[sid])
        self.rendezvous.wait(sid)   # keep self.out until every stream merged

    @TR.spanned("dec.batch_exec")
    def _run(self):
        sig = [{k: v for k, v in s.items() if k != "has_avg"}
               for s in self.static]
        for i, s in enumerate(sig):
            if s != sig[0]:
                raise ValueError(f"stream {i}'s frame {s} differs from "
                                 f"stream 0's {sig[0]}: the streams of a "
                                 f"batch must share geometry and bit depth")
        has_avg = any(s["has_avg"] for s in self.static)
        batch = [DP.upload(a, self.device) for a in self.inputs]
        packed = DP.frame_exec_batch(batch, has_avg=has_avg, **sig[0])
        return packed.cpu().numpy()


def decode_streams_sharded(streams, device=None):
    """Decode N real bitstreams in lockstep, their two-stage frames batched
    on `device` (CUDA by default; dec/decoder.py:resolve_device).  Returns
    per-stream frame lists in display order, each equal to that stream's
    own decode.  A stream that fails fails the call, named in the
    exception: ValueError where the streams' frames differ in
    geometry, RuntimeError otherwise (a CadenceError where they differ
    in cadence)."""
    device = resolve_device(device)
    n = len(streams)
    ex = ShardedExecutor(n, device)
    results = [None] * n
    errors = []

    def run_one(sid, data):
        def hook(dec):
            dec.stream_id = sid
            dec.plan_executor = ex
        try:
            _, frames = decode_stream(data, device=device, fused=False,
                                      decoder_hook=hook)
            results[sid] = frames
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append((sid, e))
        finally:
            # a stream that ended (or failed) frees the others' waits
            ex.rendezvous.close()

    threads = [threading.Thread(target=run_one, args=(i, s))
               for i, s in enumerate(streams)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        # the first failure that is not another stream's broken rendezvous
        sid, err = min(errors, key=lambda e: isinstance(e[1], CadenceError))
        kind = ValueError if isinstance(err, ValueError) else RuntimeError
        raise kind(f"stream {sid} failed: {err}") from err
    return results
