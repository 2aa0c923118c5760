"""thor_tpu_torch.trace: the port's spans and counters, and the benchmark's
readers of them (h100_bench/harness/program.py, h100_bench/metrics/).

On the CPU: tracing off keeps nothing; a fused golden decode, a tiny
turbo encode and a two-stream lockstep decode give their span trees
under one unit per decode_stream / encode_sequence call; the counts on
the spans equal what the port did; the readers read synthetic records
and gaps; every callable that the benchmark wraps or plants faults in
resolves in the port.  On the card (`cuda`): a span around one MC launch
and a synchronise holds that kernel's interval in torch.profiler's
trace, so the spans and the device trace share one clock.  The file
imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_trace.py -m cuda
"""
import copy
import os
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from thor_tpu_torch import decode_stream, decode_streams_sharded
from thor_tpu_torch import trace as TR
from thor_tpu_torch.dec import decoder as PD
from thor_tpu_torch.dec import device_frame as PDF
from thor_tpu_torch.ops import mc as MC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(REPO, "h100_bench")
if BENCH_DIR not in sys.path:
    sys.path.insert(0, BENCH_DIR)

from harness import drivers, faults, manifest  # noqa: E402
from harness import roofline, spans as HS  # noqa: E402

torch.set_num_threads(1)
GOLDEN = os.path.join(REPO, "tests", "golden")
# the C decoder's output of the 64x64 warm-up stream (tiny64_ldblc)
TINY64_REC_SHA256 = ("a4cb3bb5585e988d8ef55f47989f65a96ea035d7"
                     "0995a9809794c6a884fc1edc")


def _quietly(fn, *args):
    """fn(*args) with tracing left as it was: loading a reader imports
    harness/program.py, which turns tracing on for a benchmark run."""
    was = TR.enabled()
    try:
        return fn(*args)
    finally:
        TR.enable(was)


def _program():
    from harness import program
    return program


def _read(name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


@pytest.fixture
def tracing():
    """Tracing on for the test, then back as it was; no record kept."""
    was = TR.enabled()
    TR.drain()
    TR.enable()
    yield
    TR.enable(was)
    TR.drain()


def _parents(recs):
    """span id -> the record of the span open around it (None at a root)."""
    by_id = {r.span_id: r for r in recs}
    return {r.span_id: by_id.get(r.parent_id) for r in recs}


def _named(recs, name):
    return [r for r in recs if r.name == name]


def test_off_is_the_shared_no_op_and_keeps_nothing():
    was = TR.enabled()
    TR.enable(False)
    try:
        TR.drain()
        assert TR.span("dec.frame") is TR.span("x", a=1) is TR.NO_SPAN
        assert TR.unit("dec.stream") is TR.NO_SPAN
        with TR.span("dec.frame") as sp:
            sp.add(segments=3)
            TR.add(frames=1)
        _, frames = decode_stream(_read("tiny64_ldblc.bit"), device="cpu")
        assert b"".join(frames) == _read("tiny64_ldblc_rec.yuv")
        assert TR.drain() == []
    finally:
        TR.enable(was)


def test_spans_nest_add_and_drain(tracing):
    with TR.unit("root", k=1) as root:
        with TR.span("a") as a:
            TR.add(n=2, m=1)
            a.add(n=3)
        with TR.span("b"):
            pass
    with TR.span("loose"):
        pass
    recs = TR.drain()
    assert [r.name for r in recs] == ["a", "b", "root", "loose"]
    r_a, r_b, r_root, r_loose = recs
    assert r_a.attrs == {"n": 5, "m": 1} and r_root.attrs == {"k": 1}
    assert r_a.parent_id == r_b.parent_id == root.span_id
    assert r_root.parent_id is None and r_loose.parent_id is None
    assert r_a.unit == r_b.unit == r_root.unit is not None
    assert r_loose.unit is None
    assert r_root.start_ns <= r_a.start_ns <= r_a.end_ns <= r_b.start_ns
    assert r_b.end_ns <= r_root.end_ns
    assert TR.drain() == []


def test_counters_count_and_reset():
    TR.reset("t.a", "t.b")
    TR.count("t.a")
    TR.count("t.a", 4)
    TR.count("t.b", 2)
    assert (TR.counter("t.a"), TR.counter("t.b"), TR.counter("t.c")) == (
        5, 2, 0)
    TR.reset("t.a")
    assert (TR.counter("t.a"), TR.counter("t.b")) == (0, 2)
    TR.reset("t.b")


def test_fused_decode_tree(tracing, monkeypatch):
    """One dec.stream root; a dec.frame a frame under it in the same
    unit; the parse, the device frame with its prep and intra waves
    inside; `segments` the active segments of build_wave_segments."""
    segs = []
    build = PDF.build_wave_segments

    def spy(*a, **k):
        out = build(*a, **k)
        segs.append(len(out))
        return out

    monkeypatch.setattr(PDF, "build_wave_segments", spy)
    TR.reset(*PD.ROUTE_COUNTERS)
    _, frames = decode_stream(_read("tiny64_ldblc.bit"), device="cpu")
    assert b"".join(frames) == _read("tiny64_ldblc_rec.yuv")
    recs = TR.drain()
    parent = _parents(recs)
    (root,) = _named(recs, "dec.stream")
    assert root.parent_id is None and root.attrs == {}
    assert {r.unit for r in recs} == {root.unit}
    dframes = _named(recs, "dec.frame")
    assert len(dframes) == len(frames) == PD.route_frames()["fused"]
    for r in dframes:
        assert parent[r.span_id] is root and r.attrs == {}
    for name, up in (("dec.native_parse", "dec.frame"),
                     ("dec.device_frame", "dec.frame"),
                     ("dec.frame_prep", "dec.device_frame"),
                     ("dec.intra_waves", "dec.device_frame")):
        got = _named(recs, name)
        assert len(got) == len(frames), name
        for r in got:
            p = parent[r.span_id]
            assert p.name == up
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    waves = _named(recs, "dec.intra_waves")
    assert [r.attrs for r in waves] == [{"segments": n} for n in segs]


def _tiny_encode_cell(frames):
    """enc360_ldblc_turbo's configuration and traffic at 64x64, one clip
    in the pool, one warm-up frame."""
    bench = manifest.load()
    cell = manifest.cell(bench, "enc360_ldblc_turbo")
    cfg = copy.deepcopy(cell.config)
    cfg["codec"].update(width=64, height=64, frames_per_clip=frames)
    tr = copy.deepcopy(cell.traffic)
    tr.update(warmup_frames=1, clips_in_pool=1)
    return manifest.Cell(cell.name, cell.chips, cfg, tr)


def test_turbo_encode_tree(tracing):
    drv = drivers.make(_tiny_encode_cell(2), 2 ** 31 + 77, "cpu")
    drv.setup()
    TR.drain()
    drv.run_unit(0)
    recs = TR.drain()
    parent = _parents(recs)
    (root,) = _named(recs, "enc.clip")
    assert root.parent_id is None and root.attrs == {}
    assert {r.unit for r in recs} == {root.unit}
    eframes = _named(recs, "enc.frame")
    assert len(eframes) == 2
    assert {parent[r.span_id].name for r in eframes} == {"enc.clip"}
    for name, up in (("enc.turbo", "enc.frame"), ("enc.plan", "enc.frame"),
                     ("enc.turbo_final", "enc.frame"),
                     ("enc.intra_waves", "enc.turbo_final"),
                     ("enc.emit", "enc.frame"),
                     ("enc.encoder", "enc.frame")):
        got = _named(recs, name)
        assert len(got) == 2, name
        assert {parent[r.span_id].name for r in got} == {up}, name
    assert all(r.attrs == {} for r in recs)
    clpf = _named(recs, "enc.clpf_apply")
    assert clpf and {parent[r.span_id].name for r in clpf} == {
        "enc.encoder"}


def test_lockstep_rendezvous_in_each_threads_unit(tracing):
    data = _read("tiny64_ldblc.bit")
    TR.reset(*PD.ROUTE_COUNTERS)
    out = decode_streams_sharded([data, data], device="cpu")
    assert all(b"".join(f) == _read("tiny64_ldblc_rec.yuv") for f in out)
    recs = TR.drain()
    roots = _named(recs, "dec.stream")
    assert len(roots) == 2
    unit_of = {r.thread_id: r.unit for r in roots}
    assert len(unit_of) == 2 and len(set(unit_of.values())) == 2
    waits = _named(recs, "dec.rendezvous")
    assert {r.thread_id for r in waits} == set(unit_of)
    assert all(r.unit == unit_of[r.thread_id] for r in recs)
    # three waits a batched (two-stage) frame in every stream thread
    two_stage = PD.route_frames()["two_stage"]
    assert two_stage > 0
    assert len(waits) == 3 * two_stage
    batch = _named(recs, "dec.batch_exec")
    assert len(batch) == two_stage // 2
    assert len({r.thread_id for r in batch}) == 1
    assert all(parent.name == "dec.frame" for parent in (
        _parents(recs)[r.span_id] for r in waits + batch))


def test_counters_from_threads_and_routes():
    TR.reset(*PD.ROUTE_COUNTERS)
    TR.count("dec.route.two_stage", 3)
    assert PD.route_frames() == {"fused": 0, "two_stage": 3,
                                 "host_records": 0, "python_walk": 0}
    TR.reset(*PD.ROUTE_COUNTERS)
    TR.reset("t.threads")

    def run():
        for _ in range(2000):
            TR.count("t.threads")
    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert TR.counter("t.threads") == 8000
    TR.reset("t.threads")


# ----------------------------------------------------------- the readers

def _rec(name, start, end, unit=1, attrs=None, span_id=None):
    return TR.Record(unit, span_id or start, None, 1, name, start, end,
                     attrs or {})


class _Port:
    """Stands for thor_tpu_torch.trace in program.py: hands out fixed
    records once."""

    def __init__(self, recs):
        self.recs = recs

    def drain(self):
        out, self.recs = self.recs, []
        return out


def _ctx(driver, recs, gaps, monkeypatch, frames=2):
    entry = drivers.DRIVERS[driver].entry
    monkeypatch.setattr(_quietly(_program), "PT", _Port(recs))
    return SimpleNamespace(
        driver=driver, frames=frames,
        spans=SimpleNamespace(intervals=[(1000, 9000, entry)]),
        trace=None if gaps is None else SimpleNamespace(gaps=gaps))


def _read_metric(name, ctx):
    return _quietly(manifest.load_reader, name).read(ctx)


def test_decode_readers_on_synthetic_records(monkeypatch):
    recs = [_rec("dec.frame_prep", 500, 900),   # warm-up: not read
            _rec("dec.device_frame", 1000, 5000),
            _rec("dec.frame_prep", 1000, 1400),
            _rec("dec.intra_waves", 2000, 4000, attrs={"segments": 30}),
            _rec("dec.device_frame", 5000, 8000),
            _rec("dec.frame_prep", 5000, 5200),
            _rec("dec.intra_waves", 6000, 7000, attrs={"segments": 10}),
            _rec("dec.rendezvous", 7000, 7600),
            _rec("dec.rendezvous", 7100, 7500),
            _rec("dec.batch_exec", 7600, 8000)]
    # idle middles: 2500 and 6500 in the waves, 4500 in the device frame
    gaps = [(2000, 3000), (4000, 5000), (6000, 7000)]
    ctx = _ctx("decode", recs, gaps, monkeypatch)
    assert _read_metric("frame_prep_ms.dec", ctx) == pytest.approx(
        1e-6 * 600 / 2)
    assert _read_metric("intra_segments.dec", ctx) == 20
    assert _read_metric("intra_idle_ms.dec", ctx) == pytest.approx(
        1e-6 * 2000 / 2)
    # the lockstep decode's spans, summed over the stream threads
    assert _read_metric("rendezvous_wait_ms.dec", ctx) == pytest.approx(
        1e-6 * 1000 / 2)
    assert _read_metric("batch_exec_ms.dec", ctx) == pytest.approx(
        1e-6 * 400 / 2)
    for name in ("plan_emit_ms.enc", "clpf_apply_ms.enc",
                 "intra_idle_ms.enc"):
        assert _read_metric(name, ctx) is None, name
    # no device trace: the idle reader finds nothing, the others read
    ctx = _ctx("decode", recs, None, monkeypatch)
    assert _read_metric("intra_idle_ms.dec", ctx) is None
    assert _read_metric("intra_segments.dec", ctx) == 20


def test_encode_readers_on_synthetic_records(monkeypatch):
    recs = [_rec("enc.plan", 1000, 1300), _rec("enc.emit", 2000, 2100),
            _rec("enc.turbo_final", 1300, 2000),
            _rec("enc.intra_waves", 1400, 1900, attrs={"segments": 3}),
            _rec("enc.encoder", 2100, 4000),
            _rec("enc.clpf_apply", 3000, 3500),
            _rec("enc.clpf_apply", 3500, 3700)]
    ctx = _ctx("encode", recs, [(1500, 1600), (1950, 2000)], monkeypatch)
    assert _read_metric("plan_emit_ms.enc", ctx) == pytest.approx(
        1e-6 * 400 / 2)
    assert _read_metric("clpf_apply_ms.enc", ctx) == pytest.approx(
        1e-6 * 700 / 2)
    assert _read_metric("intra_idle_ms.enc", ctx) == pytest.approx(
        1e-6 * 100 / 2)
    for name in ("intra_segments.dec", "rendezvous_wait_ms.dec",
                 "batch_exec_ms.dec"):
        assert _read_metric(name, ctx) is None, name
    # a port without its own spans: every new reader finds nothing
    monkeypatch.setattr(_program(), "PT", None)
    ctx = SimpleNamespace(driver="encode", frames=2, spans=ctx.spans,
                          trace=ctx.trace)
    assert _read_metric("plan_emit_ms.enc", ctx) is None
    assert _read_metric("intra_idle_ms.enc", ctx) is None


def test_traced_cpu_run_reports_the_programs_metrics(tracing):
    """runner.run on the 64x64 warm-up stream with trace on (the CPU: no
    device trace): the readers of host time and counts read the port's
    spans of the window's unit."""
    from harness import runner
    bench = manifest.load()
    cell = manifest.cell(bench, "dec1080_ldblc_1s")
    cfg = copy.deepcopy(cell.config)
    inp = cfg["input"]
    inp["stream"] = inp["warmup_stream"]
    inp["stream_sha256"] = inp["warmup_stream_sha256"]
    inp["c_oracle_output_sha256"] = TINY64_REC_SHA256
    cfg["codec"].update(width=64, height=64, frames_per_stream=6)
    cell = manifest.Cell(cell.name, cell.chips, cfg, cell.traffic)
    res = runner.run(bench, cell, 2 ** 31 + 5, 0.1, True, device="cpu")
    assert res["correct"] and res["attempted"] == 6
    m = res["metrics"]
    assert m["intra_segments.dec"]["value"] > 0
    assert m["frame_prep_ms.dec"]["value"] > 0
    assert "intra_idle_ms.dec" not in m      # no device trace on the CPU


# ------------------------------------------ the benchmark's hook points

def _targets():
    out = []
    for m in manifest.load()["per_layer"]:
        r = _quietly(manifest.load_reader, m["name"])
        for ts in getattr(r, "SPANS", {}).values():
            out += ts
    out += [f"{mod}:{name}" for mod in roofline.MC_MODULES
            for name in roofline.MC_ENTRIES]
    out += [t for fs in faults.FAULTS.values() for t, _ in fs]
    return sorted(set(out))


@pytest.mark.parametrize("target", _targets())
def test_benchmark_targets_resolve_in_the_port(target):
    owner, attr = HS.resolve(target)
    assert callable(getattr(owner, attr)), target


# ---------------------------------------------------------------- the card

@pytest.mark.cuda
def test_span_holds_the_kernels_device_interval(tracing):
    """A span around one K1 launch and a synchronise contains the
    kernel's activity in torch.profiler's trace (Kineto's clock is
    time.time_ns, the spans')."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda")
    rng = np.random.default_rng(14)
    R, Hp, Wp, n = 2, 200, 264, 4000
    ref = torch.from_numpy(rng.integers(0, 256, (R, Hp, Wp))
                           .astype(np.int16)).to(dev)
    cells = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
        rng.integers(0, R, n), rng.integers(2, Hp - 9, n),
        rng.integers(2, Wp - 9, n), rng.integers(0, 4, n),
        rng.integers(0, 4, n), rng.integers(0, 4, n),
        rng.integers(0, 2, n))]
    MC.mc_cells_luma(ref, *cells, 4, 8)          # built and warmed
    torch.cuda.synchronize()
    TR.drain()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with TR.span("clock.check"):
            MC.mc_cells_luma(ref, *cells, 4, 8)
            torch.cuda.synchronize()
    (rec,) = TR.drain()
    acts = [(e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and roofline.MC_KERNEL in e.name()]
    assert len(acts) == 1
    start, end = acts[0]
    assert rec.start_ns <= start < end <= rec.end_ns, (rec, acts)
