"""The reduction of a device trace: busy time is the union of the
activities inside the window, idle time is summed by the innermost span
open across each gap, kernel names are shortened for the breakdown."""
from h100bench_util import ROOT  # noqa: F401 - puts the harness on the path
from harness import trace


def test_busy_is_the_union_inside_the_window():
    acts = [(100, 50, "k1"), (120, 60, "k2"),   # overlap: 100-180
            (300, 100, "k1"),                    # 300-400
            (950, 200, "k3")]                    # cut at the window's end
    s = trace.reduce_activities(acts, 50, 1000)
    assert s.window_s == 950e-9
    assert abs(s.busy_s - (80 + 100 + 50) * 1e-9) < 1e-15
    assert s.kernels["k1"][1] == 2
    assert s.gaps == [(50, 100), (180, 300), (400, 950)]
    assert s.kernel_seconds("k")[1] == 4


def test_idle_time_by_the_innermost_open_span():
    s = trace.reduce_activities([(100, 50, "k"), (200, 10, "k")], 0, 500)
    assert s.gaps == [(0, 100), (150, 200), (210, 500)]
    spans = [(0, 400, "decode_stream"), (160, 390, "dec.device_frame")]
    b = trace.breakdown(s, spans, "outside")
    assert [n for n, _ in b["device_ops"]] == ["k"]
    assert abs(b["device_ops"][0][1] - 60e-9) < 1e-15
    idle = dict(b["idle_gaps"])
    assert [n for n, _ in b["idle_gaps"]] == ["dec.device_frame",
                                             "decode_stream"]
    # 150-200 and 210-500 have their middles in dec.device_frame
    assert abs(idle["dec.device_frame"] - 340e-9) < 1e-15
    assert abs(idle["decode_stream"] - 100e-9) < 1e-15     # 0-100
    assert list(trace.idle_by_span([(450, 500)], spans, "outside")) == [
        "outside"]
    assert list(trace.idle_by_span([(0, 10)], [], "outside")) == [
        "outside"]


def test_short_names():
    assert trace.short_name(
        "void thor::mc_cells_kernel<thor::LumaK>(thor::McArgs)") == \
        "thor::mc_cells_kernel<thor::LumaK>"
    assert trace.short_name("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD (Pageable -> Device)"
    assert len(trace.short_name("void f<" + "x" * 500 + ">(int)")) == 160
    assert trace.short_name("") == "(unnamed device activity)"
