"""The port's own host tier against thor_tpu's: the tables, the C sources,
the Python modules copied verbatim and the native block parser are copies
and must stay equal to the originals; the C library is the port's own
build; and the port's entry points decode on the CUDA card unless the
caller asks for the CPU."""
import copy
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import thor_tpu._hevc_tables as RH
import thor_tpu.tables as RT
from thor_tpu.dec import native_parse as RNP
from thor_tpu_torch import _native as PN
from thor_tpu_torch import decode_stream, tables as PT
from thor_tpu_torch.dec import decoder as PD
from thor_tpu_torch.dec import native_parse as PNP

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")


def _read(name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


def _table_names(mod):
    return sorted(k for k, v in vars(mod).items()
                  if not k.startswith("_")
                  and isinstance(v, (np.ndarray, dict, int)))


@pytest.mark.parametrize("name", _table_names(RT) + _table_names(RH))
def test_tables_equal_thor_tpu(name):
    ref = getattr(RT, name, None)
    if ref is None:
        ref = getattr(RH, name)
    got = getattr(PT, name)
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(got[k], ref[k])
    elif isinstance(ref, np.ndarray):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    else:
        assert got == ref


def test_table_functions_equal_thor_tpu():
    for n in range(1, 300):
        assert PT.log2i(n) == RT.log2i(n)
    for qp in range(0, 52):
        for off in range(-32, 32, 7):
            assert PT.qp_to_qlevel(qp, off) == RT.qp_to_qlevel(qp, off)


@pytest.mark.parametrize("name", [
    "_native/entropy.c", "_native/blockparse.c", "_native/thor_native.h",
    "bitstream.py", "frame.py", "io_y4m.py", "spec/__init__.py",
    "spec/inter.py", "spec/filters.py", "spec/tempinterp.py",
    "spec/intra.py", "spec/cfl.py", "spec/transform_quant.py",
    "dec/native_parse.py", "qmtx.py", "qm_tables.npz",
    "enc/params.py", "enc/writer.py", "_native/blockemit.c", "enc/me.py",
    "enc/rc.py"])
def test_copies_equal_thor_tpu(name):
    """The files the port copies verbatim are byte-equal to thor_tpu's
    (tables.py, the loader, decoder.py and cli.py differ by design and
    are held to thor_tpu by their behaviour)."""
    with open(os.path.join(REPO, "thor_tpu", name), "rb") as f:
        ref = f.read()
    with open(os.path.join(REPO, "thor_tpu_torch", name), "rb") as f:
        assert f.read() == ref


@pytest.mark.parametrize("name, n", [("make_tiny64", 6), ("make_c444", 4),
                                     ("make_hdb9", 9)])
def test_smoke_clips_equal_conftests(name, n):
    """chip_smoke.py's copies of the clip generators (it cannot import
    conftest.py, which imports jax) give conftest's bytes."""
    import chip_smoke
    import conftest
    assert getattr(chip_smoke, name)(n) == getattr(conftest, name)(n)


def test_no_message_names_item_11_but_11b():
    """What is left of ROADMAP.md item 11 is 11b (the wavefront device
    encoder); no message of the encoder or the CLI names item 11 else."""
    paths = [os.path.join(REPO, "thor_tpu_torch", "cli.py")]
    enc = os.path.join(REPO, "thor_tpu_torch", "enc")
    paths += [os.path.join(enc, n) for n in sorted(os.listdir(enc))
              if n.endswith(".py")]
    for path in paths:
        with open(path) as f:
            text = " ".join(f.read().split())
        for m in re.finditer(r"items? 11(\w*)", text):
            assert m.group(1) == "b", (path, text[m.start():m.end() + 20])
        assert "items 12 and 11" not in text, path


def test_native_library_is_the_ports_own(monkeypatch):
    """The loader takes no library path from the environment (thor_tpu's
    THOR_NATIVE_SO is ignored): it loads its own build."""
    monkeypatch.setenv("THOR_NATIVE_SO", os.path.join(REPO, "missing.so"))
    monkeypatch.setattr(PN, "_lib", None)
    assert PN.get_lib()._name == PN._SO
    assert os.path.dirname(PN._SO) == os.path.join(REPO, "build",
                                                   "thor_tpu_torch")


def test_native_build_failure_raises_with_the_compiler_output(
        tmp_path, monkeypatch):
    bad = tmp_path / "bad.c"
    bad.write_text("int parse_frame(void) { return }\n")
    monkeypatch.setattr(PN, "_SRCS", [str(bad)])
    monkeypatch.setattr(PN, "_SO", str(tmp_path / "lib.so"))
    monkeypatch.setattr(PN, "_lib", None)
    with pytest.raises(RuntimeError, match="bad.c") as e:
        PN.get_lib()
    assert "error" in str(e.value)
    assert not (tmp_path / "lib.so").exists()


def test_native_library_exports_the_turbo_passes():
    """The port's C library holds the turbo encoder's plan and emit passes
    (blockemit.c), bound with their argument mirrors."""
    lib = PN.get_lib()
    for name in ("plan_frame_turbo", "emit_frame_turbo", "write_coeff_scan",
                 "parse_frame"):
        assert hasattr(lib, name), name
    assert lib.plan_frame_turbo.argtypes[1]._type_ is PN.TurboPlan
    assert lib.emit_frame_turbo.argtypes[2]._type_ is PN.TurboEmit
    assert os.path.join(os.path.dirname(PN.__file__), "blockemit.c") in \
        PN._SRCS


def _plan_arrays(plan):
    if plan is None:
        return {}
    out = {f"ly.{k}": v for k, v in plan.ly.items()}
    out.update({f"ch.{k}": v for k, v in plan.ch.items()})
    out.update({f"coef.{k}": v for k, v in plan.coef.items()})
    out.update({f"qp4.{k}": v for k, v in plan.qp4.items()})
    out.update({f"ls4.{k}": v for k, v in plan.ls4.items()})
    out.update(avg=plan.avg, inter=plan.inter)
    return out


@pytest.mark.parametrize("name", ["tiny64_ldblc", "hbd12_128", "sync4_128"])
def test_native_parse_equals_thor_tpu(name, monkeypatch):
    """Each frame the port's decoder parses is parsed again, from the same
    state, by thor_tpu's native_parse (its own C library): the block and
    TB records, the coefficients, the deblock grids, the device plan, the
    bit position and the bit statistics must agree."""
    orig = PNP.parse_frame
    frames = []

    def both(dec, s, plan=None, ref_slots=None):
        rdec = copy.copy(dec)
        rdec.dd, rdec.fi, rdec.bc = (copy.deepcopy(x)
                                     for x in (dec.dd, dec.fi, dec.bc))
        rs, rplan = copy.copy(s), copy.deepcopy(plan)
        want = RNP.parse_frame(rdec, rs, rplan, ref_slots)
        got = orig(dec, s, plan, ref_slots)
        assert want is not None and got is not None
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        for k, v in vars(dec.dd).items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, getattr(rdec.dd, k), k)
        rp = _plan_arrays(rplan)
        for k, v in _plan_arrays(plan).items():
            np.testing.assert_array_equal(v, rp[k], k)
        assert (s.bitpos, s.bitcnt, dec.fi.qpb) == (rs.bitpos, rs.bitcnt,
                                                    rdec.fi.qpb)
        assert vars(dec.bc) == vars(rdec.bc)
        frames.append(len(got[0]))
        return got

    monkeypatch.setattr(PNP, "parse_frame", both)
    _, out = decode_stream(_read(name + ".bit"), device="cpu")
    assert len(frames) == len(out) and min(frames) > 0


def test_frame_the_native_parser_cannot_hold_is_refused(monkeypatch):
    """Where the native parser gives no records (it refuses a frame that
    its buffers cannot hold), the decoder walks the frame in Python, as
    thor_tpu's does: no frame is refused any more, and the output is the
    same."""
    monkeypatch.setattr(PNP, "parse_frame", lambda *a, **k: None)
    PD.ROUTE_FRAMES.update(dict.fromkeys(PD.ROUTE_FRAMES, 0))
    _, frames = decode_stream(_read("tiny64_ldblc.bit"), device="cpu")
    assert b"".join(frames) == _read("tiny64_ldblc_rec.yuv")
    assert PD.ROUTE_FRAMES["python_walk"] == len(frames) == 6


def test_decode_stream_defaults_to_cuda(monkeypatch):
    """With no device, decode_stream means the card, and raises where
    torch sees none instead of decoding on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert PD.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        decode_stream(_read("tiny64_ldblc.bit"))
    with pytest.raises(RuntimeError, match="sees none"):
        decode_stream(_read("tiny64_ldblc.bit"), device="cuda")


def test_cli_needs_a_card_or_thor_torch_device(tmp_path):
    """Without THOR_TORCH_DEVICE=cpu the CLI means the card; with none
    visible it exits non-zero, says why, and writes nothing."""
    out = tmp_path / "out.yuv"
    env = {k: v for k, v in os.environ.items() if k != "THOR_TORCH_DEVICE"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, "-m", "thor_tpu_torch.cli", "dec",
                        os.path.join(GOLDEN, "tiny64_ldblc.bit"), str(out)],
                       capture_output=True, text=True, cwd=REPO, env=env,
                       timeout=600)
    assert r.returncode == 1
    assert "THOR_TORCH_DEVICE=cpu" in r.stderr
    assert r.stdout == "" and not out.exists()
