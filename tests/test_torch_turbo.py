"""thor_tpu_torch's turbo encoder as a whole against thor_tpu's, byte for
byte, on the CPU.

Five configurations of tests/test_turbo.py (its clips and parameters):
LC; HE with CDEF; the RA B-frame GOP with interp_ref=1 and bipred; qmtx;
10-bit + qmtx + tb-split HE with B frames.  A sixth, ra_ir2_cdef, is
the RA GOP with interp_ref=2 and CDEF on: turbo codes its I and P
frames and thor_tpu's exact host encoder its B frames (turbo rejects
interp_ref=2 B frames), so that both kinds of frame go through the CDEF
search of one stream.  Its stream and recon hash are held to thor_tpu's;
it has no decoder round trip (the reference's host RDO desynchronises
its own CDEF header there, docs/PARITY.md) and no Python walk.  For the
five others:
- the port's stream is byte-equal to thor_tpu's, kept in
  tests/torch_turbo/<name>.bit, and its recon hashes to thor_tpu's recon
  sha256 in tests/torch_turbo/fixtures.json;
- the port's decoder (on the CPU) decodes the stream to that recon;
- the Python plan walk and emitter (turbo_final.NATIVE = False) give the
  same bytes as the C passes.  That run takes the native run's decisions
  and interpolated frames as they were (the walks' inputs), so that it
  costs only the finalizer, the walks and the filter tail.
A live thor_tpu turbo encode takes minutes of XLA compile on the CPU, so
the fixtures are thor_tpu's outputs: the `slow` test re-encodes every
configuration with thor_tpu in a fresh interpreter
(test_turbo._turbo_encode_subprocess) and holds the files equal to it
(and test_torch_turbo_ops.py's stored outputs to thor_tpu's);
`python tests/test_torch_turbo.py` writes the streams.
"""
import contextlib
import copy
import hashlib
import io
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from conftest import make_c444, make_tiny64
from test_torch_encoder_golden import golden, golden_params
from test_turbo import LC_KW, _clip, _turbo_encode_subprocess
from thor_tpu_torch import decode_stream
from thor_tpu_torch.enc import encoder as PE
from thor_tpu_torch.enc import turbo as PT
from thor_tpu_torch.enc import turbo_final as PF
from thor_tpu_torch.enc.params import EncParams
from thor_tpu_torch.ops import tempinterp as PTI

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "torch_turbo")

RA_KW = dict(num_reorder_pics=7, interp_ref=1, enable_bipred=1, dqpB0=3,
             dqpB1=1, mqpB=1.2, mqpB0=1.1, mqpB1=1.2, mqpB2=1.3,
             intra_period=64, HQperiod=8)
CONFIGS = {   # name: (W, H, frames, seed, parameters over LC_KW)
    "lc": (128, 128, 2, 11, {}),
    "he_cdef": (128, 96, 2, 3, dict(
        early_skip_thr=0.3, enable_tb_split=1, enable_pb_split=1,
        max_num_ref=4, intra_rdo=1, enable_bipred=1, cdef=2, clpf=0,
        encoder_speed=0)),
    "ra_bframes": (128, 96, 10, 5, RA_KW),
    "qmtx": (128, 96, 4, 13, dict(qmtx=1, qmtx_offset=12)),
    "hbd10_qm_he": (128, 96, 4, 21, dict(
        RA_KW, enable_tb_split=1, intra_rdo=1, qmtx=1, qmtx_offset=12,
        bitdepth=10, encoder_speed=0)),
    "ra_ir2_cdef": (128, 96, 10, 5, dict(RA_KW, interp_ref=2, cdef=2)),
}
# the configurations every frame of which turbo codes
ALL_TURBO = [name for name in CONFIGS if name != "ra_ir2_cdef"]
FALLBACK = ("thor_tpu_torch: turbo unavailable for this frame (rejecting "
            "parameter: {}); falling back to the exact host encoder")


def _params(name, **over):
    W, H, N, _, kw = CONFIGS[name]
    args = dict(LC_KW)
    args.update(kw)
    args.update(over)
    return EncParams(width=W, height=H, num_frames=N, **args)


def _yuv(name):
    W, H, N, seed, _ = CONFIGS[name]
    return _clip(W, H, N, seed)


def _fixture(name):
    with open(os.path.join(FIXDIR, name + ".bit"), "rb") as f:
        bs = f.read()
    with open(os.path.join(FIXDIR, "fixtures.json")) as f:
        meta = json.load(f)[name]
    assert meta["stream_sha256"] == hashlib.sha256(bs).hexdigest()
    return bs, meta["rec_sha256"]


_NATIVE = {}   # name -> (stream, recon, decisions, interpolated frames,
#                        stderr, frame numbers turbo decided)


def _native_run(name):
    """The port's encode with the C passes (the default), on the CPU; the
    decisions and interpolated frames it used are kept for the Python
    walk's run, and what it printed on stderr."""
    if name in _NATIVE:
        return _NATIVE[name]
    decisions, interps, turbo_frames = [], [], []
    decide, interp = PT.decide_frame, PTI.interpolate_frames

    def keep_decision(enc):
        turbo_frames.append(enc.fi.frame_num)
        d = decide(enc)
        decisions.append(copy.deepcopy(d))
        return d

    def keep_interp(new, *args, **kw):
        interp(new, *args, **kw)
        interps.append(copy.deepcopy(new))

    err = io.StringIO()
    PT.decide_frame, PTI.interpolate_frames = keep_decision, keep_interp
    try:
        with contextlib.redirect_stderr(err):
            bs, rec = PE.encode_sequence(_params(name, turbo=1), _yuv(name),
                                         device="cpu")
    finally:
        PT.decide_frame, PTI.interpolate_frames = decide, interp
    _NATIVE[name] = (bs, rec, decisions, interps, err.getvalue(),
                     turbo_frames)
    return _NATIVE[name]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stream_equals_thor_tpu(name):
    bs, rec = _native_run(name)[:2]
    want, rec_sha = _fixture(name)
    assert len(bs) == len(want)
    assert bs == want
    assert hashlib.sha256(rec).hexdigest() == rec_sha


@pytest.mark.parametrize("name", ALL_TURBO)
def test_decoder_reproduces_the_recon(name):
    bs, rec_sha = _fixture(name)
    _, frames = decode_stream(bs, device="cpu")
    assert hashlib.sha256(b"".join(frames)).hexdigest() == rec_sha
    assert b"".join(frames) == _native_run(name)[1]


@pytest.mark.parametrize("name", ALL_TURBO)
def test_python_walk_equals_native(name, monkeypatch):
    """The twin of tests/test_turbo.py:test_turbo_native_emit_matches_python:
    plan_frame + emit_nodes give the bytes of the C plan/emit passes."""
    bs_c, rec_c, decisions, interps = _native_run(name)[:4]
    decisions, interps = list(decisions), list(interps)
    walks = []

    def plan_frame(enc, dec):
        walks.append(enc.fi.frame_num)
        return plan(enc, dec)

    def interp(new, *args, **kw):
        src = interps.pop(0)
        for a in ("y_full", "u_full", "v_full"):
            getattr(new, a)[:] = getattr(src, a)

    plan = PF.plan_frame
    monkeypatch.setattr(PF, "NATIVE", False)
    monkeypatch.setattr(PF, "plan_frame", plan_frame)
    monkeypatch.setattr(PT, "decide_frame", lambda enc: decisions.pop(0))
    monkeypatch.setattr(PTI, "interpolate_frames", interp)
    bs_py, rec_py = PE.encode_sequence(_params(name, turbo=1), _yuv(name),
                                       device="cpu")
    assert len(walks) == CONFIGS[name][2]
    assert not decisions and not interps
    assert bs_py == bs_c
    assert rec_py == rec_c


# ------------------------------------------------------------ refusals

@pytest.mark.parametrize("over, exc, match", [
    (dict(turbo=1, device_enc=1), NotImplementedError, "item 11b"),
])
def test_unsupported_parameters_raise(over, exc, match):
    p = _params("lc", **over)
    with pytest.raises(exc, match=match):
        PE.encode_sequence(p, _yuv("lc"), device="cpu")


# ------------------------------------------------------------ fallbacks

@pytest.mark.parametrize("name, clip, over, reason", [
    ("c444_128", make_c444, dict(subsample=444), "subsample!=420"),
    ("tiny64_rc", make_tiny64, dict(bitrate=200000),
     "bitrate (rate control)"),
])
def test_turbo_rejects_fall_back_to_host_rdo(name, clip, over, reason,
                                             capsys):
    """With turbo=1, every frame of a configuration that turbo does not
    support takes the exact host encoder: the stream and recon are the
    reference's golden, and the fallback is said once on stderr."""
    ref, rr = golden(name)
    w, h, n = {"c444_128": (128, 96, 4), "tiny64_rc": (64, 64, 6)}[name]
    bits, recon = PE.encode_sequence(golden_params(w, h, n, turbo=1, **over),
                                     clip(n), device="cpu")
    assert bits == ref
    assert recon == rr
    assert capsys.readouterr().err.count(FALLBACK.format(reason)) == 1


def test_interp_ref2_b_frames_fall_back():
    """ra_ir2_cdef with turbo=1: turbo codes the I and P frames, the exact
    host encoder the interp_ref=2 B frames (test_stream_equals_thor_tpu
    holds the stream to thor_tpu's), and the fallback is said once."""
    _, _, _, _, err, turbo_frames = _native_run("ra_ir2_cdef")
    assert turbo_frames == [0, 8, 9]
    assert err.count(FALLBACK.format("interp_ref=2 (B frames)")) == 1
    assert err.count("thor_tpu_torch: turbo unavailable") == 1


def test_encode_sequence_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="sees none"):
        PE.encode_sequence(_params("lc", turbo=1), _yuv("lc"))


# ------------------------------------------------------------ the CLI

def _cli(tmp_path, args, device="cpu"):
    # one torch thread, as in this process (a pool of one thread per core
    # spins beside other test processes)
    env = {k: v for k, v in os.environ.items() if k != "THOR_TORCH_DEVICE"}
    env["OMP_NUM_THREADS"] = "1"
    if device:
        env["THOR_TORCH_DEVICE"] = device
    else:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "-m", "thor_tpu_torch.cli",
                           "enc"] + args, capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=600)


def test_cli_enc_writes_thor_tpus_stream(tmp_path):
    W, H, N, _, _ = CONFIGS["lc"]
    src = tmp_path / "in.yuv"
    src.write_bytes(_yuv("lc"))
    flags = []
    for k, v in LC_KW.items():
        flags += ["-" + k, str(v)]
    args = (["-if", str(src), "-of", str(tmp_path / "out.bit"), "-rf",
             str(tmp_path / "rec.yuv"), "-width", str(W), "-height", str(H),
             "-n", str(N), "-turbo", "1"] + flags)
    r = _cli(tmp_path, args)
    assert r.returncode == 0, r.stderr
    want, rec_sha = _fixture("lc")
    assert (tmp_path / "out.bit").read_bytes() == want
    assert hashlib.sha256((tmp_path / "rec.yuv").read_bytes()).hexdigest() \
        == rec_sha
    lines = r.stdout.splitlines()
    assert lines[0].startswith("SH:")
    assert [ln.split()[:3] for ln in lines[1:1 + N]] == \
        [["0", "I", "30"], ["1", "P", "38"]]
    assert "PSNR Y" in r.stdout and "kbps" in r.stdout
    # without -turbo 1: the exact host encoder, here with the golden
    # config file on tiny64_ldblc's clip, writes the reference's golden
    gold = tmp_path / "tiny64.yuv"
    gold.write_bytes(make_tiny64(6))
    cfg = os.path.join(REPO, "tests", "golden",
                       "config_LDB_low_complexity.txt")
    exact = ["-cf", cfg, "-if", str(gold), "-of", str(tmp_path / "g.bit"),
             "-rf", str(tmp_path / "g_rec.yuv"), "-width", "64", "-height",
             "64", "-n", "6", "-qp", "32", "-f", "30"]
    r = _cli(tmp_path, exact)
    assert r.returncode == 0, r.stderr
    ref, rr = golden("tiny64_ldblc")
    assert (tmp_path / "g.bit").read_bytes() == ref
    assert (tmp_path / "g_rec.yuv").read_bytes() == rr
    # the wavefront device encoder is not ported
    r = _cli(tmp_path, args + ["-device_enc", "1"])
    assert r.returncode == 1 and "item 11b" in r.stderr
    # without a card and without THOR_TORCH_DEVICE=cpu: no encode
    r = _cli(tmp_path, args, device=None)
    assert r.returncode == 1 and "THOR_TORCH_DEVICE=cpu" in r.stderr


# ------------------------------------------------------------ provenance

def _thor_tpu_encode(name):
    W, H, N, seed, kw = CONFIGS[name]
    _, bs, rec = _turbo_encode_subprocess(W, H, N, seed, **kw)
    return bs, rec


def _thor_tpu_fixtures():
    """Every configuration encoded by thor_tpu, each in its own fresh
    interpreter (in parallel)."""
    with ThreadPoolExecutor(len(CONFIGS)) as ex:
        outs = dict(zip(CONFIGS, ex.map(_thor_tpu_encode, CONFIGS)))
    return outs


@pytest.mark.slow
def test_fixtures_are_thor_tpus():
    """Every file in tests/torch_turbo is thor_tpu's output: the five
    streams and recon hashes, and test_torch_turbo_ops.py's stored
    outputs."""
    for name, (bs, rec) in _thor_tpu_fixtures().items():
        want, rec_sha = _fixture(name)
        assert bs == want, name
        assert hashlib.sha256(rec).hexdigest() == rec_sha, name
    import test_torch_turbo_ops
    test_torch_turbo_ops.check_stored_outputs()


def test_encodes_without_jax():
    """A process where `import jax` fails encodes, through
    encode_sequence, the LC configuration with turbo to thor_tpu's stream
    and tiny64_ldblc with the exact host encoder (turbo=0, its clip from
    chip_smoke.py's copy of the generator) to the reference's golden, and
    never loads jax nor anything of thor_tpu."""
    code = (
        "import sys, hashlib\n"
        "sys.modules['jax'] = None\n"
        "sys.path.insert(0, 'tests')\n"
        "import numpy as np\n"
        "from thor_tpu_torch import encode_sequence\n"
        "from thor_tpu_torch.enc.params import EncParams, "
        "parse_config_file\n"
        "from chip_smoke import make_tiny64\n"
        "rng = np.random.default_rng(11)\n"
        "base = np.clip(np.linspace(30, 200, 128)[None, :] + "
        "np.linspace(0, 50, 128)[:, None] + rng.integers(-10, 10, "
        "(128, 128)), 0, 255).astype(np.uint8)\n"
        "out = []\n"
        "for i in range(2):\n"
        "    f = np.roll(base, i * 3, axis=1)\n"
        "    if i:\n"
        "        f = np.clip(f.astype(np.int16) + rng.integers(-2, 3, "
        "(128, 128)), 0, 255).astype(np.uint8)\n"
        "    u = np.clip(128 + rng.integers(-8, 8, (64, 64)), 0, 255)"
        ".astype(np.uint8)\n"
        "    v = np.clip(128 + rng.integers(-8, 8, (64, 64)), 0, 255)"
        ".astype(np.uint8)\n"
        "    out.append(f.tobytes() + u.tobytes() + v.tobytes())\n"
        f"p = EncParams(width=128, height=128, num_frames=2, turbo=1, "
        f"**{LC_KW!r})\n"
        "bs, rec = encode_sequence(p, b''.join(out), device='cpu')\n"
        "p = parse_config_file('tests/golden/config_LDB_low_complexity.txt'"
        ", width=64, height=64, num_frames=6, qp=32, frame_rate=30.0)\n"
        "assert p.turbo == 0\n"
        "gs, grec = encode_sequence(p, make_tiny64(6), device='cpu')\n"
        "bad = [m for m in sys.modules if m == 'thor_tpu' or "
        "m.startswith(('thor_tpu.', 'jax.'))]\n"
        "print(hashlib.sha256(bs).hexdigest(), hashlib.sha256(gs)"
        ".hexdigest(), hashlib.sha256(grec).hexdigest(), bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=600)
    assert r.returncode == 0, r.stderr
    want, _ = _fixture("lc")
    gs, grec = golden("tiny64_ldblc")
    assert r.stdout.split() == [hashlib.sha256(x).hexdigest()
                                for x in (want, gs, grec)] + ["[]"]


if __name__ == "__main__":
    meta = {}
    for name, (bs, rec) in _thor_tpu_fixtures().items():
        with open(os.path.join(FIXDIR, name + ".bit"), "wb") as f:
            f.write(bs)
        meta[name] = {"stream_sha256": hashlib.sha256(bs).hexdigest(),
                      "rec_sha256": hashlib.sha256(rec).hexdigest(),
                      "bytes": len(bs)}
    with open(os.path.join(FIXDIR, "fixtures.json"), "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps(meta, indent=1, sort_keys=True))
