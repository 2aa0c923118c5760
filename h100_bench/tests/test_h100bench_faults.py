"""A run on the CPU with the timed path broken underneath must come out
not correct, for each fault a cell can have; and a sound run correct.
The harness's look for a card is skipped (device="cpu").  The decode
cell runs on its 64x64 warm-up stream; the encode cell's decision
faults (harness/faults.py) run at the cell's own size, one clip a
window, where the configuration's limits hold, and the faults that
frames_wrong catches on 64x64 clips.  A cell on one card has no
exchange between chips to leave out."""
import pytest

from h100bench_util import (SEED, one_clip_encode_cell, tiny_decode_cell,
                            tiny_encode_cell)
from harness import faults, runner


def _first_frame_forever(frames):      # the state never advances
    return [frames[0]] * len(frames)


def _half(frames):                     # half of the batch left out
    return frames[:len(frames) // 2]


def _altered(frames):                  # one answer altered
    out = list(frames)
    b = bytearray(out[-1])
    b[len(b) // 3] ^= 0x10
    out[-1] = bytes(b)
    return out


DECODE_FAULTS = {"state_unchanged": _first_frame_forever, "half": _half,
                 "altered": _altered}


def run_decode(monkeypatch, fault=None):
    import thor_tpu_torch as T
    bench, cell = tiny_decode_cell()
    if fault is not None:
        orig = T.decode_stream

        def broken(data, *a, **k):
            hdr, frames = orig(data, *a, **k)
            if len(data) == len(state["data"]):    # not the warm-up
                frames = fault(frames)
            return hdr, frames
        state = {}
        monkeypatch.setattr(T, "decode_stream", broken)
        with open(cell.path(cell.config["input"]["stream"]), "rb") as f:
            state["data"] = f.read()
    return runner.run(bench, cell, SEED, 0.5, False, device="cpu")


def test_sound_decode_is_correct(monkeypatch):
    r = run_decode(monkeypatch)
    assert r["correct"] is True and r["failed"] == 0
    assert list(r["checks"]) == ["frames_wrong"]
    assert set(r["metrics"]) == {"decode_fps", "setup_s"}


@pytest.mark.parametrize("fault", sorted(DECODE_FAULTS))
def test_decode_fault_is_not_correct(monkeypatch, fault):
    r = run_decode(monkeypatch, DECODE_FAULTS[fault])
    assert r["correct"] is False and r["failed"] > 0


def _stream_altered(stream, recon, fsize):
    b = bytearray(stream)
    b[len(b) - 3] ^= 0x5A               # inside the last frame's unit
    return bytes(b), recon


def _recon_altered(stream, recon, fsize):
    b = bytearray(recon)
    b[fsize + 100] ^= 0x01
    return stream, bytes(b)


ALTERED = {"stream_altered": _stream_altered,
           "recon_altered": _recon_altered}


def run_encode(monkeypatch, cell_of, fault=None, half=False, planted=()):
    import thor_tpu_torch as T
    from harness.spans import patched
    bench, cell = cell_of()
    c = cell.config["codec"]
    fsize = c["width"] * c["height"] * 3 // 2
    n = c["frames_per_clip"]
    orig = T.encode_sequence

    def broken(params, yuv, *a, **k):
        if params.num_frames != n:        # the warm-up
            return orig(params, yuv, *a, **k)
        if half:
            params.num_frames = n // 2
            return orig(params, yuv[:fsize * (n // 2)], *a, **k)
        with patched(planted):
            out = orig(params, yuv, *a, **k)
        return fault(*out, fsize) if fault else out
    monkeypatch.setattr(T, "encode_sequence", broken)
    return runner.run(bench, cell, SEED, 0.5, False, device="cpu")


def test_sound_encode_is_correct(monkeypatch):
    r = run_encode(monkeypatch, one_clip_encode_cell)
    assert r["correct"] is True and r["failed"] == 0
    assert list(r["checks"]) == ["frames_wrong", "luma_mse",
                                 "bits_per_pixel", "clpf_off_frames"]
    assert set(r["metrics"]) == {"encode_fps", "setup_s"}


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_encode_decision_fault_is_not_correct(monkeypatch, fault):
    """The planted encoder writes a stream that decodes to its own
    reconstruction: frames_wrong reads 0 and a decision number fails."""
    r = run_encode(monkeypatch, one_clip_encode_cell,
                   planted=faults.FAULTS[fault])
    assert r["correct"] is False
    assert r["checks"]["frames_wrong"]["value"] == 0


@pytest.mark.parametrize("fault", sorted(ALTERED))
def test_encode_altered_is_not_correct(monkeypatch, fault):
    r = run_encode(monkeypatch, tiny_encode_cell, ALTERED[fault])
    assert r["correct"] is False and r["failed"] > 0


def test_encode_half_the_clip_is_not_correct(monkeypatch):
    r = run_encode(monkeypatch, tiny_encode_cell, half=True)
    assert r["correct"] is False
    # one frame of each two-frame clip is missing
    assert r["checks"]["frames_wrong"]["value"] == r["attempted"] // 2
