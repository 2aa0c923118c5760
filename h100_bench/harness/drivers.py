"""The drivers: how a traffic mix drives the port, by its `driver` key.

`decode`: a closed loop of whole streams through
`thor_tpu_torch.decode_stream(data)` (one stream a unit) or, with
`streams` above 1, `decode_streams_sharded([data] * streams)` (one
lockstep set a unit).  `encode`: a closed loop of whole clips through
`thor_tpu_torch.encode_sequence(params, clip)`, the parameters from the
configuration's preset file with its overrides, the clips from the seed.
A driver imports the port in `setup`, never when imported, and calls the
port's entry points through the package at call time.
"""
from __future__ import annotations

import copy
import hashlib
from dataclasses import dataclass

import numpy as np

from . import judge
from .clips import make_clip


@dataclass
class Unit:
    frames: int        # frames the unit asked for
    outputs: object    # what the port returned, judged after the window


def read_checked(cell, rel, want_sha256):
    with open(cell.path(rel), "rb") as f:
        data = f.read()
    got = hashlib.sha256(data).hexdigest()
    if got != want_sha256:
        raise RuntimeError(f"{rel}: sha256 {got}, the configuration "
                           f"states {want_sha256}")
    return data


class DecodeDriver:
    entry = "decode_stream"

    def __init__(self, cell, seed, device=None):
        self.cell = cell
        self.device = device
        self.streams = int(cell.traffic.get("streams", 1))
        # the input is one fixed stream: the seed changes no byte of it

    def setup(self):
        inp = self.cell.config["input"]
        self.data = read_checked(self.cell, inp["stream"],
                                 inp["stream_sha256"])
        warm = read_checked(self.cell, inp["warmup_stream"],
                            inp["warmup_stream_sha256"])
        self._decode(warm)

    def _decode(self, data):
        import thor_tpu_torch as T
        if self.streams == 1:
            return [T.decode_stream(data, device=self.device)[1]]
        return T.decode_streams_sharded([data] * self.streams,
                                        device=self.device)

    def run_unit(self, i):
        out = self._decode(self.data)
        n = self.cell.config["codec"]["frames_per_stream"] * self.streams
        return Unit(n, out)

    def release(self):
        self.data = None

    def numbers(self, units):
        return judge.decode_numbers(
            [s for u in units for s in u.outputs],
            self.cell.config["codec"]["frames_per_stream"],
            self.cell.config["input"]["c_oracle_output_sha256"]), []


class EncodeDriver:
    entry = "encode_sequence"

    def __init__(self, cell, seed, device=None):
        self.cell = cell
        self.device = device
        self.seed = seed
        self.codec = cell.config["codec"]

    def _params(self, frames):
        from thor_tpu_torch.enc.params import parse_config_file
        c = self.codec
        return parse_config_file(
            self.cell.path(c["preset"]), width=c["width"],
            height=c["height"], num_frames=frames, qp=c["qp"],
            frame_rate=c["frame_rate"], **c.get("overrides", {}))

    def setup(self):
        c, t = self.codec, self.cell.traffic
        rng = np.random.default_rng(self.seed)
        self.clips = [make_clip(rng, c["width"], c["height"],
                                c["frames_per_clip"], t["content"])
                      for _ in range(int(t["clips_in_pool"]))]
        self.params = self._params(c["frames_per_clip"])
        n = int(t["warmup_frames"])
        fsize = c["width"] * c["height"] * 3 // 2
        self._encode(self._params(n), self.clips[0][:n * fsize])

    def _encode(self, params, clip):
        import thor_tpu_torch as T
        return T.encode_sequence(params, clip, device=self.device)

    def run_unit(self, i):
        k = i % len(self.clips)
        # encode_sequence may change the parameters it is given
        stream, recon = self._encode(copy.deepcopy(self.params),
                                     self.clips[k])
        return Unit(self.codec["frames_per_clip"], (k, stream, recon))

    def release(self):
        self.params = None

    def jobs(self, units, recon_from_reference=False):
        c = self.codec
        return [(stream, recon, self.clips[k], c["width"], c["height"],
                 c["frames_per_clip"], recon_from_reference)
                for k, stream, recon in (u.outputs for u in units)]

    def numbers(self, units):
        return judge.encode_numbers(self.jobs(units))


DRIVERS = {"decode": DecodeDriver, "encode": EncodeDriver}


def make(cell, seed, device=None, **kw):
    return DRIVERS[cell.traffic["driver"]](cell, seed, device, **kw)
