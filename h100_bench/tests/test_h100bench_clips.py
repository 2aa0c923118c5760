"""The seeded clips: the same seed gives the same bytes, another seed
other bytes of the same size, and large seeds work; the picture pans at
the traffic's speed by a step no whole-pixel shift reproduces, and
every seed gets the same amount of texture."""
import json
import os

import numpy as np

from h100bench_util import BENCH_DIR
from harness.clips import make_clip

CONTENT = json.load(open(os.path.join(
    BENCH_DIR, "traffic", "clips_textured_motion.json")))["content"]


def clip(seed, w=64, h=48, n=3, content=CONTENT):
    return make_clip(np.random.default_rng(seed), w, h, n, content)


def luma(data, w, h, i):
    fs = w * h * 3 // 2
    a = np.frombuffer(data, np.uint8)
    return a[i * fs:i * fs + w * h].reshape(h, w).astype(np.int64)


def test_same_seed_same_bytes_other_seed_other_bytes():
    big = 2 ** 31 + 99
    assert clip(big) == clip(big)
    assert clip(big) != clip(big + 1)
    assert len(clip(big)) == 3 * 64 * 48 * 3 // 2


def test_a_fractional_pan_at_the_traffic_speed():
    w, h, m = 160, 128, 16
    quiet = dict(CONTENT, luma_grain=0, chroma_grain=0)
    speed = CONTENT["pan_px_per_frame"]
    fractional = 0
    for seed in range(5):
        data = clip(seed, w, h, 2, quiet)
        y0, y1 = luma(data, w, h, 0), luma(data, w, h, 1)
        err = {}
        for dy in range(-m + 1, m):
            for dx in range(-m + 1, m):
                # frame 1 at (y, x) shows the picture at (y + v)
                a = y1[m:h - m, m:w - m]
                b = y0[m + dy:h - m + dy, m + dx:w - m + dx]
                err[dy, dx] = np.abs(a - b).mean()
        (dy, dx), best = min(err.items(), key=lambda kv: kv[1])
        assert abs(np.hypot(dy, dx) - speed) <= 1.5
        assert best < 0.25 * np.mean(list(err.values()))
        fractional += best > 0.5
    assert fractional >= 3


def test_textured_chroma_and_the_same_texture_for_every_seed():
    w, h = 320, 192
    stds = []
    for seed in (1, 2, 3):
        data = clip(seed, w, h, 1)
        y = luma(data, w, h, 0).astype(np.float64)
        # texture about the ramps: remove each row's and column's mean
        t = y - y.mean(0)[None, :] - y.mean(1)[:, None] + y.mean()
        stds.append(t.std())
        u = np.frombuffer(data, np.uint8)[w * h:w * h + w * h // 4]
        assert u.std() > 1.0
    assert max(stds) < 1.2 * min(stds)
