"""Seeded 4:2:0 8-bit clips: a textured picture under a camera pan.

Each plane is a picture defined over the whole plane, sampled at the
frame's offset: a horizontal and a vertical ramp (the pattern of
bench.py's `stage_turbo_lc`) plus a spatially correlated texture, the
sum of sinusoids at fixed periods, each with an orientation and phase
drawn from the generator.  A frame t is the picture moved by t times
the pan, so the motion is fractional (quarter-pel in luma, eighth-pel in
chroma), new content enters at the edges, and motion-compensated
prediction needs the sub-pel filters and leaves a residual to code.  A
light grain, drawn anew for each frame, stands for sensor noise.

The traffic file fixes the sizes and amplitudes, the periods and the
pan's speed; the seed draws the ramps' ends, the orientations and
phases, the grain and the pan's direction.  So every seed gets the same
spectrum and the same speed of motion in another arrangement.
"""
from __future__ import annotations

import numpy as np


def _texture_parts(rng, periods, per_period, std, slope):
    """(fy, fx, phase, amplitude) of the texture's sinusoids: for each
    period `per_period` orientations drawn from the generator; the
    amplitudes grow as period**slope and give the texture `std`."""
    per = np.repeat(np.asarray(periods, np.float64), per_period)
    ang = rng.uniform(0.0, np.pi, per.size)
    phase = rng.uniform(0.0, 2 * np.pi, per.size)
    f = 2 * np.pi / per
    amp = per ** slope
    amp *= std / np.sqrt(0.5 * np.sum(amp * amp))
    return f * np.sin(ang), f * np.cos(ang), phase, amp


def _plane(parts, height, width, oy, ox, ramp):
    """The picture sampled at (y + oy, x + ox): the ramps (lo, hi, top,
    bottom) across the frame's own size plus the sum of the sinusoids,
    cos(ay + ax) = cos ay cos ax - sin ay sin ax as one product."""
    fy, fx, phase, amp = parts
    y = np.arange(height, dtype=np.float64) + oy
    x = np.arange(width, dtype=np.float64) + ox
    lo, hi, top, bottom = ramp
    ay = np.outer(y, fy) + phase
    ax = np.outer(fx, x)
    left = np.concatenate([amp * np.cos(ay), -amp * np.sin(ay)], axis=1)
    right = np.concatenate([np.cos(ax), np.sin(ax)], axis=0)
    return (left @ right
            + (lo + (hi - lo) * x / (width - 1))[None, :]
            + (top + (bottom - top) * y / (height - 1))[:, None])


def make_clip(rng: np.random.Generator, width: int, height: int,
              frames: int, content: dict) -> bytes:
    """One clip, frames of Y then U then V, from the content recipe:
    luma_ramp [lo, hi] and luma_ramp_jitter, vertical_ramp [top,
    bottom], chroma_mid [u, v] and chroma_ramp; texture_periods_px,
    orientations_per_period and texture_slope (amplitude grows as the
    period to this power); luma_texture_std and chroma_texture_std;
    luma_grain and chroma_grain (half-width of the uniform grain a
    frame); pan_px_per_frame (the speed, luma pixels a frame)."""
    c = content
    if width % 2 or height % 2:
        raise ValueError("4:2:0 clips need even sizes")
    j = int(c["luma_ramp_jitter"])
    lo = c["luma_ramp"][0] + int(rng.integers(-j, j + 1))
    hi = c["luma_ramp"][1] + int(rng.integers(-j, j + 1))
    if rng.integers(0, 2):
        lo, hi = hi, lo
    top, bottom = c["vertical_ramp"]
    periods = c["texture_periods_px"]
    n_or = int(c["orientations_per_period"])
    slope = float(c["texture_slope"])
    luma = (_texture_parts(rng, periods, n_or, c["luma_texture_std"], slope),
            (lo, hi, top, bottom))
    r = float(c["chroma_ramp"])
    chroma = []
    for mid in c["chroma_mid"]:
        sx, sy = rng.choice([-1.0, 1.0], 2)
        chroma.append((_texture_parts(rng, [p / 2 for p in periods], n_or,
                                      c["chroma_texture_std"], slope),
                       (mid - sx * r, mid + sx * r,
                        -sy * r / 2, sy * r / 2)))
    ang = rng.uniform(0.0, 2 * np.pi)
    speed = float(c["pan_px_per_frame"])
    # quarter-pel luma steps
    vy = np.rint(4 * speed * np.sin(ang)) / 4
    vx = np.rint(4 * speed * np.cos(ang)) / 4
    gy, gc = int(c["luma_grain"]), int(c["chroma_grain"])
    hc, wc = height // 2, width // 2
    out = []
    for t in range(frames):
        y = _plane(luma[0], height, width, t * vy, t * vx, luma[1])
        y += rng.integers(-gy, gy + 1, y.shape)
        out.append(np.clip(np.rint(y), 0, 255).astype(np.uint8).tobytes())
        for parts, ramp in chroma:
            p = _plane(parts, hc, wc, t * vy / 2, t * vx / 2, ramp)
            p += rng.integers(-gc, gc + 1, p.shape)
            out.append(np.clip(np.rint(p), 0, 255).astype(np.uint8)
                       .tobytes())
    return b"".join(out)
