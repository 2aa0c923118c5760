#!/usr/bin/env python3
"""Smoke run of thor_tpu_torch on one NVIDIA GPU (built for Hopper, sm_90a).

    python3 chip_smoke.py
    python3 chip_smoke.py --time-mc DIR
    python3 chip_smoke.py --profile-tempinterp

With no arguments it runs the phases below; any failure raises and the
exit code is non-zero:
  0. setup: require CUDA, print the card's name and power limit, build
     the CUDA kernels from thor_tpu_torch/csrc (nvcc, sm_90a);
  1. each kernel against its plain torch version on the card at the 1080p
     main path's shapes (130,560 cells over a ring stack of 2 references)
     on random cells (1 in 64 with wild origins and indices), bit depths
     8 and 10, both filter sets: the maximum difference must be 0 (the
     codec is integer: tolerance 0);
  2. golden streams through the port's decode_stream on the card, each
     byte-equal to its reference YUV, with the frames each route of the
     decoder took (fused / two-stage / host records);
  3. the main path: the 8-frame 1080p LDB-LC bench stream, whose output
     must hash to BENCH_REC_SHA256, with the MC kernels' launch counts
     and the frame decoder's run count taken over that decode alone (it
     must launch the luma and the U+V kernel); the cells that pixel_core
     receives for frame 1 are kept;
  4. each kernel against its plain version on frame 1's cells (bit
     depths 8 and 10), then both timed on the real and the random cells
     at 8 bits, beside the bound: the bytes the function must move (each
     metadata array read once, each output written once, and the
     distinct reference samples the cells' ops need) at 3.35 TB/s;
  5. the tile pipeline (models/pipeline.py) on the card:
     decode_p_frame_420 on a 1080p example (8,160 tiles: the luma and the
     U+V kernel) and on entry()'s CIF example (396 tiles: the luma kernel
     and the one-plane chroma kernel once per plane), and
     decode_inter_frame_16 at 1080p, each equal to the same function on
     the CPU (the plain versions) on the same inputs; launch counts taken
     over these three calls alone; then the three kernels against their
     plain versions on the cells those tiles expand into, and timed there;
  6. temporal interpolation at 1080p: frames 6 and 7 of phase 3's decode
     as the two references, interpolate_frames at (ratio, pos) (2, 1) and
     (4, 1) on the card, equal to the same call on the CPU;
  7. the unfused routes at full width: the bench stream again with
     fused=False, so that its I frame takes the host records and its P
     frames the two-stage executor (frame_exec at 1920x1088: the luma
     kernel once and the one-plane chroma kernel twice a frame), every
     frame the unfused loop filters (filters_exec).  All eight frames are
     decoded and the output must hash to BENCH_REC_SHA256; seconds per
     frame stand beside phase 3's, with the seconds inside execute and
     filters_exec (synchronised on both sides) and the launch counts over
     this decode alone.  The one-plane chroma kernel is then held against
     its plain version on the arguments frame 1's two calls gave it,
     which must be phase 4's frame-1 cells.
The kernels' times are device times: the launches queue behind a sleeping
kernel, so the events time the card's work and not the Python that issues
it (`call_ms`, one call timed alone, includes that; `kernel_ms` is the
kernel alone in torch.profiler's trace, without the gap between queued
launches).  The second-to-last line is a JSON object with the kernels'
results, the last line {"ok": true, "device": {...}}.

`--time-mc DIR` times the MC wrappers of the checkout at DIR instead (see
`time_mc`), for an A/B of two checkouts on one card.
`--profile-tempinterp` traces one 1080p temporal interpolation with
torch.profiler instead (see `profile_tempinterp`).
"""
import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDENS = ("tiny64_ldblc", "noise_cif_ldblc", "smooth_cif_ldblc",
           "small256_LDB_medium_complexity",
           # B frames over a temporally interpolated reference
           "hdb9_128", "ir2_128", "ra9_256", "s17_RA_medium_complexity",
           "s17_HDB16_low_complexity",
           # weighted dequantization (qmtx)
           "small256_LDB_qm_medium_complexity",
           # frames off the fused route: 4:4:4 (host records), tb-split
           # intra (two-stage; with qmtx, host records)
           "c444_128", "s17_hbd10", "small256_LDB_high_efficiency",
           "he2_256")
# the 8-frame 1920x1088 LDB low-complexity stream that bench.py decodes,
# and the sha256 of its reference decode (tests/test_torch_decode.py holds
# both equal to bench.py's)
BENCH_STREAM = os.path.join(REPO, "benchmarks", "stream_1080p_lc.bit")
BENCH_REC_SHA256 = ("287b83855649b54ea8deb70db12cb222"
                    "f16561eb25150ecdb1217823111425ef")
H1080, W1080 = 1088, 1920
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 rate
# int32 multiply-adds run outside the tensor cores: the H100 SXM float32
# rate outside them, 67 T/s, stands for their peak
OPS_PER_S = 67e12
SRC = "thor_tpu_torch/csrc/"
KERNELS = {   # name: (source, the Pallas call it replaces, launch counter
    #                in ops/mc.py, the launches each driven path must make:
    #                the two bench decodes at least (none where 0), the
    #                tile pipeline exactly)
    "mc_luma_cells": (SRC + "mc_luma.cu", "thor_tpu/ops/mc_pallas.py:164",
                      "LUMA_LAUNCHES", {"bench_decode": 1,
                                        "tile_pipeline": 3,
                                        "unfused_decode": 1}),
    "mc_chroma_uv_cells": (SRC + "mc_chroma.cu",
                           "thor_tpu/ops/mc_pallas.py:385",
                           "CHROMA_UV_LAUNCHES", {"bench_decode": 1,
                                                  "tile_pipeline": 1,
                                                  "unfused_decode": 0}),
    # the one-plane case of thor_mc_chroma_cells: the two-stage executor
    # calls it once per plane and list; the tile pipeline takes it when
    # the tile count is no multiple of 16 (CIF: 396)
    "mc_chroma_cells": (SRC + "mc_chroma.cu",
                        "thor_tpu/ops/mc_pallas.py:274", "CHROMA_LAUNCHES",
                        {"bench_decode": 0, "tile_pipeline": 2,
                         "unfused_decode": 1}),
}


def reset_launches(MC):
    for _, _, counter, _ in KERNELS.values():
        setattr(MC, counter, 0)


def read_launches(MC):
    return {name: getattr(MC, counter)
            for name, (_, _, counter, _) in KERNELS.items()}


def check_launches(launches, path):
    """A bench decode must launch each kernel its route runs, and none of
    the others."""
    for name, (_, _, _, need) in KERNELS.items():
        if (launches[name] > 0) != (need[path] > 0):
            raise AssertionError(
                f"kernel {name}: {launches[name]} launches on the {path} "
                f"path, expected {'some' if need[path] else 'none'}")


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def call_ms(fn, reps=15, warmup=3):
    """Median milliseconds of one fn() between two CUDA events, the
    host's time to issue it included."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps=20, rounds=3):
    """Device milliseconds per fn(): `reps` calls queue behind a sleeping
    kernel, so the events around them time the card alone; median of
    `rounds`.  A round whose calls took longer to issue than the sleep
    lasted is run again with a longer sleep."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    issue = time.perf_counter() - t0
    torch.cuda.synchronize()
    # twice the issue time of the calls, and 20 ms, at up to 2e9 cycles/s
    cycles = int((2 * reps * issue + 0.02) * 2e9)
    times = []
    tries = 0
    while len(times) < rounds:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        s0 = torch.cuda.Event(enable_timing=True)
        s0.record()
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = time.perf_counter() - t0
        b.record()
        b.synchronize()
        slept = s0.elapsed_time(a)
        if host * 1e3 < slept:
            times.append(a.elapsed_time(b) / reps)
            continue
        tries += 1
        if tries > 5:
            raise RuntimeError(f"issuing {reps} calls took {host:.4f} s, "
                               f"longer than the sleep in front of them")
        cycles = int(cycles * 2 * host * 1e3 / slept)
    return statistics.median(times)


def profiled_ms(fn, reps=10, tries=3):
    """Mean duration of the MC kernel in fn() as torch.profiler's CUDA
    trace records it: the kernel alone, without the launch gaps that
    device_ms includes.  The trace sometimes comes back without the
    kernel; after `tries` such traces the time is None (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if "mc_cells_kernel" in e.key]
        if ev:
            return (sum(e.device_time_total for e in ev) /
                    sum(e.count for e in ev) / 1e3)
    return None


def main_path_cells(gen, H, W, cs, pad, luma, device):
    """Random cell metadata of one 1080p frame at the main path's shapes:
    one cell per 4x4 luma block, origins within the MV clip range, and 1
    in 64 cells with wild origins and table indices, which the kernels
    must clamp exactly as JAX's gather does."""
    import torch
    n = (H // 4) * (W // 4)
    h, w = (H, W) if luma else (H // 2, W // 2)
    ext = 144 if luma else 72

    def ri(lo, hi):
        return torch.randint(lo, hi, (n,), generator=gen, dtype=torch.int32)

    gy = torch.arange(n, dtype=torch.int32) // (W // 4) * cs
    gx = torch.arange(n, dtype=torch.int32) % (W // 4) * cs
    y0 = (gy + ri(-64, 65)).clamp(-ext, h + ext - cs) + pad
    x0 = (gx + ri(-64, 65)).clamp(-ext, w + ext - cs) + pad
    c = {"rsel": ri(0, 2), "y0": y0, "x0": x0, "op": ri(0, 4),
         "vf": ri(0, 4 if luma else 8), "hf": ri(0, 4 if luma else 8)}
    if luma:
        c["fs"] = ri(0, 2)
    wild = ri(0, 64) == 0
    for k in c:
        c[k] = torch.where(wild, ri(-3000, 3000), c[k])
    return {k: v.to(device).contiguous() for k, v in c.items()}


def _jidx(i, n):
    import torch
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def needed_samples(stack, cells, luma):
    """Distinct reference samples the cells' ops read: a six-tap (or 4-tap)
    cell the rows and columns its fractions' nonzero taps reach, a copy
    cell its cs x cs centre, a lowpass cell the 7x7 square around it."""
    import torch
    from thor_tpu_torch import tables as T
    R, Hp, Wp = stack.shape
    cs, taps = (4, 6) if luma else (2, 4)
    w, back = cs + taps - 1, taps // 2 - 1
    dev = stack.device
    n = cells["y0"].shape[0]
    op = cells["op"].long()
    if luma:
        bank = torch.as_tensor(T.LUMA_BANK, device=dev)
        fset = _jidx(cells["fs"].long(), 2)
        fv = bank[fset, _jidx(cells["vf"].long(), 4)]
        fh = bank[fset, _jidx(cells["hf"].long(), 4)]
    else:
        bank = torch.as_tensor(T.CHROMA_BANK, device=dev)
        fv = bank[_jidx(cells["vf"].long(), 8)]
        fh = bank[_jidx(cells["hf"].long(), 8)]
    d = torch.arange(w, device=dev)

    def reach(f):   # [n, w]: window lines some output line's taps read
        m = torch.zeros((n, w), dtype=torch.bool, device=dev)
        for i in range(cs):
            m[:, i:i + taps] |= f != 0
        return m

    filt = reach(fv)[:, :, None] & reach(fh)[:, None, :]
    centre = ((d >= back) & (d < back + cs))
    copy = (centre[:, None] & centre[None, :]).expand(n, w, w)
    mask = torch.where((op == 1)[:, None, None], copy, filt)
    if luma:
        lp = torch.zeros((w, w), dtype=torch.bool, device=dev)
        k = torch.as_tensor(T.LOWPASS_K != 0, device=dev)
        for i in range(cs):
            for j in range(cs):
                lp[1 + i:5 + i, 1 + j:5 + j] |= k
        mask = torch.where((op == 3)[:, None, None], lp.expand(n, w, w), mask)
    r = _jidx(cells["rsel"].long(), R)
    yy = _jidx(cells["y0"].long()[:, None] - back + d, Hp)
    xx = _jidx(cells["x0"].long()[:, None] - back + d, Wp)
    flat = (r[:, None, None] * Hp + yy[:, :, None]) * Wp + xx[:, None, :]
    return int(torch.unique(flat[mask]).numel())


def filter_ops(cells, luma):
    """Multiply-adds of the separable filters on these cells (x2 ops)."""
    op = cells["op"]
    if luma:
        six = int(((op != 1) & (op != 3)).sum())
        lp = int((op == 3).sum())
        return 2 * (six * (9 * 4 * 6 + 16 * 6) + lp * 16 * 12)
    filt = int((op != 1).sum())
    return 2 * filt * (5 * 2 * 4 + 4 * 4)


def bound(cells, stack, luma, planes):
    """(bytes, bound in ms, bound_by) of one call on these cells."""
    n = cells["y0"].shape[0]
    cs = 4 if luma else 2
    meta = len(cells) * 4 * n
    out = n * cs * cs * 4 * planes
    ref = 2 * planes * needed_samples(stack, cells, luma)
    nbytes = meta + out + ref
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = planes * filter_ops(cells, luma) / OPS_PER_S * 1e3
    return nbytes, max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                         else "operations")


def kernel_calls(MC, ys, us, vs, lc, cc, bd):
    largs = (lc["rsel"], lc["y0"], lc["x0"], lc["op"], lc["vf"], lc["hf"],
             lc["fs"], 4, bd)
    cargs = (cc["rsel"], cc["y0"], cc["x0"], cc["op"], cc["vf"], cc["hf"],
             2, bd)
    return {
        "mc_luma_cells": (lambda: MC.mc_cells_luma(ys, *largs),
                          lambda: MC.mc_cells_luma_plain(ys, *largs)),
        "mc_chroma_uv_cells": (
            lambda: MC.mc_cells_chroma_uv(us, vs, *cargs),
            lambda: tuple(MC.mc_cells_chroma_plain(s, *cargs)
                          for s in (us, vs))),
        "mc_chroma_cells": (lambda: MC.mc_cells_chroma(vs, *cargs),
                            lambda: MC.mc_cells_chroma_plain(vs, *cargs)),
    }


def max_err(got, want):
    import torch
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    return max(int((g - w).abs().max()) for g, w in zip(got, want))


def check_and_time(MC, device, what, ys, us, vs, lc, cc, bd, timed, card):
    """Each kernel against its plain version on one cell set; at `timed`
    also the times, bytes, bound and share."""
    import torch
    calls = kernel_calls(MC, ys, us, vs, lc, cc, bd)
    res = {}
    for name, (k, p) in calls.items():
        got = k()
        torch.cuda.synchronize()
        err = max_err(got, p())
        r = res[name] = {"max_abs_err": err}
        print(f"phase {what}: {name} bd {bd}: max_abs_err {err}", flush=True)
        if err != 0:
            raise AssertionError(f"{name} kernel disagrees with its plain "
                                 f"version on the {what} cells at bd {bd}")
        if not timed:
            continue
        luma = name == "mc_luma_cells"
        planes = 2 if name == "mc_chroma_uv_cells" else 1
        # plain, kernel, kernel, plain; the plain versions launch tens of
        # kernels each, and the card queues about a thousand launches
        # before the host has to wait, so fewer of them queue
        p1, k1 = device_ms(p, reps=4), device_ms(k)
        k2, p2 = device_ms(k), device_ms(p, reps=4)
        nbytes, b_ms, by = bound(lc if luma else cc,
                                 ys if luma else us, luma, planes)
        # a yardstick of what moving that many bytes takes in practice: a
        # device copy that reads half of them and writes the other half
        src = torch.empty(nbytes // 2, dtype=torch.uint8, device=device)
        dst = torch.empty_like(src)
        r.update(ms=min(k1, k2), plain_ms=min(p1, p2), call_ms=call_ms(k),
                 kernel_ms=profiled_ms(k), bytes=nbytes, bound_ms=b_ms,
                 bound_by=by, share=b_ms / min(k1, k2),
                 copy_ms=device_ms(lambda: dst.copy_(src)))
        traced = ("not measured" if r["kernel_ms"] is None
                  else f"{r['kernel_ms']:.6f} ms")
        print(f"phase {what}: {name}: kernel {r['ms']:.6f} ms (in the "
              f"profiler's trace {traced}; one call "
              f"with its issue {r['call_ms']:.4f} ms), plain "
              f"{r['plain_ms']:.4f} ms; {nbytes} bytes, bound "
              f"{b_ms * 1e3:.3f} us ({by}), share {r['share']:.3f}; a "
              f"device copy of as many bytes {r['copy_ms']:.6f} ms; "
              f"card {card}",
              flush=True)
    return res


def random_planes(gen, bd, pad, device):
    import torch
    ys = torch.randint(0, 1 << bd, (2, H1080 + 2 * pad, W1080 + 2 * pad),
                       generator=gen, dtype=torch.int16).to(device)
    us, vs = (torch.randint(0, 1 << bd, (2, H1080 // 2 + pad,
                                         W1080 // 2 + pad),
                            generator=gen, dtype=torch.int16).to(device)
              for _ in range(2))
    return ys, us, vs


def phase_kernels(device, card):
    """Phase 1: every kernel against its plain version on random cells."""
    import torch
    from thor_tpu_torch.ops import mc as MC
    gen = torch.Generator().manual_seed(2026)
    pad = 160
    kept = {}
    for bd in (8, 10):
        ys, us, vs = random_planes(gen, bd, pad, device)
        lc = main_path_cells(gen, H1080, W1080, 4, pad, True, device)
        cc = main_path_cells(gen, H1080, W1080, 2, pad // 2, False, device)
        check_and_time(MC, device, "1 random", ys, us, vs, lc, cc, bd, False,
                       card)
        if bd == 8:
            kept = {"planes": (ys, us, vs), "lc": lc, "cc": cc}
    return kept


def phase_goldens(device):
    """Phase 2: the goldens through the port, byte for byte."""
    from thor_tpu_torch import decode_stream
    from thor_tpu_torch.dec import decoder as PD
    for name in GOLDENS:
        base = os.path.join(REPO, "tests", "golden", name)
        with open(base + ".bit", "rb") as f:
            data = f.read()
        with open(base + "_rec.yuv", "rb") as f:
            golden = f.read()
        t0 = time.time()
        PD.ROUTE_FRAMES.update(dict.fromkeys(PD.ROUTE_FRAMES, 0))
        _, frames = decode_stream(data, device=device)
        out = b"".join(frames)
        if out != golden:
            raise AssertionError(f"golden {name}: output differs")
        if sum(PD.ROUTE_FRAMES.values()) != len(frames):
            raise AssertionError(f"golden {name}: a frame took no route")
        print(f"phase 2: {name}: {len(frames)} frames byte-exact "
              f"({time.time() - t0:.2f} s); frames by route "
              f"{PD.ROUTE_FRAMES}", flush=True)


def phase_main_path(device, card):
    """Phase 3: the 1080p bench stream, with launch and run counts taken
    over this decode alone; returns the counts and frame 1's MC inputs
    as pixel_core received them."""
    import torch
    from thor_tpu_torch.dec import decoder as PD
    from thor_tpu_torch.dec import device_frame as DF
    from thor_tpu_torch.ops import mc as MC
    with open(BENCH_STREAM, "rb") as f:
        data = f.read()
    times = []
    orig = PD.Decoder.decode_frame

    def timed(self, s, n):
        t0 = time.time()
        r = orig(self, s, n)
        times.append(time.time() - t0)
        return r

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(MC)
    DF.RUNS = 0
    PD.Decoder.decode_frame = timed
    seen, orig_core = capture_pixel_core(DF)
    t0 = time.time()
    try:
        _, frames = PD.decode_stream(data, device=device)
    finally:
        PD.Decoder.decode_frame = orig
        DF.pixel_core = orig_core
    wall = time.time() - t0
    launches = read_launches(MC)
    runs = DF.RUNS
    digest = hashlib.sha256(b"".join(frames)).hexdigest()
    if digest != BENCH_REC_SHA256:
        raise AssertionError(f"1080p output sha256 {digest} != "
                             f"{BENCH_REC_SHA256}")
    if runs != len(frames) or len(frames) != 8:
        raise AssertionError(f"DeviceFrameDecoder.run served {runs} of "
                             f"{len(frames)} frames")
    check_launches(launches, "bench_decode")
    steady = times[3:] if len(times) > 4 else times
    fps = len(steady) / sum(steady)
    print(f"phase 3: 1080p LDB-LC bench stream: sha256 matches its "
          f"reference decode's; "
          f"{len(frames)} frames, steady fps (frames 3..) {fps:.4f}, "
          f"whole stream {len(frames) / wall:.4f} fps ({wall:.3f} s); "
          f"per-frame s {[round(t, 4) for t in times]}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; "
          f"launches {launches}, runs {runs}; card {card}", flush=True)
    return launches, pixel_core_cells(DF, seen[1]), frames, times


def capture_pixel_core(DF):
    """Wraps DF.pixel_core so that the MC inputs of its first two calls
    (frames 0 and 1) are kept, and no later ones, which would raise the
    decode's peak device memory; returns the list they go to and the
    original function."""
    seen = []
    orig = DF.pixel_core

    def core(ystack, ustack, vstack, gstack, cstack, *args, **kw):
        if len(seen) < 2:
            seen.append((ystack, ustack, vstack, gstack, cstack, kw["pad"],
                         kw["pad_c"], kw["bd"], kw["has_inter"]))
        return orig(ystack, ustack, vstack, gstack, cstack, *args, **kw)

    DF.pixel_core = core
    return seen, orig


def pixel_core_cells(DF, captured):
    """The first MC list's kernel inputs of one pixel_core call, built as
    pixel_core builds them (dec/device_frame.py)."""
    ys, us, vs, g, c, pad, pad_c, bd, has_inter = captured
    if not has_inter:
        raise AssertionError("the captured frame has no inter cells")
    lk = DF.LY_KEYS
    ck = DF.CH_KEYS
    lc = {"rsel": g[lk.index("r0")], "y0": g[lk.index("y0_0")] + pad,
          "x0": g[lk.index("x0_0")] + pad, "op": g[lk.index("op0")],
          "vf": g[lk.index("vf0")], "hf": g[lk.index("hf0")],
          "fs": g[lk.index("fs0")]}
    cc = {"rsel": g[lk.index("r0")], "y0": c[ck.index("y0_0")] + pad_c,
          "x0": c[ck.index("x0_0")] + pad_c, "op": c[ck.index("op0")],
          "vf": c[ck.index("vf0")], "hf": c[ck.index("hf0")]}
    return {"planes": (ys, us, vs),
            "lc": {k: v.contiguous() for k, v in lc.items()},
            "cc": {k: v.contiguous() for k, v in cc.items()}, "bd": bd}


def phase_real_cells(device, card, real, rand):
    """Phase 4: the kernels on frame 1's cells (8 and 10 bits), then the
    times on the real and the random cells at 8 bits."""
    import torch
    from thor_tpu_torch.ops import mc as MC
    gen = torch.Generator().manual_seed(2027)
    ys, us, vs = real["planes"]
    out = {}
    for bd in (8, 10):
        if bd != real["bd"]:   # the same cells over 10-bit samples
            ys, us, vs = random_planes(gen, bd, 160, device)
        res = check_and_time(MC, device, "4 real", ys, us, vs, real["lc"],
                             real["cc"], bd, bd == real["bd"], card)
        for name, r in res.items():
            out.setdefault(name, {}).setdefault("errs", []).append(
                r["max_abs_err"])
            if "ms" in r:
                out[name]["real"] = r
    ys, us, vs = rand["planes"]
    res = check_and_time(MC, device, "4 random", ys, us, vs, rand["lc"],
                         rand["cc"], 8, True, card)
    one = torch.zeros(1, dtype=torch.int32, device=device)
    print(f"phase 4: one queued launch of a 1-element kernel (the floor of "
          f"a launch in these times): {device_ms(one.zero_):.6f} ms; card "
          f"{card}", flush=True)
    for name, r in res.items():
        out[name]["random"] = r
    return out


def tile_cells(MC, args, device):
    """The kernels' inputs for one make_example_full argument tuple: the
    int16 reference stacks and the cells that ops/mc.py's tile functions
    expand the 16x16 luma and 8x8 chroma tiles into."""
    import torch
    refy, refu, refv, oy, ox, fv, fh, coy, cox, cfv, cfh = (
        torch.from_numpy(a).to(device) for a in args[:11])
    zero = torch.zeros_like(fv)
    op, fs = MC._tile_ops(fv, fh, 0)
    y0, x0, rsel, op, vf, hf, fs = MC._tiles_to_cells(
        oy, ox, (zero, op, fv, fh, fs), 16, 4, 2)
    lc = {"rsel": rsel, "y0": y0, "x0": x0, "op": op, "vf": vf, "hf": hf,
          "fs": fs}
    cc = dict(zip(("rsel", "y0", "x0", "op", "vf", "hf"),
                  MC._chroma_tile_cells(coy, cox, cfv, cfh, 8)))
    return {"planes": tuple(MC._stack16(r) for r in (refy, refu, refv)),
            "lc": lc, "cc": cc}


def phase_tiles(device, card):
    """Phase 5: the tile pipeline on the card against itself on the CPU,
    its launch counts, and the kernels on the cells its tiles become."""
    import torch
    from thor_tpu_torch import entry as PE
    from thor_tpu_torch.models import pipeline as PP
    from thor_tpu_torch.ops import mc as MC
    H, W = H1080, W1080
    full, _, _ = PP.make_example_full(H, W, qp=32, seed=1)
    inter16 = PP.make_example(H, W, qp=32, seed=2)
    fn, cif = PE.entry(device=device)
    cif_cpu = [a.cpu() for a in cif]
    kw = dict(height=H, width=W, qp=32, bitdepth=8)
    runs = (
        (f"decode_p_frame_420 {W}x{H} ({len(full[3])} tiles)",
         lambda d: PP.decode_p_frame_420(*full, device=d, **kw)),
        (f"entry() CIF decode_p_frame_420 ({len(cif[3])} tiles)",
         lambda d: fn(*cif) if d is device else
         fn.func(*cif_cpu, **{**fn.keywords, "device": d})),
        (f"decode_inter_frame_16 {W}x{H}",
         lambda d: (PP.decode_inter_frame_16(*inter16, device=d, **kw),)),
    )
    for _, run in runs:     # warm up: allocator, tables on the card
        run(device)
    torch.cuda.synchronize()
    reset_launches(MC)
    got, ms = [], []
    for _, run in runs:
        t0 = time.perf_counter()
        got.append(run(device))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches(MC)
    for (what, run), g, t in zip(runs, got, ms):
        want = run("cpu")
        err = max_err([x.cpu() for x in g], want)
        print(f"phase 5: {what}: {t:.3f} ms on the card, max_abs_err {err} "
              f"against the CPU's plain versions; card {card}", flush=True)
        if err != 0 or any(x.shape != w.shape for x, w in zip(g, want)):
            raise AssertionError(f"{what}: the card's result differs from "
                                 f"the CPU's")
    print(f"phase 5: launches {launches}", flush=True)
    for name, (_, _, _, need) in KERNELS.items():
        if launches[name] != need["tile_pipeline"]:
            raise AssertionError(
                f"kernel {name}: {launches[name]} launches on the tile "
                f"pipeline, expected {need['tile_pipeline']}")
    out = {}
    for what, args in ((f"5 tiles {W}x{H}", full),
                       ("5 tiles CIF", [a.numpy() for a in cif_cpu])):
        c = tile_cells(MC, args, device)
        out[what] = check_and_time(MC, device, what, *c["planes"], c["lc"],
                                   c["cc"], 8, True, card)
    return launches, out


def bench_refs(frames):
    """Frames 6 and 7 of the bench stream's decode as padded reference
    frames, the inputs of the 1080p interpolation."""
    from thor_tpu_torch.frame import new_ref_frame
    refs = []
    for data in frames[6:8]:
        f = new_ref_frame(W1080, H1080)
        f.read_from(data)
        f.pad_frame()
        refs.append(f)
    return refs


def phase_tempinterp(device, card, frames):
    """Phase 6: temporal interpolation between two decoded frames, the
    card against the CPU."""
    import torch
    from thor_tpu_torch.frame import new_ref_frame
    from thor_tpu_torch.ops.tempinterp import interpolate_frames
    H, W = H1080, W1080
    refs = bench_refs(frames)
    for ratio, pos in ((2, 1), (4, 1)):
        outs = []
        for dev in (device, "cpu"):
            out = new_ref_frame(W, H)
            torch.cuda.synchronize()
            t0 = time.time()
            interpolate_frames(out, refs[0], refs[1], ratio, pos, device=dev)
            torch.cuda.synchronize()
            outs.append((out, time.time() - t0))
        (got, t_card), (want, t_cpu) = outs
        for plane in ("y_full", "u_full", "v_full"):
            g, w = getattr(got, plane), getattr(want, plane)
            if g.shape != w.shape or (g != w).any():
                raise AssertionError(f"interpolate_frames ratio {ratio} pos "
                                     f"{pos}: {plane} differs from the CPU's")
        if not got.y.any():
            raise AssertionError("the interpolated frame is empty")
        print(f"phase 6: interpolate_frames {W}x{H} ratio {ratio} pos {pos}: "
              f"{t_card:.3f} s on the card, equal to the CPU's "
              f"({t_cpu:.3f} s on this host's CPU); card {card}", flush=True)


def phase_unfused(device, card, real, fused_times):
    """Phase 7: the bench stream through the unfused routes, beside phase
    3's fused times; then the one-plane chroma kernel on the arguments
    that frame 1's calls gave it."""
    import torch
    from thor_tpu_torch.dec import decoder as PD
    from thor_tpu_torch.dec import device_frame as DF
    from thor_tpu_torch.dec import device_pixels as DP
    from thor_tpu_torch.ops import filters as OF
    from thor_tpu_torch.ops import mc as MC
    with open(BENCH_STREAM, "rb") as f:
        data = f.read()
    times, inner, chroma_calls = [], {"execute": [], "filters_exec": []}, []
    orig = (PD.Decoder.decode_frame, DP.execute, OF.filters_exec,
            DP.mc_cells_chroma)

    def timed(self, s, n):
        t0 = time.time()
        r = orig[0](self, s, n)
        times.append(time.time() - t0)
        return r

    def synced(fn, key):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.time()
            r = fn(*args, **kw)
            torch.cuda.synchronize()
            inner[key].append(time.time() - t0)
            return r
        return run

    def chroma(*args):
        if len(times) == 1:     # frame 1: the U call, then the V call
            chroma_calls.append(args)
        return orig[3](*args)

    torch.cuda.synchronize()
    reset_launches(MC)
    DF.RUNS = 0
    PD.ROUTE_FRAMES.update(dict.fromkeys(PD.ROUTE_FRAMES, 0))
    PD.Decoder.decode_frame = timed
    DP.execute = synced(orig[1], "execute")
    OF.filters_exec = synced(orig[2], "filters_exec")
    DP.mc_cells_chroma = chroma
    t0 = time.time()
    try:
        _, frames = PD.decode_stream(data, device=device, fused=False)
    finally:
        (PD.Decoder.decode_frame, DP.execute, OF.filters_exec,
         DP.mc_cells_chroma) = orig
    wall = time.time() - t0
    launches = read_launches(MC)
    routes = dict(PD.ROUTE_FRAMES)
    digest = hashlib.sha256(b"".join(frames)).hexdigest()
    if digest != BENCH_REC_SHA256:
        raise AssertionError(f"1080p output through the unfused routes: "
                             f"sha256 {digest} != {BENCH_REC_SHA256}")
    if DF.RUNS or routes != {"fused": 0, "two_stage": 7, "host_records": 1,
                             "python_walk": 0}:
        raise AssertionError(f"fused=False: routes {routes}, fused runs "
                             f"{DF.RUNS}")
    check_launches(launches, "unfused_decode")
    r4 = [round(t, 4) for t in times]
    print(f"phase 7: 1080p LDB-LC bench stream with fused=False: all "
          f"{len(frames)} frames decoded, sha256 matches; frames by route "
          f"{routes}; per-frame s {r4} (fused, phase 3: "
          f"{[round(t, 4) for t in fused_times]}); P frames mean "
          f"{statistics.mean(times[1:]):.4f} s against fused "
          f"{statistics.mean(fused_times[1:]):.4f} s, I frame "
          f"{times[0]:.4f} s against {fused_times[0]:.4f} s; whole stream "
          f"{wall:.3f} s; inside execute "
          f"{[round(t, 4) for t in inner['execute']]} s, inside "
          f"filters_exec {[round(t, 4) for t in inner['filters_exec']]} s "
          f"(synchronised on both sides); launches {launches}; card {card}",
          flush=True)

    # the one-plane kernel on its real-stream arguments
    if len(chroma_calls) != 2:
        raise AssertionError(f"frame 1 made {len(chroma_calls)} one-plane "
                             f"chroma calls, expected 2")
    before = read_launches(MC)["mc_chroma_cells"]
    errs = []
    for plane, args in zip("uv", chroma_calls):
        stack, cells = args[0], dict(zip(("rsel", "y0", "x0", "op", "vf",
                                          "hf"), args[1:7]))
        same = (torch.equal(stack, real["planes"]["uv".index(plane) + 1])
                and all(torch.equal(cells[k], real["cc"][k]) for k in cells))
        if not same or args[7:] != (2, real["bd"]):
            raise AssertionError(f"frame 1's {plane} call of the one-plane "
                                 f"kernel differs from phase 4's cells")
        got = MC.mc_cells_chroma(*args)
        torch.cuda.synchronize()
        errs.append(max_err(got, MC.mc_cells_chroma_plain(*args)))
    if read_launches(MC)["mc_chroma_cells"] != before + 2:
        raise AssertionError("the one-plane wrapper did not launch")
    print(f"phase 7: mc_chroma_cells against its plain version on frame "
          f"1's u and v calls ({chroma_calls[0][2].shape[0]} cells, the "
          f"cells phase 4 timed): max_abs_err {errs}", flush=True)
    if max(errs) != 0:
        raise AssertionError("mc_chroma_cells disagrees with its plain "
                             "version on the two-stage executor's cells")
    return launches, max(errs), {
        "per_frame_s": times, "fused_per_frame_s": fused_times,
        "execute_s": inner["execute"],
        "filters_exec_s": inner["filters_exec"]}


class _Captured(Exception):
    pass


def frame1_cells(device):
    """Decodes the bench stream up to frame 1's pixel_core call and
    returns that call's MC inputs (pixel_core_cells)."""
    from thor_tpu_torch.dec import decoder as PD
    from thor_tpu_torch.dec import device_frame as DF
    seen, orig = capture_pixel_core(DF)
    keep = DF.pixel_core

    def core(*args, **kw):
        r = keep(*args, **kw)
        if len(seen) == 2:
            raise _Captured
        return r

    DF.pixel_core = core
    with open(BENCH_STREAM, "rb") as f:
        data = f.read()
    try:
        PD.decode_stream(data, device=device)
    except _Captured:
        pass
    finally:
        DF.pixel_core = orig
    return pixel_core_cells(DF, seen[1])


def time_mc(root):
    """--time-mc ROOT: imports thor_tpu_torch from the checkout at ROOT and
    times its MC wrappers on two sets of 1080p cells: phase 1's random
    cells at 8 bits (the same seed, so the same cells), and frame 1's
    cells of the bench stream, decoded with ROOT's own decoder, which
    stops there.  Prints one JSON line: the card, and each wrapper's
    device milliseconds per call on each set (device_ms).  Two checkouts
    are compared on one card by running this on each in turns (parent,
    change, change, parent), one process per run."""
    import torch
    sys.path.insert(0, os.path.abspath(root))
    sys.path.insert(1, REPO)
    from thor_tpu_torch.ops import mc as MC
    device = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(2026)
    ys, us, vs = random_planes(gen, 8, 160, device)
    lc = main_path_cells(gen, H1080, W1080, 4, 160, True, device)
    cc = main_path_cells(gen, H1080, W1080, 2, 80, False, device)
    out = {"root": os.path.abspath(root), "card": card_line()}
    for name, (kernel, _) in kernel_calls(MC, ys, us, vs, lc, cc,
                                          8).items():
        out["random_" + name + "_ms"] = device_ms(kernel)
    real = frame1_cells(device)
    for name, (kernel, _) in kernel_calls(
            MC, *real["planes"], real["lc"], real["cc"],
            real["bd"]).items():
        out["frame1_" + name + "_ms"] = device_ms(kernel)
    print(json.dumps(out))
    return 0


def profile_tempinterp():
    """--profile-tempinterp: decodes the bench stream, interpolates between
    its frames 6 and 7 at (ratio, pos) = (2, 1) once untraced and once
    under torch.profiler (CUDA activity only), and prints one JSON line:
    the card, the untraced and the traced seconds, the number of kernels
    the card ran, their summed device time, the idle share of the traced
    call, and the five kernels with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, REPO)
    from thor_tpu_torch import decode_stream
    from thor_tpu_torch.frame import new_ref_frame
    from thor_tpu_torch.ops.tempinterp import interpolate_frames
    device = torch.device("cuda", 0)
    with open(BENCH_STREAM, "rb") as f:
        _, frames = decode_stream(f.read(), device=device)
    refs = bench_refs(frames)

    def run():
        torch.cuda.synchronize()
        t0 = time.time()
        interpolate_frames(new_ref_frame(W1080, H1080), refs[0], refs[1], 2,
                           1, device=device)
        torch.cuda.synchronize()
        return time.time() - t0

    run()
    plain_s = run()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced_s = run()
    ev = [e for e in prof.key_averages() if e.device_time_total > 0]
    busy_s = sum(e.device_time_total for e in ev) / 1e6
    top = sorted(ev, key=lambda e: -e.device_time_total)[:5]
    print(json.dumps({
        "card": card_line(), "what": "interpolate_frames 1920x1088 (2, 1)",
        "seconds": plain_s, "traced_seconds": traced_s,
        "kernels": sum(e.count for e in ev), "device_busy_s": busy_s,
        "idle_share_traced": 1 - busy_s / traced_s,
        "top": [[e.key[:60], e.count, e.device_time_total / 1e6]
                for e in top]}))
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time-mc", metavar="DIR",
                    help="time the MC wrappers of the checkout at DIR and "
                    "run nothing else")
    ap.add_argument("--profile-tempinterp", action="store_true",
                    help="trace one 1080p temporal interpolation and run "
                    "nothing else")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    if args.time_mc:
        return time_mc(args.time_mc)
    if args.profile_tempinterp:
        return profile_tempinterp()
    sys.path.insert(0, REPO)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    device = torch.device("cuda", 0)
    from thor_tpu_torch.kernels import build
    t0 = time.time()
    build.load()
    print(f"phase 0: kernels built in {time.time() - t0:.1f} s "
          f"({build.library_path()})", flush=True)
    print(build.build_log.strip(), flush=True)

    rand = phase_kernels(device, card)
    phase_goldens(device)
    launches, real, frames, fused_times = phase_main_path(device, card)
    res = phase_real_cells(device, card, real, rand)
    tile_launches, tiles = phase_tiles(device, card)
    phase_tempinterp(device, card, frames)
    unfused_launches, k2_err, unfused = phase_unfused(device, card, real,
                                                      fused_times)

    # each kernel's headline numbers are taken on the cells of a
    # real-stream path that launches it, frame 1 of the bench stream: the
    # fused decode for the luma and the U+V kernel, the two-stage
    # executor for the luma and the one-plane chroma kernel (the same
    # cells, phase 7 checks it); the other cell sets stand beside them
    keys = ("ms", "kernel_ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
            "share", "bytes", "copy_ms")
    big, cif = tiles[f"5 tiles {W1080}x{H1080}"], tiles["5 tiles CIF"]
    kernels = []
    for name, (source, replaces, _, _) in KERNELS.items():
        sets = {"bench stream frame 1": res[name]["real"],
                "random 1080p cells": res[name]["random"],
                "tile pipeline 1080p": big[name],
                "tile pipeline CIF": cif[name]}
        head = "bench stream frame 1"
        r = sets.pop(head)
        by_path = {"bench_decode": launches[name],
                   "tile_pipeline": tile_launches[name],
                   "unfused_decode": unfused_launches[name]}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(res[name]["errs"] +
                               [x["max_abs_err"] for x in sets.values()] +
                               [r["max_abs_err"]] +
                               [k2_err] * (name == "mc_chroma_cells")),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "bound_us": r["bound_ms"] * 1e3,
            "share": r["share"], "call_ms": r["call_ms"],
            "kernel_ms": r["kernel_ms"], "copy_ms": r["copy_ms"],
            "bytes": r["bytes"], "cells": head,
            "other_cells": {what: {k: x[k] for k in keys}
                            for what, x in sets.items()}})
    print(json.dumps({"unfused_decode": unfused}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
