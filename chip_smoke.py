#!/usr/bin/env python3
"""Smoke run of thor_tpu_torch on one NVIDIA GPU (built for Hopper, sm_90a).

    python3 chip_smoke.py
    python3 chip_smoke.py --time-mc DIR

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
     byte-equal to its reference YUV;
  3. the main path: the 8-frame 1080p LDB-LC bench stream, whose output
     must hash to bench.REC_SHA256, with the MC kernels' launch counts
     and the frame decoder's run count taken over that decode alone (it
     must launch the luma and the U+V kernel; no path of the port calls
     the one-plane chroma case yet, and its count is printed as read);
     the cells that pixel_core receives for frame 1 are kept;
  4. each kernel against its plain version on frame 1's cells (bit
     depths 8 and 10), then both timed on the real and the random cells
     at 8 bits, beside the bound: the bytes the function must move (each
     metadata array read once, each output written once, and the
     distinct reference samples the cells' ops need) at 3.35 TB/s.
Times are device times: the launches queue behind a sleeping kernel, so
the events time the card's work and not the Python that issues it
(`call_ms`, one call timed alone, includes that; `kernel_ms` is the
kernel alone in torch.profiler's trace, without the gap between queued
launches).  The second-to-last line is a JSON object with the kernels'
results, the last line {"ok": true, "device": {...}}.

`--time-mc DIR` times the MC wrappers of the checkout at DIR instead (see
`time_mc`), for an A/B of two checkouts on one card.
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
           "small256_LDB_medium_complexity")
H1080, W1080 = 1088, 1920
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 rate
# int32 multiply-adds run outside the tensor cores: the H100 SXM float32
# rate outside them, 67 T/s, stands for their peak
OPS_PER_S = 67e12
SRC = "thor_tpu_torch/csrc/"
KERNELS = {   # name: (source, the Pallas call it replaces, launch counter
    #                in ops/mc.py, whether the main path must launch it)
    "mc_luma_cells": (SRC + "mc_luma.cu", "thor_tpu/ops/mc_pallas.py:164",
                      "LUMA_LAUNCHES", True),
    "mc_chroma_uv_cells": (SRC + "mc_chroma.cu",
                           "thor_tpu/ops/mc_pallas.py:385",
                           "CHROMA_UV_LAUNCHES", True),
    "mc_chroma_cells": (SRC + "mc_chroma.cu",
                        "thor_tpu/ops/mc_pallas.py:274", "CHROMA_LAUNCHES",
                        False),
}


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
    for name in GOLDENS:
        base = os.path.join(REPO, "tests", "golden", name)
        with open(base + ".bit", "rb") as f:
            data = f.read()
        with open(base + "_rec.yuv", "rb") as f:
            golden = f.read()
        t0 = time.time()
        _, frames = decode_stream(data, device=device)
        out = b"".join(frames)
        if out != golden:
            raise AssertionError(f"golden {name}: output differs")
        print(f"phase 2: {name}: {len(frames)} frames byte-exact "
              f"({time.time() - t0:.2f} s)", flush=True)


def phase_main_path(device, card):
    """Phase 3: the 1080p bench stream, with launch and run counts taken
    over this decode alone; returns the counts and frame 1's MC inputs
    as pixel_core received them."""
    import torch
    import bench
    from thor_tpu_torch.dec import decoder as PD
    from thor_tpu_torch.dec import device_frame as DF
    from thor_tpu_torch.ops import mc as MC
    with open(bench.STREAM, "rb") as f:
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
    for _, _, counter, _ in KERNELS.values():
        setattr(MC, counter, 0)
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
    launches = {name: getattr(MC, counter)
                for name, (_, _, counter, _) in KERNELS.items()}
    runs = DF.RUNS
    digest = hashlib.sha256(b"".join(frames)).hexdigest()
    if digest != bench.REC_SHA256:
        raise AssertionError(f"1080p output sha256 {digest} != "
                             f"{bench.REC_SHA256}")
    if runs != len(frames) or len(frames) != 8:
        raise AssertionError(f"DeviceFrameDecoder.run served {runs} of "
                             f"{len(frames)} frames")
    for name, (_, _, _, on_path) in KERNELS.items():
        if on_path and launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")
    steady = times[3:] if len(times) > 4 else times
    fps = len(steady) / sum(steady)
    print(f"phase 3: 1080p LDB-LC bench stream: sha256 matches REC_SHA256; "
          f"{len(frames)} frames, steady fps (frames 3..) {fps:.4f}, "
          f"whole stream {len(frames) / wall:.4f} fps ({wall:.3f} s); "
          f"per-frame s {[round(t, 4) for t in times]}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; "
          f"launches {launches}, runs {runs}; card {card}", flush=True)
    return launches, pixel_core_cells(DF, seen[1])


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


class _Captured(Exception):
    pass


def frame1_cells(device):
    """Decodes the bench stream up to frame 1's pixel_core call and
    returns that call's MC inputs (pixel_core_cells)."""
    import bench
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
    with open(bench.STREAM, "rb") as f:
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time-mc", metavar="DIR",
                    help="time the MC wrappers of the checkout at DIR and "
                    "run nothing else")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    if args.time_mc:
        return time_mc(args.time_mc)
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
    launches, real = phase_main_path(device, card)
    res = phase_real_cells(device, card, real, rand)

    kernels = []
    for name, (source, replaces, _, on_path) in KERNELS.items():
        r, rr = res[name]["real"], res[name]["random"]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(res[name]["errs"] + [rr["max_abs_err"]]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "bound_us": r["bound_ms"] * 1e3,
            "share": r["share"], "call_ms": r["call_ms"],
            "kernel_ms": r["kernel_ms"], "copy_ms": r["copy_ms"],
            "bytes": r["bytes"], "cells": "bench stream frame 1",
            "random": {k: rr[k] for k in ("ms", "kernel_ms", "plain_ms",
                                          "bound_ms", "share", "bytes",
                                          "copy_ms")}})
        if not on_path:
            kernels[-1]["note"] = (
                "the one-plane case of thor_mc_chroma_cells; the main path "
                "runs only the two-plane case (mc_chroma_uv_cells), and no "
                "path of the port calls this one yet")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
