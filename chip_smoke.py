#!/usr/bin/env python3
"""Smoke run of thor_tpu_torch on one NVIDIA GPU (built for Hopper, sm_90a).

    python3 chip_smoke.py

Phases; any failure raises and the exit code is non-zero:
  0. setup: require CUDA, print the card's name and power limit, build
     the CUDA kernels from thor_tpu_torch/csrc (nvcc, sm_90a);
  1. each kernel against its plain torch version on the card, at the
     1080p main path's shapes (130,560 cells over a ring stack of 2
     references), bit depths 8 and 10, both filter sets: the maximum
     difference must be 0 (the codec is integer: tolerance 0); median
     times of kernel and plain version by CUDA events;
  2. golden streams through the port's decode_stream on the card, each
     byte-equal to its reference YUV;
  3. the main path: the 8-frame 1080p LDB-LC bench stream, whose output
     must hash to bench.REC_SHA256, with the MC kernels' launch counts
     and the frame decoder's run count taken over that decode alone.
The second-to-last line is a JSON object with the kernels' results, the
last line {"ok": true, "device": {...}}.
"""
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


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=15, warmup=3):
    """Median milliseconds of fn() on the current stream (CUDA events)."""
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


def main_path_cells(gen, H, W, cs, pad, luma, device):
    """Cell metadata of one 1080p frame at the main path's shapes: one
    cell per 4x4 luma block, origins within the MV clip range, and 1 in
    64 cells with wild origins and table indices, which the kernels must
    clamp exactly as JAX's gather does."""
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


def phase_kernels(device):
    """Phase 1: every kernel against its plain version, then timed."""
    import torch
    from thor_tpu_torch.ops import mc as MC
    gen = torch.Generator().manual_seed(2026)
    pad = 160
    cases = {"luma": [], "chroma_uv": [], "chroma_one_plane": []}
    timing = {}
    for bd in (8, 10):
        ys = torch.randint(0, 1 << bd, (2, H1080 + 2 * pad, W1080 + 2 * pad),
                           generator=gen, dtype=torch.int16).to(device)
        us, vs = (torch.randint(0, 1 << bd, (2, H1080 // 2 + pad,
                                             W1080 // 2 + pad),
                                generator=gen, dtype=torch.int16).to(device)
                  for _ in range(2))
        lc = main_path_cells(gen, H1080, W1080, 4, pad, True, device)
        cc = main_path_cells(gen, H1080, W1080, 2, pad // 2, False, device)
        largs = (lc["rsel"], lc["y0"], lc["x0"], lc["op"], lc["vf"],
                 lc["hf"], lc["fs"], 4, bd)
        cargs = (cc["rsel"], cc["y0"], cc["x0"], cc["op"], cc["vf"],
                 cc["hf"], 2, bd)

        def luma_k():
            return MC.mc_cells_luma(ys, *largs)

        def luma_p():
            return MC.mc_cells_luma_plain(ys, *largs)

        def uv_k():
            return MC.mc_cells_chroma_uv(us, vs, *cargs)

        def uv_p():
            return tuple(MC.mc_cells_chroma_plain(s, *cargs)
                         for s in (us, vs))

        got, ref = luma_k(), luma_p()
        torch.cuda.synchronize()
        cases["luma"].append(int((got - ref).abs().max()))
        (gu, gv), (pu, pv) = uv_k(), uv_p()
        one = MC.mc_cells_chroma(vs, *cargs)
        torch.cuda.synchronize()
        cases["chroma_uv"].append(max(int((gu - pu).abs().max()),
                                      int((gv - pv).abs().max())))
        cases["chroma_one_plane"].append(int((one - pv).abs().max()))
        if bd == 8:
            # plain, kernel, kernel, plain
            p1, k1 = cuda_ms(luma_p), cuda_ms(luma_k)
            k2, p2 = cuda_ms(luma_k), cuda_ms(luma_p)
            timing["luma"] = (min(k1, k2), min(p1, p2))
            p1, k1 = cuda_ms(uv_p), cuda_ms(uv_k)
            k2, p2 = cuda_ms(uv_k), cuda_ms(uv_p)
            timing["chroma_uv"] = (min(k1, k2), min(p1, p2))
        del ys, us, vs
    for name, errs in cases.items():
        print(f"phase 1: {name} kernel vs plain at N={(H1080 // 4) * (W1080 // 4)}"
              f" cells, bd 8/10: max_abs_err {errs}", flush=True)
        if max(errs) != 0:
            raise AssertionError(f"{name} kernel disagrees with its plain "
                                 f"version: {errs}")
    for name, (k, p) in timing.items():
        print(f"phase 1: {name} at 1080p: kernel {k:.4f} ms, plain "
              f"{p:.4f} ms", flush=True)
    return cases, timing


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
    over this decode alone."""
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
    MC.LUMA_LAUNCHES = MC.CHROMA_LAUNCHES = 0
    DF.RUNS = 0
    PD.Decoder.decode_frame = timed
    t0 = time.time()
    try:
        _, frames = PD.decode_stream(data, device=device)
    finally:
        PD.Decoder.decode_frame = orig
    wall = time.time() - t0
    launches = {"luma": MC.LUMA_LAUNCHES, "chroma_uv": MC.CHROMA_LAUNCHES}
    runs = DF.RUNS
    digest = hashlib.sha256(b"".join(frames)).hexdigest()
    if digest != bench.REC_SHA256:
        raise AssertionError(f"1080p output sha256 {digest} != "
                             f"{bench.REC_SHA256}")
    if runs != len(frames) or len(frames) != 8:
        raise AssertionError(f"DeviceFrameDecoder.run served {runs} of "
                             f"{len(frames)} frames")
    for name, n in launches.items():
        if n <= 0:
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
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
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

    cases, timing = phase_kernels(device)
    phase_goldens(device)
    launches = phase_main_path(device, card)

    src = "thor_tpu_torch/csrc/"
    kernels = [
        {"name": "mc_luma_cells", "route": "cuda",
         "source": src + "mc_luma.cu",
         "replaces": "thor_tpu/ops/mc_pallas.py:164",
         "launches": launches["luma"], "max_abs_err": max(cases["luma"]),
         "ms": timing["luma"][0], "plain_ms": timing["luma"][1]},
        {"name": "mc_chroma_uv_cells", "route": "cuda",
         "source": src + "mc_chroma.cu",
         "replaces": "thor_tpu/ops/mc_pallas.py:385",
         "launches": launches["chroma_uv"],
         "max_abs_err": max(cases["chroma_uv"] + cases["chroma_one_plane"]),
         "ms": timing["chroma_uv"][0], "plain_ms": timing["chroma_uv"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
