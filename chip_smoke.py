#!/usr/bin/env python3
"""Smoke run of thor_tpu_torch on one NVIDIA GPU (built for Hopper, sm_90a).

    python3 chip_smoke.py
    python3 chip_smoke.py --time-mc DIR
    python3 chip_smoke.py --profile-tempinterp
    python3 chip_smoke.py --turbo
    python3 chip_smoke.py --exact
    python3 chip_smoke.py --device-enc
    python3 chip_smoke.py --multistream
    python3 chip_smoke.py --me

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
     as the two references, interpolate_frames at (ratio, pos) (4, 1) on
     the card, equal to the same call on the CPU (the dyadic (2, 1) runs
     three times in phase 11's lane encode and three in its decode, held
     there by the stream's and the recon's hashes);
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
  8. the turbo encoder (thor_tpu_torch.encode_sequence), the twin of
     bench.py:stage_turbo_lc: its 6-frame 1920x1088 textured clip
     (default_rng(12)) with its LC parameters, cut to the first 3 frames
     in the whole smoke (I, P, and the first P frame with two references;
     --turbo encodes all 6).  The stream must hash to
     LC1080_STREAM_SHA256 (and the recon to LC1080_REC_SHA256), thor_tpu's
     stream of the same encode on the CPU, and the port's decoder on the
     card must decode it to the encoder's recon.  Printed: steady fps as
     bench.py computes it, seconds per frame in decide_frame, the C plan,
     finalize_core (synchronised on both sides), the pull, the C emit and
     the filter tail (and in its deblock, CLPF search and CLPF
     application), the intra wave segments per frame, the launches over
     this encode alone (the luma kernel once and the one-plane chroma
     kernel twice per P frame; not the U+V kernel); then the two kernels
     against their plain versions on frame 1's finalizer calls, and
     timed there; frame 1 (P) of that encode under torch.profiler (its
     stage times include the profiler's cost); and the LC, HE-CDEF and
     RA B-frame configurations of tests/test_torch_turbo.py encoded on
     the card, each byte-equal to thor_tpu's stream in
     tests/torch_turbo/, the LC one with the torch operations of each
     encoder function counted per call.
  9. the exact host-RDO encoder (thor_tpu_torch.encode_sequence, the
     default turbo=0) on the card, at the goldens' sizes (its SB loop is
     numpy on the host; the frame tail's deblock, CDEF and CLPF passes
     run on the card): tiny64_ldblc, c444_128 with turbo=1 (every frame
     falls back from turbo, said once on stderr) and hdb9_128 (B
     frames), each stream and recon byte-equal to tests/golden and
     decoded back to the recon by the port's decoder on the card; then
     ra_ir2_cdef of tests/test_torch_turbo.py (turbo I/P frames, host-RDO
     interp_ref=2 B frames, CDEF on), whose stream and recon must hash to
     thor_tpu's in tests/torch_turbo/fixtures.json.  Printed per encode:
     the frames by route, seconds per frame in the SB loop (or turbo's
     decide + finalize) and in the tail, with its deblock, CDEF and CLPF
     parts synchronised, and the launches over that encode alone (none on
     the golden encodes; the luma and the one-plane chroma kernel on the
     mixed one's turbo P frames).
 10. the wavefront device encoder (device_enc=1, enc/device_lc.py) on the
     card through its default route, frame_megakernel: per frame
     configuration, diagonal 0 eagerly, the diagonal body captured once
     as a CUDA graph and replayed once per other diagonal (D - 1 replays
     on a frame that captures, D on one that reuses a graph).  The first
     frame of phase 8's 1920x1088 clip with LC_KW (the whole smoke
     encodes the I frame; --device-enc the I and the P frame): its
     stream and recon must hash to DEVENC1080_STREAM_SHA256 /
     DEVENC1080_REC_SHA256 (thor_tpu's device route on the CPU), every
     frame must take the device route, and the port's decoder on the
     card must reproduce the recon.  Then the DEVENC_FIXTURES
     configurations of tests/test_torch_device_lc.py (an I and a P frame
     each, each equal to its thor_tpu fixture): lc128 (one SB, one
     diagonal: no graph) through the graph route and the host loop
     (encode_sequence(megakernel=False)), edges264 (a P diagonal of 2
     lanes, SBs cut by the right and bottom edges) twice through the
     graphs, the second time on the first one's graphs.  K1-K3 must
     launch 0 times over these encodes (device_lc reads its MC from
     variant stacks).  Printed per frame: seconds in build_frame_consts,
     frame_megakernel and in its warm-up, capture, instantiation and
     replays (each synchronised; each replayed diagonal's seconds), the
     captures and replays, the growth of the reserved device memory over
     a capture (the graph's pool), the pull, emit_frame and the filter
     tail; the replay of diagonal COUNT_DIAGONAL of the 1080p frame 0
     under torch.profiler (kernels, device busy time, idle share); with
     --device-enc also the torch operations per call of each body kind
     on diagonal COUNT_DIAGONAL of the 1080p P frame, through the host
     loop's run_diagonal and through the graph's diagonal_body.
 11. the multi-stream paths on the card: (a) the bench stream twice in
     lockstep through decode_streams_sharded, its P frames batched (the
     luma kernel once per frame and the one-plane chroma kernel twice,
     over both streams' 2 x 130,560 cells and an 8-reference stack: K1 7,
     K2 14, K3 0 over the pair), each output hashing to BENCH_REC_SHA256,
     seconds per frame of the pair beside phase 7's solo ones, then K1
     and K2 against their plain versions on the pair's frame-1 batch and
     timed there; (b) multi_stream_step and multi_stream_full at
     1920x1088 over 2 streams, each equal to the same call on the CPU (K1
     2, K3 1 over the two); (c) encode_sequence_lanes on the first 5
     frames of phase 8's clip with the dry run's RA GOP4 parameters
     (entry.LANES_KW): the stream and recon must hash to
     LANES1080_STREAM_SHA256 / LANES1080_REC_SHA256 (thor_tpu's
     sequential turbo encode on the CPU), with >= 2 decision passes in
     flight, and the card's decoder must reproduce the recon; seconds per
     frame and per call of decide, prefetch, resolve, finalize, tail and
     interpolation; (d) encode_streams_sharded of the lc and qmtx
     configurations of tests/test_torch_turbo.py, each equal to its
     fixture, beside the same encodes one after the other; (e)
     entry.dryrun_multistream on the card.  Launches are counted over
     each of (a)-(d) alone.
 12. thor_tpu's lockstep motion search (ops/me_batch.py) on the card at
     1080p (me1080_inputs): the 8,160 16x16 blocks of frame 1 of phase
     3's decode against frame 0 padded as the encoder pads it, through
     motion_estimate_batch three ways (the fast sub-pel path, the
     telescope with the widesad32 row scan, and speed0's exact sub-pel
     path), motion_estimate_bi_batch (frame 2 the second reference) and
     motion_estimate_sync_batch (the 32,640 8x8 sub-PUs); each output
     must hash to ME1080_SHA256 (thor_tpu's functions on the CPU), with
     K1's launches counted over each call alone (ME1080_K1: 0, 0, 16,
     110, 55; K2 and K3 none).  Printed: seconds per call (synchronised
     on both sides) and torch operations per call of each search; then
     K1 against its plain version on the two MC calls of the bi
     search's first persistent slot (ME1080_HELD; 130,560 cells each)
     and timed there.
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
`--turbo` builds the kernels and runs phase 8 alone (all 6 frames),
`--exact` phase 9, `--device-enc` phase 10 with the 1080p P frame and
the operation counts, `--multistream` phase 11, `--me` phase 12 on the
bench stream's first three frames.
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
# thor_tpu's turbo stream of phase 8's clip and parameters (bench.py:
# stage_turbo_lc), encoded on the CPU, and the sha256 of its recon, for
# the first 3 frames (the whole smoke) and all 6 (--turbo)
LC1080_STREAM_SHA256 = {
    3: "04fd138033c95e929bc4a2f2f0b43cec1081641e14e3689deed66417cc91af16",
    6: "d88581bfdbfbc725801b929d6612ee76c9ad0dc6c1c406a04513a3b3daa23766"}
LC1080_REC_SHA256 = {
    3: "7137ad9cc3bf6439aa9ec66d7745e78438e41bed64b33b042ec795ee179cbb6a",
    6: "71299254113fc1564bfc6903b5a3a26db497e7638497b7ffd31c7f2f5aad6a0b"}
# the LC parameters of bench.py:stage_turbo_lc and tests/test_turbo.py
LC_KW = dict(qp=32, lambda_coeffI=0.8, lambda_coeffP=1.2,
             early_skip_thr=1.0, max_num_ref=2, HQperiod=12, mqpP=1.2,
             dqpI=-2, encoder_speed=2, cdef=0, clpf=1, use_block_contexts=1)
# three configurations of tests/test_torch_turbo.py (W, H, frames, seed,
# parameters over LC_KW) and their thor_tpu streams under tests/torch_turbo
TURBO_FIXTURES = {
    "lc": (128, 128, 2, 11, {}),
    "he_cdef": (128, 96, 2, 3, dict(
        early_skip_thr=0.3, enable_tb_split=1, enable_pb_split=1,
        max_num_ref=4, intra_rdo=1, enable_bipred=1, cdef=2, clpf=0,
        encoder_speed=0)),
    "ra_bframes": (128, 96, 10, 5, dict(
        num_reorder_pics=7, interp_ref=1, enable_bipred=1, dqpB0=3,
        dqpB1=1, mqpB=1.2, mqpB0=1.1, mqpB1=1.2, mqpB2=1.3,
        intra_period=64, HQperiod=8)),
}
# the two configurations of tests/test_torch_turbo.py that phase 11
# encodes at once (encode_streams_sharded)
MULTI_FIXTURES = {"lc": TURBO_FIXTURES["lc"],
                  "qmtx": (128, 96, 4, 13, dict(qmtx=1, qmtx_offset=12))}
# thor_tpu's sequential turbo encode (on the CPU) of the first 5 frames of
# phase 8's clip with the dry run's RA GOP4 parameters
# (thor_tpu_torch.entry.LANES_KW): the sha256 of the stream and of its
# recon, which phase 11's GOP-lane encode must give
LANES1080_STREAM_SHA256 = ("e896f179f79f80daa01b510b99263fbd"
                           "7e17dc007feb99ec9d2f59707f4116c8")
LANES1080_REC_SHA256 = ("d37b32c53135d63a24cafe30a3d0e713"
                        "bf117854d816ed8b738c0e96905052f2")
# thor_tpu's device_enc=1 encode (the wavefront device encoder, on the
# CPU) of the first 1 or 2 frames of phase 8's clip with LC_KW: the
# sha256 of the stream and of its recon (phase 10); thor_tpu's host RDO
# gives the same hashes.  The whole smoke encodes 1 frame (the 1080p P
# frame's diagonal loop takes minutes on the card, PERF.md), --device-enc
# both
DEVENC1080_STREAM_SHA256 = {
    1: "84bdedbb94adca2700a46f65e11a01ffe7c7ad9caaed7dfa845623275a96d8f0",
    2: "1edfbb2dadceb457c7cfa4eeaabdece88ae4506273c61b5e7b7287e875f8ea65"}
DEVENC1080_REC_SHA256 = {
    1: "d7d907c6fbb067d5c1fb13e7df55f816621f3336c4a8589a46478f5fd0cec760",
    2: "1c75b99e0bd4f644b6d2e840ce595cb2a0765aaed72388c4ef4c90c27e42b1ac"}
# configurations of tests/test_torch_device_lc.py (name, W, H, frames,
# seed of tests/test_device_encoder.py:_clip), each held to its thor_tpu
# fixture in tests/torch_device_lc: the tier-1 one (one SB) and edges264
# (5 diagonals, a P diagonal of 2 lanes, 8-pixel right and bottom edges)
DEVENC_FIXTURE = ("lc128", 128, 128, 2, 5)
DEVENC_FIXTURES = (DEVENC_FIXTURE, ("edges264", 264, 136, 2, 7))
# edges264's clip at 4 frames (I, P with one reference, two P with two):
# encoded after edges264, its frames 0, 1 and 3 replay graphs captured on
# other frames
DEVENC_REUSE = ("edges264x4", 264, 136, 4, 7)
# the diagonal of the 1080p frame 1 whose torch operations --device-enc
# counts: one of the 8-lane diagonals in the middle of the frame
COUNT_DIAGONAL = 15
# phase 12: thor_tpu's lockstep motion search (ops/me_batch.py) at
# 1080p on me1080_inputs (the bench stream's frames 0-2, then
# default_rng(ME1080_SEED)): the sha256 (me_digest) of each search's
# (sad, mv_y, mv_x), thor_tpu's JAX functions on the CPU on the same
# inputs, run op by op (the slow test_me1080_hashes_are_thor_tpus of
# tests/test_torch_me_batch.py recomputes them), and K1's launches in each
# search: one per mc_luma_tiles call, as in thor_tpu (16 exact sub-pel
# evaluations with speed0; 49 telescope candidates and 6 slots of two
# calls in the bi-prediction search; 49 + 6 in the sync search); K2 and
# K3 launch in none
ME1080_SEED = 1012
ME1080_MVC = (6, -10)
ME1080_SHA256 = {
    "me_fast":
        "90a864dc021bd6ff2a936ed67b63249224eab540e2e2bd68b95a4773a0b762a0",
    "me_telescope":
        "875b25ccf65ccbf9115fa3bd8a2582855efe95636d679be078a2fc8549c3e277",
    "me_speed0":
        "2b23a55a102ae6274adc873012904e12fb23d992f68da9d1311624284955785d",
    "me_bi":
        "53dcff54d3f1a725e212ccf75bcc1aadaa197ad6f523263994254c004befa8b7",
    "me_sync":
        "3ac2a0807dbdf6a7b57121758892c4fe82b16d664a1d40e86c3b8080237aeed7"}
ME1080_K1 = {"me_fast": 0, "me_telescope": 0, "me_speed0": 16,
             "me_bi": 110, "me_sync": 55}
ME1080_NONE = dict.fromkeys(ME1080_K1, 0)
# the bi-prediction search's K1 calls that phase 12 holds against the
# plain version and times: the two of the first persistent slot (slot 0,
# quarter-pel candidates: copy, six-tap and low-pass cells mixed)
ME1080_HELD = (98, 99)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 rate
# int32 multiply-adds run outside the tensor cores: the H100 SXM float32
# rate outside them, 67 T/s, stands for their peak
OPS_PER_S = 67e12
SRC = "thor_tpu_torch/csrc/"
KERNELS = {   # name: (source, the Pallas call it replaces, launch counter
    #                in ops/mc.py, the launches each driven path must make:
    #                exactly on EXACT_PATHS, at least elsewhere (none
    #                where 0: the host-RDO encodes and the wavefront
    #                device encoder launch none)
    "mc_luma_cells": (SRC + "mc_luma.cu", "thor_tpu/ops/mc_pallas.py:164",
                      "LUMA_LAUNCHES", {"bench_decode": 1,
                                        "tile_pipeline": 3,
                                        "unfused_decode": 1,
                                        "turbo_encode": 1,
                                        "exact_encode": 0,
                                        "mixed_encode": 1,
                                        "device_encode": 0,
                                        "multistream_decode": 7,
                                        "multistream_pipeline": 2,
                                        "lanes_encode": 1,
                                        "multistream_encode": 1,
                                        **ME1080_K1}),
    "mc_chroma_uv_cells": (SRC + "mc_chroma.cu",
                           "thor_tpu/ops/mc_pallas.py:385",
                           "CHROMA_UV_LAUNCHES", {"bench_decode": 1,
                                                  "tile_pipeline": 1,
                                                  "unfused_decode": 0,
                                                  "turbo_encode": 0,
                                                  "exact_encode": 0,
                                                  "mixed_encode": 0,
                                                  "device_encode": 0,
                                                  "multistream_decode": 0,
                                                  "multistream_pipeline": 1,
                                                  "lanes_encode": 0,
                                                  "multistream_encode": 0,
                                                  **ME1080_NONE}),
    # the one-plane case of thor_mc_chroma_cells: the two-stage executor
    # (solo and stream-batched) and the turbo encoder's finalizer call it
    # once per plane and list; the tile pipeline takes it when a stream's
    # tile count is no multiple of 16 (CIF: 396)
    "mc_chroma_cells": (SRC + "mc_chroma.cu",
                        "thor_tpu/ops/mc_pallas.py:274", "CHROMA_LAUNCHES",
                        {"bench_decode": 0, "tile_pipeline": 2,
                         "unfused_decode": 1, "turbo_encode": 1,
                         "exact_encode": 0, "mixed_encode": 1,
                         "device_encode": 0, "multistream_decode": 14,
                         "multistream_pipeline": 0, "lanes_encode": 1,
                         "multistream_encode": 1, **ME1080_NONE}),
}
# the paths whose launch counts are exact (the others must launch some)
EXACT_PATHS = ("tile_pipeline", "multistream_decode",
               "multistream_pipeline", *ME1080_K1)


def reset_launches(MC):
    for _, _, counter, _ in KERNELS.values():
        setattr(MC, counter, 0)


def read_launches(MC):
    return {name: getattr(MC, counter)
            for name, (_, _, counter, _) in KERNELS.items()}


def check_launches(launches, path):
    """A driven path must launch each kernel its route runs, and none of
    the others; a path of EXACT_PATHS as many times as KERNELS says."""
    for name, (_, _, _, need) in KERNELS.items():
        if path in EXACT_PATHS and launches[name] != need[path]:
            raise AssertionError(
                f"kernel {name}: {launches[name]} launches on the {path} "
                f"path, expected {need[path]}")
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
    check_launches(launches, "tile_pipeline")
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
    for ratio, pos in ((4, 1),):
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


def lc1080_clip(N=6):
    """bench.py:stage_turbo_lc's clip: a textured gradient moving 8 pixels
    a frame, flat chroma (raw 4:2:0 bytes)."""
    import numpy as np
    H, W = H1080, W1080
    rng = np.random.default_rng(12)
    base = np.clip(np.linspace(40, 210, W)[None, :] +
                   np.linspace(0, 40, H)[:, None] +
                   rng.integers(-12, 12, (H, W)), 0, 255).astype(np.uint8)
    frames = []
    for i in range(N):
        y = np.roll(base, 8 * i, axis=1)
        u = np.full((H // 2, W // 2), 124, np.uint8)
        v = np.full((H // 2, W // 2), 132, np.uint8)
        frames += [y.tobytes(), u.tobytes(), v.tobytes()]
    return b"".join(frames)


def fixture_clip(W, H, N, seed, roll=3):
    """tests/test_turbo.py:_clip (raw 4:2:0 bytes); with roll=2
    tests/test_device_encoder.py:_clip."""
    import numpy as np
    rng = np.random.default_rng(seed)
    base = np.clip(np.linspace(30, 200, W)[None, :] +
                   np.linspace(0, 50, H)[:, None] +
                   rng.integers(-10, 10, (H, W)), 0, 255).astype(np.uint8)
    out = []
    for i in range(N):
        f = np.roll(base, i * roll, axis=1)
        if i:
            f = np.clip(f.astype(np.int16) +
                        rng.integers(-2, 3, (H, W)), 0, 255
                        ).astype(np.uint8)
        u = np.clip(128 + rng.integers(-8, 8, (H // 2, W // 2)), 0,
                    255).astype(np.uint8)
        v = np.clip(128 + rng.integers(-8, 8, (H // 2, W // 2)), 0,
                    255).astype(np.uint8)
        out.append(f.tobytes() + u.tobytes() + v.tobytes())
    return b"".join(out)


# the clips of tests/conftest.py that phase 9 encodes (copies: the smoke
# imports nothing of tests/, whose conftest imports thor_tpu and jax;
# tests/test_torch_host.py holds them byte-equal)
def make_tiny64(n=6):
    """Deterministic 64x64 test clip (matches tests/golden generation)."""
    import numpy as np
    W = H = 64
    rng = np.random.default_rng(42)
    frames = []
    yy, xx = np.mgrid[0:H, 0:W]
    for t in range(n):
        y = ((xx * 3 + t * 7) % 256).astype(np.uint8)
        y[(yy + xx + t) % 17 == 0] = 30
        y[20:40, 10 + 2 * t:30 + 2 * t] = rng.integers(
            0, 256, size=(20, 20)).astype(np.uint8)
        u = ((yy[:H // 2, :W // 2] * 2 + t * 3) % 256).astype(np.uint8)
        v = np.full((H // 2, W // 2), 100 + t, dtype=np.uint8)
        frames.append(np.concatenate([y.ravel(), u.ravel(), v.ravel()]))
    return np.concatenate(frames).tobytes()


def make_hdb9(n=9):
    """128x96 clip for HDB/RA/HBD encoder tests."""
    import numpy as np
    W, H = 128, 96
    rng = np.random.default_rng(55)
    yy, xx = np.mgrid[0:H, 0:W]
    fr = []
    for t in range(n):
        y = ((xx * 2 + yy + t * 3) % 256).astype(np.uint8)
        y[10:50, 10 + 3 * t:60 + 3 * t] = rng.integers(
            0, 256, (40, 50)).astype(np.uint8)
        u = ((xx[:H // 2, :W // 2] + 2 * t) % 256).astype(np.uint8)
        v = ((yy[:H // 2, :W // 2] * 3 - t) % 256).astype(np.uint8)
        fr.append(np.concatenate([y.ravel(), u.ravel(), v.ravel()]))
    return np.concatenate(fr).tobytes()


def make_c444(n=4):
    """128x96 4:4:4 clip (c444_128's)."""
    import numpy as np
    W, H = 128, 96
    yy, xx = np.mgrid[0:H, 0:W]
    fr = []
    for t in range(n):
        y = ((xx * 2 + yy + t * 3) % 256).astype(np.uint8)
        u = ((xx + t) % 256).astype(np.uint8)
        v = ((yy * 2 - t) % 256).astype(np.uint8)
        fr.append(np.concatenate([y.ravel(), u.ravel(), v.ravel()]))
    return np.concatenate(fr).tobytes()


# phase 9: the exact encoder's golden encodes (name, clip generator, W, H,
# frames, config file in tests/golden, parameters over it, turbo) and the
# mixed configuration of tests/test_torch_turbo.py (turbo I/P frames,
# host-RDO interp_ref=2 B frames, CDEF on), held to its fixture
EXACT_GOLDENS = (
    ("tiny64_ldblc", make_tiny64, 64, 64, 6, "LDB_low_complexity", {}, 0),
    # every frame falls back from turbo: the golden all the same
    ("c444_128", make_c444, 128, 96, 4, "LDB_low_complexity",
     {"subsample": 444}, 1),
    ("hdb9_128", make_hdb9, 128, 96, 9, "HDB_low_complexity", {}, 0))
MIXED = ("ra_ir2_cdef", 128, 96, 10, 5,
         dict(TURBO_FIXTURES["ra_bframes"][4], interp_ref=2, cdef=2))


def lc1080_params(N=6):
    from thor_tpu_torch.enc.params import EncParams
    return EncParams(width=W1080, height=H1080, num_frames=N, turbo=1,
                     **LC_KW)


# torch operations that only re-view a tensor: no kernel runs for them
VIEW_OPS = {"view", "_unsafe_view", "expand", "permute", "slice", "select",
            "t", "transpose", "as_strided", "unsqueeze", "squeeze", "detach",
            "lift_fresh", "alias", "reshape", "unbind", "split", "chunk",
            "_reshape_alias", "narrow", "diagonal", "unfold"}


def count_ops(targets, run):
    """Runs run() and returns, for each (module, name) in targets, the
    torch operations each call of that function dispatched, views left
    out (each other operation is about one kernel launch on the card;
    a call's count includes the functions it calls)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ not in VIEW_OPS:
                self.n += 1
            return func(*args, **(kwargs or {}))

    counts = {name: [] for _, name in targets}
    saved = [(m, name, getattr(m, name)) for m, name in targets]

    def wrap(fn, name):
        def counted(*args, **kw):
            with Count() as c:
                r = fn(*args, **kw)
            counts[name].append(c.n)
            return r
        return counted

    for m, name, fn in saved:
        setattr(m, name, wrap(fn, name))
    try:
        run()
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
    return counts


def hold_and_time(name, calls, card, what):
    """A kernel wrapper (mc_luma_cells or the one-plane mc_chroma_cells) on
    the argument tuples a path gave it, each against its plain version
    (max_abs_err 0), then the first call timed beside its bound.  These
    launches are outside any path's count."""
    import torch
    from thor_tpu_torch.ops import mc as MC
    luma = name == "mc_luma_cells"
    fn, plain = ((MC.mc_cells_luma, MC.mc_cells_luma_plain) if luma else
                 (MC.mc_cells_chroma, MC.mc_cells_chroma_plain))
    errs = []
    for a in calls:
        got = fn(*a)
        torch.cuda.synchronize()
        errs.append(max_err(got, plain(*a)))
    if max(errs) != 0:
        raise AssertionError(f"{what}: {name} disagrees with its plain "
                             f"version")
    args = calls[0]
    keys = ("rsel", "y0", "x0", "op", "vf", "hf") + (("fs",) if luma
                                                      else ())
    cells = dict(zip(keys, args[1:1 + len(keys)]))
    k1, p1 = device_ms(lambda: fn(*args)), device_ms(
        lambda: plain(*args), reps=4)
    k2, p2 = device_ms(lambda: fn(*args)), device_ms(
        lambda: plain(*args), reps=4)
    nbytes, b_ms, by = bound(cells, args[0], luma, 1)
    r = {"max_abs_err": max(errs), "ms": min(k1, k2),
         "plain_ms": min(p1, p2), "bytes": nbytes, "bound_ms": b_ms,
         "bound_by": by, "share": b_ms / min(k1, k2),
         "cells": int(cells["y0"].shape[0]),
         "references": int(args[0].shape[0])}
    print(f"{what} ({r['cells']} cells over {r['references']} reference "
          f"planes): max_abs_err {errs}; kernel {r['ms']:.6f} ms, plain "
          f"{r['plain_ms']:.4f} ms; {nbytes} bytes, bound "
          f"{b_ms * 1e3:.3f} us ({by}), share {r['share']:.3f}; card "
          f"{card}", flush=True)
    return r


def phase_turbo(device, card, N=3):
    """Phase 8: the turbo encoder at 1080p on the card (see the module
    docstring), on the first N frames of the clip; returns the launches
    over the 1080p encode and the two kernels' results on frame 1's
    finalizer cells."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from thor_tpu_torch import decode_stream, encode_sequence
    from thor_tpu_torch.dec import device_pixels as DP
    from thor_tpu_torch.enc import encoder as PE
    from thor_tpu_torch.enc import filters_rdo as FR
    from thor_tpu_torch.enc import turbo as PT
    from thor_tpu_torch.enc import turbo_final as PF
    from thor_tpu_torch.enc import turbo_native as TN
    from thor_tpu_torch.enc.params import EncParams
    from thor_tpu_torch.ops import mc as MC

    yuv = lc1080_clip(N)
    stage = {k: [] for k in ("decide", "plan", "finalize", "pull", "emit",
                             "tail")}
    # the filter tail's parts, summed per frame
    tail_parts = {k: [0.0] * N for k in ("deblock", "clpf_search",
                                          "clpf_apply")}
    segments, calls = [], {"luma": [], "chroma": []}
    orig = {"decide": (PT, "decide_frame"), "plan": (TN, "plan_frame"),
            "finalize": (PF, "finalize_core"), "pull": (PF, "_pull"),
            "emit": (TN, "emit_frame"),
            "tail": (PE.Encoder, "_encode_frame_tail"),
            "deblock": (PE.Encoder, "_deblock_device"),
            "clpf_search": (FR, "clpf_test_frame"),
            "clpf_apply": (PE.Encoder, "_clpf_apply"),
            "luma": (DP, "mc_cells_luma"), "chroma": (DP, "mc_cells_chroma"),
            "frame": (PE.Encoder, "encode_frame")}
    saved = {k: getattr(m, a) for k, (m, a) in orig.items()}

    def timed(key, sync=False):
        fn = saved[key]

        def run(*args, **kw):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*args, **kw)
            if sync:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if key in tail_parts:     # host results: no sync needed
                tail_parts[key][len(stage["decide"]) - 1] += dt
            else:
                stage[key].append(dt)
            if key == "finalize":     # finalize_core's segcls argument
                segments.append(int((np.asarray(args[11]) > 0).sum()))
            return r
        return run

    def captured(key):
        fn = saved[key]

        def run(*args):
            if len(stage["decide"]) == 2:     # frame 1, the first P frame
                calls[key].append(args)
            return fn(*args)
        return run

    times = []

    def prog(fn, ft, stats):
        times.append(time.time())

    # frame 1, the first P frame, runs under torch.profiler (frames 2..
    # give the steady fps)
    prof_out = {}

    def traced(self):
        if self.fi.frame_num != 1:
            return saved["frame"](self)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            r = saved["frame"](self)
            torch.cuda.synchronize()
            prof_out["s"] = time.perf_counter() - t1
        prof_out["prof"] = prof
        return r

    wrappers = {k: timed(k, sync=(k == "finalize"))
                for k in list(stage) + list(tail_parts)}
    wrappers.update(luma=captured("luma"), chroma=captured("chroma"),
                    frame=traced)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(MC)
    for k, (m, a) in orig.items():
        setattr(m, a, wrappers[k])
    t0 = time.time()
    try:
        bs, rec = encode_sequence(lc1080_params(N), yuv, progress=prog,
                                  device=device)
    finally:
        for k, (m, a) in orig.items():
            setattr(m, a, saved[k])
    wall = time.time() - t0
    launches = read_launches(MC)
    peak = torch.cuda.max_memory_allocated() / 2**20
    digests = (hashlib.sha256(bs).hexdigest(),
               hashlib.sha256(rec).hexdigest())
    want = (LC1080_STREAM_SHA256[N], LC1080_REC_SHA256[N])
    if digests != want:
        raise AssertionError(f"1080p turbo stream/recon sha256 {digests} != "
                             f"the reference's {want}")
    counts = [len(v) for v in stage.values()]
    if any(c != N for c in counts):
        raise AssertionError(f"stages per frame {counts}, expected {N} "
                             f"each (the C plan walk took every frame?)")
    check_launches(launches, "turbo_encode")
    times.insert(0, t0)
    deltas = [b - a for a, b in zip(times, times[1:])]
    steady = deltas[2:] if len(deltas) > 3 else deltas
    fps = len(steady) / sum(steady)
    print(f"phase 8: 1080p turbo LC encode ({N} frames, {len(bs)} bytes): "
          f"stream and recon sha256 equal thor_tpu's; steady fps "
          f"{fps:.4f} (bench.py's frames 2..), whole encode {wall:.3f} s; "
          f"per-frame s {[round(d, 4) for d in deltas]}; peak device memory "
          f"{peak:.1f} MiB; launches {launches}; card {card}", flush=True)
    for k, v in list(stage.items()) + [("tail: " + k, v)
                                       for k, v in tail_parts.items()]:
        print(f"phase 8: per-frame s in {k}: {[round(t, 4) for t in v]}",
              flush=True)
    print(f"phase 8: intra wave segments per frame: {segments}", flush=True)

    t0 = time.time()
    _, frames = decode_stream(bs, device=device)
    if b"".join(frames) != rec:
        raise AssertionError("the port's decoder on the card does not "
                             "reproduce the turbo encoder's recon")
    print(f"phase 8: the port's decoder on the card decodes the stream to "
          f"the encoder's recon ({time.time() - t0:.3f} s)", flush=True)

    # the kernels against their plain versions on frame 1's finalizer
    # calls (the luma kernel once, the one-plane chroma kernel for U and
    # V), then timed there; these launches are outside the counts above
    if len(calls["luma"]) != 1 or len(calls["chroma"]) != 2:
        raise AssertionError(f"frame 1's finalizer made {len(calls['luma'])}"
                             f" luma and {len(calls['chroma'])} chroma calls"
                             f", expected 1 and 2")
    res = {"mc_luma_cells": hold_and_time(
               "mc_luma_cells", calls["luma"], card,
               "phase 8: mc_luma_cells on frame 1's finalizer cells"),
           "mc_chroma_cells": hold_and_time(
               "mc_chroma_cells", calls["chroma"], card,
               "phase 8: mc_chroma_cells on frame 1's finalizer cells")}

    ev = [e for e in prof_out["prof"].key_averages()
          if e.device_time_total > 0]
    if not ev:
        raise AssertionError("torch.profiler saw no device work in frame 1")
    busy = sum(e.device_time_total for e in ev) / 1e6
    top = sorted(ev, key=lambda e: -e.device_time_total)[:6]
    profiled = {"frame_s": prof_out["s"], "kernels": sum(e.count for e in ev),
                "device_busy_s": busy,
                "idle_share": 1 - busy / prof_out["s"],
                "top": [[e.key[:50], e.count, e.device_time_total / 1e6]
                        for e in top]}
    print(f"phase 8: frame 1 (P) under torch.profiler: {json.dumps(profiled)}"
          f"; card {card}", flush=True)

    # the test configurations on the card, against thor_tpu's streams
    with open(os.path.join(REPO, "tests", "torch_turbo",
                           "fixtures.json")) as f:
        meta = json.load(f)
    # the LC configuration with the torch operations of each function of
    # the encoder counted per call (ROADMAP.md's launch counts)
    # (the ops functions are counted where the encoder's modules bound
    # them by name)
    targets = [(PT, f) for f in (
        "decide_frame", "scale2", "prepass_half", "refine16", "upsize_mv",
        "eval_inter", "eval_skip", "eval_intra", "eval_bipred",
        "quantize_batch", "coeff_bits_batch", "fwd_transform_batch")] + [
        (PF, "finalize_core"), (PF, "_coef_plane"),
        (PF, "_enc_intra_waves"), (PF, "quantize_batch"),
        (PF, "fwd_transform_batch"), (PE.Encoder, "_encode_frame_tail"),
        (PE.Encoder, "_deblock_device")]
    lc_segments = []
    waves = PF._enc_intra_waves

    def segments_of(*args, **kw):     # segcls is the 8th argument
        lc_segments.append(int((np.asarray(args[7]) > 0).sum()))
        return waves(*args, **kw)
    for name, (W, H, n, seed, kw) in TURBO_FIXTURES.items():
        with open(os.path.join(REPO, "tests", "torch_turbo",
                               name + ".bit"), "rb") as f:
            want = f.read()
        args = dict(LC_KW)
        args.update(kw)
        t0 = time.time()
        out = []

        def run():
            out[:] = encode_sequence(
                EncParams(width=W, height=H, num_frames=n, turbo=1, **args),
                fixture_clip(W, H, n, seed), device=device)
        if name == "lc":
            PF._enc_intra_waves = segments_of
            try:
                ops = {k: {"calls": len(v), "min": min(v), "max": max(v),
                           "total": sum(v)}
                       for k, v in count_ops(targets, run).items() if v}
            finally:
                PF._enc_intra_waves = waves
        else:
            run()
        got, rec = out
        if (got != want or hashlib.sha256(rec).hexdigest() !=
                meta[name]["rec_sha256"]):
            raise AssertionError(f"turbo configuration {name}: the card's "
                                 f"stream differs from thor_tpu's")
        print(f"phase 8: turbo configuration {name} ({W}x{H}, {n} frames) "
              f"on the card: stream byte-equal to thor_tpu's "
              f"({time.time() - t0:.3f} s)", flush=True)
    print(f"phase 8: torch operations per call (views left out) on the lc "
          f"configuration (an I and a P frame): {json.dumps(ops)}; intra "
          f"wave segments per frame {lc_segments}", flush=True)
    return launches, res, {"steady_fps": fps, "per_frame_s": deltas,
                           "stage_s": stage, "tail_parts_s": tail_parts,
                           "segments": segments,
                           "profiled_p_frame": profiled,
                           "lc_ops_per_call": ops,
                           "lc_segments": lc_segments}


def phase_exact(device, card):
    """Phase 9: the exact host-RDO encoder on the card (see the module
    docstring); returns the launches over the mixed encode and the
    per-encode results."""
    import contextlib
    import io
    import torch
    from thor_tpu_torch import decode_stream, encode_sequence
    from thor_tpu_torch.enc import encoder as PE
    from thor_tpu_torch.enc import filters_rdo as FR
    from thor_tpu_torch.enc import turbo as PT
    from thor_tpu_torch.enc.params import EncParams, parse_config_file
    from thor_tpu_torch.ops import mc as MC

    # a frame's parts: the whole encode_frame, turbo's decide + finalize
    # (turbo frames), the filter tail and, within it, its three filters
    # (each synchronised on both sides)
    parts = {"frame": (PE.Encoder, "encode_frame"),
             "turbo": (PT, "encode_frame_turbo"),
             "tail": (PE.Encoder, "_encode_frame_tail"),
             "deblock": (PE.Encoder, "_deblock_device"),
             "cdef_search": (FR, "cdef_search"),
             "cdef_apply": (FR, "apply_cdef_enc"),
             "clpf_search": (FR, "clpf_test_frame"),
             "clpf_apply": (PE.Encoder, "_clpf_apply")}
    saved = {k: getattr(m, a) for k, (m, a) in parts.items()}

    def encode(params, yuv):
        frames = []

        def timed(key):
            fn = saved[key]

            def run(*args, **kw):
                if key == "frame":
                    frames.append(dict.fromkeys(parts, 0.0))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = fn(*args, **kw)
                torch.cuda.synchronize()
                frames[-1][key] += time.perf_counter() - t0
                return r
            return run

        err = io.StringIO()
        reset_launches(MC)
        for k, (m, a) in parts.items():
            setattr(m, a, timed(k))
        t0 = time.time()
        try:
            with contextlib.redirect_stderr(err):
                bs, rec = encode_sequence(params, yuv, device=device)
        finally:
            for k, (m, a) in parts.items():
                setattr(m, a, saved[k])
        wall = time.time() - t0
        launches = read_launches(MC)
        sys.stderr.write(err.getvalue())
        per = []
        for fr in frames:
            route = "turbo" if fr["turbo"] else "host_rdo"
            body = fr["turbo"] if fr["turbo"] else fr["frame"] - fr["tail"]
            per.append({"route": route, "frame_s": fr["frame"],
                        ("turbo_s" if fr["turbo"] else "sb_loop_s"): body,
                        "tail_s": fr["tail"], "deblock_s": fr["deblock"],
                        "cdef_s": fr["cdef_search"] + fr["cdef_apply"],
                        "clpf_s": fr["clpf_search"] + fr["clpf_apply"],
                        **{k + "_s": fr[k] for k in (
                            "cdef_search", "cdef_apply", "clpf_search",
                            "clpf_apply")}})
        return bs, rec, per, launches, err.getvalue(), wall

    def report(name, n, per, launches, wall):
        routes = {r: sum(f["route"] == r for f in per)
                  for r in ("turbo", "host_rdo")}
        host = [f for f in per if f["route"] == "host_rdo"]
        mean = {k: statistics.fmean(f[k] for f in host)
                for k in host[0] if k != "route"} if host else {}
        print(f"phase 9: {name} ({n} frames, {wall:.3f} s): frames by route "
              f"{routes}; launches {launches}; mean s per host-RDO frame "
              f"{json.dumps(mean)}; card {card}", flush=True)
        for i, f in enumerate(per):
            print(f"phase 9: {name} frame {i} (coding order): "
                  f"{json.dumps(f)}", flush=True)
        return {"frames": n, "wall_s": wall, "routes": routes,
                "launches": launches, "host_rdo_mean_s": mean,
                "per_frame": per}

    out = {}
    gdir = os.path.join(REPO, "tests", "golden")
    for name, gen, W, H, n, cfg, over, turbo in EXACT_GOLDENS:
        with open(os.path.join(gdir, name + ".bit"), "rb") as f:
            want = f.read()
        with open(os.path.join(gdir, name + "_rec.yuv"), "rb") as f:
            want_rec = f.read()
        params = parse_config_file(
            os.path.join(gdir, f"config_{cfg}.txt"), width=W, height=H,
            num_frames=n, qp=32, frame_rate=30.0, turbo=turbo, **over)
        bs, rec, per, launches, err, wall = encode(params, gen(n))
        if bs != want or rec != want_rec:
            raise AssertionError(f"phase 9: {name}: the card's stream or "
                                 f"recon differs from the golden")
        falls = err.count("turbo unavailable for this frame")
        if falls != (1 if turbo else 0):
            raise AssertionError(f"phase 9: {name}: the fallback line was "
                                 f"printed {falls} times")
        if any(f["route"] != "host_rdo" for f in per) or len(per) != n:
            raise AssertionError(f"phase 9: {name}: a frame missed the "
                                 f"host RDO")
        check_launches(launches, "exact_encode")
        out[name] = report(name, n, per, launches, wall)
        t0 = time.time()
        _, frames = decode_stream(bs, device=device)
        if b"".join(frames) != rec:
            raise AssertionError(f"phase 9: {name}: the port's decoder on "
                                 f"the card does not reproduce the recon")
        print(f"phase 9: {name}: stream and recon byte-equal to the golden"
              f"{' (turbo=1, fallback said once)' if turbo else ''}; the "
              f"card's decoder reproduces the recon ({time.time() - t0:.3f}"
              f" s)", flush=True)

    name, W, H, n, seed, kw = MIXED
    with open(os.path.join(REPO, "tests", "torch_turbo",
                           "fixtures.json")) as f:
        meta = json.load(f)[name]
    args = dict(LC_KW)
    args.update(kw)
    bs, rec, per, launches, err, wall = encode(
        EncParams(width=W, height=H, num_frames=n, turbo=1, **args),
        fixture_clip(W, H, n, seed))
    if (hashlib.sha256(bs).hexdigest(), hashlib.sha256(rec).hexdigest()) \
            != (meta["stream_sha256"], meta["rec_sha256"]):
        raise AssertionError(f"phase 9: {name}: the card's stream or recon "
                             f"differs from thor_tpu's")
    routes = [f["route"] for f in per]
    if routes != ["turbo"] * 2 + ["host_rdo"] * 7 + ["turbo"]:
        raise AssertionError(f"phase 9: {name}: routes {routes}, expected "
                             f"turbo I/P frames and host-RDO B frames")
    check_launches(launches, "mixed_encode")
    out[name] = report(name, n, per, launches, wall)
    print(f"phase 9: {name}: stream and recon sha256 equal thor_tpu's "
          f"(turbo I/P, host-RDO B frames, CDEF on)", flush=True)
    return launches, out


def phase_device_enc(device, card, frames=1, count=False):
    """Phase 10: the wavefront device encoder (device_enc=1) on the card
    (see the module docstring): the first `frames` frames of phase 8's
    1080p clip through frame_megakernel's CUDA graphs, then the
    DEVENC_FIXTURES configurations (lc128 also through the host loop,
    edges264 twice: the second encode replays the first one's graphs),
    with the MC launches taken over these encodes; with `count`, the
    torch operations per call of each body kind on diagonal
    COUNT_DIAGONAL of the 1080p frame 1, through the host loop's
    run_diagonal and through the graph's diagonal_body.  Returns the
    launches and the results."""
    import types
    import torch
    from torch.profiler import ProfilerActivity, profile
    from thor_tpu_torch import decode_stream, encode_sequence
    from thor_tpu_torch.enc import device_lc as D
    from thor_tpu_torch.enc import encoder as PE
    from thor_tpu_torch.enc.params import EncParams
    from thor_tpu_torch.ops import mc as MC

    G = D.DiagonalGraph
    parts = {"consts": (D, "build_frame_consts"),
             "megakernel": (D, "frame_megakernel"),
             "diagonals": (D, "run_diagonal"),
             "warm_up": (G, "warm_up"), "capture": (G, "capture"),
             "instantiate": (G, "instantiate"), "replay": (G, "replay"),
             "pull": (D, "pull_frame"), "emit": (D, "emit_frame"),
             "tail": (PE.Encoder, "_encode_frame_tail"),
             "device_frame": (D, "encode_frame_device"),
             "frame": (PE.Encoder, "encode_frame")}
    saved = {k: getattr(m, a) for k, (m, a) in parts.items()}
    targets = [(D, f) for f in ("body_enter", "body_decide", "body_16sub",
                                "mode_decision", "me_lc",
                                "trial_encode_plane")]
    # per frame: seconds by part; seconds of each run_diagonal and each
    # replay; the graph pool's growth over a capture
    log, ops, traced = [], {}, {}

    def count_diagonal(fs, fc, org, tables, cfg, L, nsb):
        """The torch operations of diagonal COUNT_DIAGONAL through the
        host loop and through the graph's body, on a copy of the state
        (the count does not depend on the data)."""
        nsh, nsv = -(-cfg["w"] // D.SB), -(-cfg["h"] // D.SB)
        lanes, idx = D.wavefront(nsh, nsv)[COUNT_DIAGONAL]
        ns = types.SimpleNamespace(
            diagonal=lambda: saved["diagonals"](
                {k: v.clone() for k, v in fs.items()}, fc, cfg, org, lanes,
                idx, L, nsb),
            diagonal_body=lambda: D.diagonal_body(
                {k: v.clone() for k, v in fs.items()}, fc, cfg, org,
                tables[:, COUNT_DIAGONAL], L))
        ops.update(count_ops([(ns, "diagonal")] + targets,
                             lambda: ns.diagonal()))
        ops.update(count_ops([(ns, "diagonal_body")],
                             lambda: ns.diagonal_body()))

    def profiled(fn, args, kw):
        """One replay under torch.profiler: its seconds, the kernels the
        card ran and their device time."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*args, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        ev = [e for e in prof.key_averages() if e.device_time_total > 0]
        busy = sum(e.device_time_total for e in ev) / 1e6
        top = sorted(ev, key=lambda e: -e.device_time_total)[:5]
        traced.update({
            "diagonal": COUNT_DIAGONAL, "replay_s": dt,
            "kernels": sum(e.count for e in ev), "device_busy_s": busy,
            "idle_share": 1 - busy / dt,
            "top": [[e.key[:50], e.count, e.device_time_total / 1e6]
                    for e in top]})
        return r, dt

    def timed(key):
        fn = saved[key]

        def run(*args, **kw):
            if key == "frame":
                log.append((dict.fromkeys(list(parts) + ["profiler"], 0.0),
                            {"diagonals": [], "replay": []}, {}))
            f, calls, graph = log[-1]
            if key == "megakernel" and count and not ops and len(log) == 2:
                count_diagonal(*args)
            torch.cuda.synchronize()
            if key == "capture":
                torch.cuda.empty_cache()
                reserved = torch.cuda.memory_reserved()
            if (key == "replay" and not traced and len(log) == 1 and
                    len(calls["replay"]) == COUNT_DIAGONAL - 1):
                t0 = time.perf_counter()
                r, dt = profiled(fn, args, kw)
                # the trace's own cost (collecting and summing 0.3 M
                # kernel events) is kept apart from the frame's parts
                f["profiler"] += time.perf_counter() - t0 - dt
            else:
                t0 = time.perf_counter()
                r = fn(*args, **kw)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            f[key] += dt
            if key in calls:
                calls[key].append(dt)
            if key == "capture":
                graph["captures"] = graph.get("captures", 0) + 1
                graph["pool_mib"] = (torch.cuda.memory_reserved() -
                                     reserved) / 2**20
            return r
        return run

    def encode(W, H, n, yuv, megakernel=True):
        """encode_sequence on the card with the parts timed; returns the
        stream, the recon, the frames' logs and the seconds; every frame
        must take the device route, and on the graph route a frame that
        captures replays its D - 1 other diagonals, one that reuses a
        graph all D."""
        del log[:]
        for k, (m, a) in parts.items():
            setattr(m, a, timed(k))
        t0 = time.time()
        try:
            bs, rec = encode_sequence(
                EncParams(width=W, height=H, num_frames=n, device_enc=1,
                          **LC_KW), yuv, device=device,
                megakernel=megakernel)
        finally:
            for k, (m, a) in parts.items():
                setattr(m, a, saved[k])
        wall = time.time() - t0
        routes = {"device_lc": sum(f["device_frame"] > 0 for f, _, _ in log),
                  "host_rdo": sum(f["device_frame"] == 0 for f, _, _ in log)}
        if routes["device_lc"] != n or len(log) != n:
            raise AssertionError(f"phase 10: {W}x{H}: a frame missed the "
                                 f"device route: {routes}")
        nd = len(D.wavefront(-(-W // D.SB), -(-H // D.SB)))
        for f, calls, graph in log:
            caps = graph.get("captures", 0)
            want = ((0, 0, nd) if not megakernel else
                    (caps, nd - 1, 0) if caps == 1 or nd == 1 else
                    (0, nd, 0))
            if (caps, len(calls["replay"]), len(calls["diagonals"])) != want:
                raise AssertionError(
                    f"phase 10: {W}x{H}: {caps} captures, "
                    f"{len(calls['replay'])} replays and "
                    f"{len(calls['diagonals'])} host-loop diagonals in a "
                    f"frame of {nd} diagonals (megakernel={megakernel})")
        return bs, rec, list(log), routes, wall

    def frame_report(what, flog):
        """Per frame: seconds by part, the graph's captures and replays,
        seconds per replayed (or host-loop) diagonal."""
        per = []
        for i, (f, calls, graph) in enumerate(flog):
            rep = calls["replay"] or calls["diagonals"]
            r = {"frame_s": f["frame"], **{k + "_s": f[k] for k in (
                "consts", "megakernel", "warm_up", "capture", "instantiate",
                "replay", "diagonals", "pull", "emit", "tail", "profiler")},
                 "loop_s": sum(f[k] for k in ("warm_up", "capture",
                                              "instantiate", "replay",
                                              "diagonals")),
                 "captures": graph.get("captures", 0),
                 "replays": len(calls["replay"]),
                 "pool_mib": graph.get("pool_mib"),
                 "s_per_diagonal": rep}
            per.append(r)
            parts_s = {k: v for k, v in r.items() if k != "s_per_diagonal"}
            print(f"phase 10: {what} frame {i} s: {json.dumps(parts_s)}"
                  f"; s per {'replayed' if calls['replay'] else 'host-loop'}"
                  f" diagonal ({len(rep)}): {[round(t, 4) for t in rep]}",
                  flush=True)
        return per

    t_phase = time.time()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(MC)
    bs, rec, flog, routes, wall = encode(W1080, H1080, frames,
                                         lc1080_clip(frames))
    peak = torch.cuda.max_memory_allocated() / 2**20
    digests = (hashlib.sha256(bs).hexdigest(),
               hashlib.sha256(rec).hexdigest())
    want = (DEVENC1080_STREAM_SHA256[frames], DEVENC1080_REC_SHA256[frames])
    if digests != want:
        raise AssertionError(f"1080p device_enc=1 stream/recon sha256 "
                             f"{digests} != thor_tpu's {want}")
    print(f"phase 10: 1080p device_enc=1 encode through frame_megakernel's "
          f"CUDA graphs ({frames} frame(s), {len(bs)} bytes, {wall:.3f} s): "
          f"stream and recon sha256 equal the reference's ({digests[0]}); "
          f"frames by route {routes}; captures in this encode "
          f"{sum(g.get('captures', 0) for _, _, g in flog)}; peak device "
          f"memory {peak:.1f} MiB; card {card}", flush=True)
    per = frame_report("1080p", flog)
    if traced:
        print(f"phase 10: replay of diagonal {COUNT_DIAGONAL} of the 1080p "
              f"frame 0 under torch.profiler: {json.dumps(traced)}; card "
              f"{card}", flush=True)
    else:
        print("phase 10: no replay was traced", flush=True)

    # the test configurations (an I and a P frame each) against their
    # thor_tpu fixtures, inside the launch count: lc128 (one SB, one
    # diagonal: no graph) through both routes, edges264 (a P diagonal of
    # 2 lanes, 8-pixel right and bottom edges) twice through the graphs
    fix = os.path.join(REPO, "tests", "torch_device_lc")
    with open(os.path.join(fix, "fixtures.json")) as f:
        meta = json.load(f)
    small = {}
    runs = [(DEVENC_FIXTURES[0], True, "lc128"),
            (DEVENC_FIXTURES[0], False, "lc128 host loop"),
            (DEVENC_FIXTURES[1], True, "edges264"),
            (DEVENC_FIXTURES[1], True, "edges264 again")]
    for (name, W, H, n, seed), mk, what in runs:
        got, grec, glog, r, s = encode(W, H, n,
                                       fixture_clip(W, H, n, seed, roll=2),
                                       megakernel=mk)
        with open(os.path.join(fix, name + ".bit"), "rb") as f:
            want = f.read()
        if got != want or (hashlib.sha256(grec).hexdigest() !=
                           meta[name]["rec_sha256"]):
            raise AssertionError(f"phase 10: {what}: the card's stream or "
                                 f"recon differs from thor_tpu's")
        small[what] = {"wall_s": s, "routes": r,
                       "frames": frame_report(what, glog)}
        print(f"phase 10: {what} ({W}x{H}, {n} frames) on the card: stream "
              f"and recon equal thor_tpu's device route ({s:.3f} s); frames "
              f"by route {r}", flush=True)
    launches = read_launches(MC)
    print(f"phase 10: launches over these encodes {launches}", flush=True)
    check_launches(launches, "device_encode")

    t0 = time.time()
    _, dframes = decode_stream(bs, device=device)
    if b"".join(dframes) != rec:
        raise AssertionError("phase 10: the port's decoder on the card does "
                             "not reproduce the device encoder's recon")
    print(f"phase 10: the port's decoder on the card decodes the 1080p "
          f"stream to the encoder's recon ({time.time() - t0:.3f} s)",
          flush=True)
    phase_s = time.time() - t_phase
    print(f"phase 10: {phase_s:.3f} s in all", flush=True)
    out = {"frames": frames, "wall_s": wall, "stream_sha256": digests[0],
           "phase_s": phase_s, "routes": routes, "launches": launches,
           "peak_mib": peak, "per_frame": per, "traced_replay": traced,
           "small": small}
    if count:
        if not ops:
            raise AssertionError("phase 10: no diagonal was counted")
        out["counted_diagonal"] = [1, COUNT_DIAGONAL]
        out["ops_per_call"] = {k: {"calls": len(v), "min": min(v),
                                   "max": max(v), "total": sum(v)}
                               for k, v in ops.items() if v}
        print(f"phase 10: torch operations per call on diagonal "
              f"{COUNT_DIAGONAL} of the 1080p frame 1, through the host "
              f"loop (run_diagonal) and the graph's body (diagonal_body) "
              f"(views left out; frame 1's seconds above include the "
              f"counting): {json.dumps(out['ops_per_call'])}", flush=True)
    return launches, out


def phase_multistream(device, card, solo_times=None):
    """Phase 11: the multi-stream paths on the card (see the module
    docstring); returns the launches of each path and the results."""
    import torch
    from thor_tpu_torch import decode_stream, entry as PEN
    from thor_tpu_torch.dec import decoder as PD
    from thor_tpu_torch.dec import device_pixels as DP
    from thor_tpu_torch.dec import multistream as MS
    from thor_tpu_torch.enc import encoder as PE
    from thor_tpu_torch.enc import gop_lanes as GL
    from thor_tpu_torch.enc import turbo as PT
    from thor_tpu_torch.enc import turbo_final as PF
    from thor_tpu_torch.enc.gop_lanes import encode_sequence_lanes
    from thor_tpu_torch.enc.multistream import encode_streams_sharded
    from thor_tpu_torch.enc.params import EncParams
    from thor_tpu_torch.models import pipeline as PP
    from thor_tpu_torch.ops import mc as MC
    from thor_tpu_torch.ops import tempinterp as PTI
    out, launches = {}, {}
    t_phase = time.time()

    # (a) the bench stream twice in lockstep, its P frames batched
    with open(BENCH_STREAM, "rb") as f:
        data = f.read()
    times = {0: [], 1: []}
    batch_calls = {"luma": [], "chroma": []}
    batches = []     # the stream count of each frame_exec_batch call
    orig = (PD.Decoder.decode_frame, DP.mc_cells_luma, DP.mc_cells_chroma,
            DP.frame_exec_batch)

    def timed(self, s, n):
        t0 = time.time()
        r = orig[0](self, s, n)
        times[self.stream_id].append(time.time() - t0)
        return r

    def captured(key, fn):
        def run(*args):
            if len(batches) == 1:     # the first batch: frame 1's cells
                batch_calls[key].append(args)
            return fn(*args)
        return run

    def counted(batch, **kw):
        batches.append(len(batch))
        return orig[3](batch, **kw)

    torch.cuda.synchronize()
    reset_launches(MC)
    PD.Decoder.decode_frame = timed
    DP.mc_cells_luma = captured("luma", orig[1])
    DP.mc_cells_chroma = captured("chroma", orig[2])
    DP.frame_exec_batch = counted
    t0 = time.time()
    try:
        outs = MS.decode_streams_sharded([data, data], device)
    finally:
        (PD.Decoder.decode_frame, DP.mc_cells_luma, DP.mc_cells_chroma,
         DP.frame_exec_batch) = orig
    wall = time.time() - t0
    launches["multistream_decode"] = read_launches(MC)
    for frames in outs:
        digest = hashlib.sha256(b"".join(frames)).hexdigest()
        if digest != BENCH_REC_SHA256:
            raise AssertionError(f"phase 11: a stream of the pair decode: "
                                 f"sha256 {digest} != {BENCH_REC_SHA256}")
    if batches != [2] * (len(outs[0]) - 1):
        raise AssertionError(f"phase 11: executor batches {batches}, "
                             f"expected one of 2 streams per P frame")
    check_launches(launches["multistream_decode"], "multistream_decode")
    pair = [max(a, b) for a, b in zip(times[0], times[1])]
    print(f"phase 11: the 1080p bench stream twice in lockstep: both "
          f"outputs hash to BENCH_REC_SHA256; {len(batches)} batches of "
          f"{batches[0]} streams; per-frame s of the pair "
          f"{[round(t, 4) for t in pair]}"
          f" (solo fused=False, phase 7: "
          f"{[round(t, 4) for t in solo_times or []]}); whole pair "
          f"{wall:.3f} s; launches {launches['multistream_decode']}; card "
          f"{card}", flush=True)
    if len(batch_calls["luma"]) != 1 or len(batch_calls["chroma"]) != 2:
        raise AssertionError(f"phase 11: frame 1's batch made "
                             f"{len(batch_calls['luma'])} luma and "
                             f"{len(batch_calls['chroma'])} chroma calls")
    out["multistream_decode"] = {
        "per_frame_s": pair, "solo_per_frame_s": solo_times,
        "wall_s": wall, "batches": batches,
        "cells": {"mc_luma_cells": hold_and_time(
                      "mc_luma_cells", batch_calls["luma"], card,
                      "phase 11: mc_luma_cells on the pair's frame-1 batch"),
                  "mc_chroma_cells": hold_and_time(
                      "mc_chroma_cells", batch_calls["chroma"], card,
                      "phase 11: mc_chroma_cells on the pair's frame-1 "
                      "batch")}}
    del batch_calls, outs

    # (b) the tile pipeline's multi-stream steps at 1080p, 2 streams
    steps = [("multi_stream_step",) + PP.multi_stream_step(
                 device, height=H1080, width=W1080, streams=2),
             ("multi_stream_full",) + PP.multi_stream_full(
                 device, height=H1080, width=W1080, streams=2)]
    for _, step, args in steps:      # warm up
        step(*args)
    torch.cuda.synchronize()
    reset_launches(MC)
    got, ms = [], []
    for _, step, args in steps:
        t0 = time.perf_counter()
        got.append(step(*args))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    launches["multistream_pipeline"] = read_launches(MC)
    for (what, step, args), g, t in zip(steps, got, ms):
        want = step(*[a.cpu() for a in args])
        err = max_err([x.cpu() for x in g], want)
        if err != 0 or any(x.shape != w.shape for x, w in zip(g, want)):
            raise AssertionError(f"phase 11: {what}: the card's result "
                                 f"differs from the CPU's")
        print(f"phase 11: {what} {W1080}x{H1080}, 2 streams: {t:.3f} ms on "
              f"the card, max_abs_err 0 against the CPU; card {card}",
              flush=True)
    check_launches(launches["multistream_pipeline"], "multistream_pipeline")
    print(f"phase 11: multi-stream pipeline launches "
          f"{launches['multistream_pipeline']}", flush=True)
    out["multistream_pipeline"] = {"ms": dict(zip(
        ("multi_stream_step", "multi_stream_full"), ms))}
    del steps, got

    # (c) the GOP-lane encode at 1080p (the dry run's RA GOP4 parameters)
    N = 5
    yuv = lc1080_clip(N)
    stage = {k: [] for k in ("decide", "prefetch", "resolve", "finalize",
                             "tail", "interpolate")}
    parts = {"decide": (PT, "decide_frame"),
             "prefetch": (GL, "decide_frame"),
             "resolve": (PT.PendingDecision, "resolve"),
             "finalize": (PF, "finalize_core"),
             "tail": (PE.Encoder, "_encode_frame_tail"),
             "interpolate": (PTI, "interpolate_frames")}
    saved = {k: getattr(m, a) for k, (m, a) in parts.items()}

    def timed_part(key):
        fn = saved[key]

        def run(*args, **kw):
            if key == "finalize":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*args, **kw)
            if key == "finalize":
                torch.cuda.synchronize()
            stage[key].append(time.perf_counter() - t0)
            return r
        return run

    frame_t = []
    torch.cuda.synchronize()
    reset_launches(MC)
    for k, (m, a) in parts.items():
        setattr(m, a, timed_part(k))
    t0 = time.time()
    try:
        bs, rec, stats = encode_sequence_lanes(
            EncParams(width=W1080, height=H1080, num_frames=N,
                      **PEN.LANES_KW), yuv,
            progress=lambda *a: frame_t.append(time.time()),
            devices=[device])
    finally:
        for k, (m, a) in parts.items():
            setattr(m, a, saved[k])
    wall = time.time() - t0
    launches["lanes_encode"] = read_launches(MC)
    digests = (hashlib.sha256(bs).hexdigest(),
               hashlib.sha256(rec).hexdigest())
    if digests != (LANES1080_STREAM_SHA256, LANES1080_REC_SHA256):
        raise AssertionError(f"phase 11: 1080p lane encode sha256 {digests}"
                             f" != thor_tpu's ({LANES1080_STREAM_SHA256}, "
                             f"{LANES1080_REC_SHA256})")
    if stats["max_in_flight"] < 2:
        raise AssertionError(f"phase 11: lane encode {stats}")
    check_launches(launches["lanes_encode"], "lanes_encode")
    frame_t.insert(0, t0)
    deltas = [b - a for a, b in zip(frame_t, frame_t[1:])]
    print(f"phase 11: 1080p GOP-lane encode ({N} frames, RA GOP4, "
          f"{len(bs)} bytes): stream and recon sha256 equal thor_tpu's "
          f"sequential turbo encode; {stats}; whole encode {wall:.3f} s; "
          f"per-frame s (coding order) {[round(d, 4) for d in deltas]}; "
          f"launches {launches['lanes_encode']}; card {card}", flush=True)
    for k, v in stage.items():
        print(f"phase 11: lane encode s per call in {k}: "
              f"{[round(t, 4) for t in v]}", flush=True)
    t0 = time.time()
    _, frames = decode_stream(bs, device=device)
    if b"".join(frames) != rec:
        raise AssertionError("phase 11: the port's decoder on the card does "
                             "not reproduce the lane encode's recon")
    print(f"phase 11: the port's decoder on the card decodes the lane "
          f"encode to its recon ({time.time() - t0:.3f} s)", flush=True)
    out["lanes_encode"] = {"stats": stats, "wall_s": wall,
                           "per_frame_s": deltas, "stage_s": stage}
    del yuv, frames

    # (d) two fixture encodes at once, beside the same encodes alone
    with open(os.path.join(REPO, "tests", "torch_turbo",
                           "fixtures.json")) as f:
        meta = json.load(f)
    names = ("lc", "qmtx")
    jobs = []
    for name in names:
        W, H, n, seed, kw = MULTI_FIXTURES[name]
        jobs.append((lambda W=W, H=H, n=n, kw=kw: EncParams(
            width=W, height=H, num_frames=n, turbo=1, **dict(LC_KW, **kw)),
            fixture_clip(W, H, n, seed)))

    def one_by_one():
        t0 = time.time()
        for make, yuv in jobs:
            encode_sequence_lanes(make(), yuv, devices=[device])
        return time.time() - t0

    def together():
        t0 = time.time()
        res = encode_streams_sharded([(make(), yuv) for make, yuv in jobs],
                                     devices=[device], lanes=True)
        return time.time() - t0, res

    # in turns: one by one, together, together, one by one; the launches
    # are those of the first run together
    solo = [one_by_one()]
    torch.cuda.synchronize()
    reset_launches(MC)
    both, res = together()
    launches["multistream_encode"] = read_launches(MC)
    both = [both, together()[0]]
    solo.append(one_by_one())
    for name, (bs, rec) in zip(names, res):
        with open(os.path.join(REPO, "tests", "torch_turbo",
                               name + ".bit"), "rb") as f:
            want = f.read()
        if (bs != want or hashlib.sha256(rec).hexdigest() !=
                meta[name]["rec_sha256"]):
            raise AssertionError(f"phase 11: the multi-stream encode's "
                                 f"{name} differs from thor_tpu's stream")
    check_launches(launches["multistream_encode"], "multistream_encode")
    print(f"phase 11: encode_streams_sharded of {list(names)} with lanes: "
          f"both streams equal thor_tpu's; in turns {solo[0]:.3f} s one "
          f"after the other, {both[0]:.3f} and {both[1]:.3f} s at once, "
          f"{solo[1]:.3f} s one after the other; launches "
          f"{launches['multistream_encode']}; "
          f"card {card}", flush=True)
    out["multistream_encode"] = {"together_s": both, "one_by_one_s": solo}

    # (e) the multi-stream dry run on the card
    t0 = time.time()
    PEN.dryrun_multistream(2, device)
    out["dryrun_s"] = time.time() - t0
    out["phase_s"] = time.time() - t_phase
    print(f"phase 11: dryrun_multistream on the card passed "
          f"({out['dryrun_s']:.3f} s); phase 11 {out['phase_s']:.3f} s in "
          f"all", flush=True)
    return launches, out


def bench_frames(n, device):
    """The first n frames of the bench stream: its first n frame units
    (the first holds the sequence header too) decoded with fused=False;
    the stream is low-delay, so these are display frames 0..n-1."""
    from thor_tpu_torch import decode_stream
    from thor_tpu_torch.bitstream import FrameUnitReader
    with open(BENCH_STREAM, "rb") as f:
        data = f.read()
    fur = FrameUnitReader(data)
    for _ in range(n):
        fur.next_frame()
    _, frames = decode_stream(data[:fur.off], device=device, fused=False)
    return frames


def me1080_inputs(frames):
    """Phase 12's inputs, numpy arrays: {search: (function of
    thor_tpu_torch.ops.me_batch and of thor_tpu.ops.me_batch, positional
    arguments, keywords)}.  The 16x16 blocks of frame 1 (8,160) search
    frame 0, padded by PADDING_Y as the encoder pads its references
    (frame.py:YuvFrame.pad_frame); frame 2 is the bi-prediction search's
    second reference; the sync search takes the 8x8 sub-PUs at offsets 0
    and 8 of every 16x16 parent (32,640).  MV predictors, lambdas
    (float64, 1-8), candidates and counts come from
    default_rng(ME1080_SEED)."""
    import numpy as np
    from thor_tpu_torch.frame import YuvFrame
    from thor_tpu_torch.tables import PADDING_Y
    W, H = W1080, H1080
    i32 = np.int32

    def luma(k):
        return np.frombuffer(frames[k], np.uint8, W * H).reshape(H, W)

    def padded(k):
        fr = YuvFrame(W, H, 420, PADDING_Y, 8, 8)
        fr.y[:] = luma(k)
        fr.pad_frame()
        return fr.y_full.astype(i32)

    def blocks(b):
        n = (H // b) * (W // b)
        org = luma(1).astype(i32).reshape(H // b, b, W // b, b)
        return org.transpose(0, 2, 1, 3).reshape(n, b, b)

    rng = np.random.default_rng(ME1080_SEED)
    org = blocks(16)
    n = org.shape[0]
    ys = np.repeat(np.arange(0, H, 16, dtype=i32), W // 16)
    xs = np.tile(np.arange(0, W, 16, dtype=i32), H // 16)
    mvp = rng.integers(-20, 21, (n, 2)).astype(i32)
    lam = rng.uniform(1.0, 8.0, n)
    cand = rng.integers(-12, 13, (n, 4, 2)).astype(i32)
    cn = rng.integers(1, 5, n).astype(i32)
    bi_cn = rng.integers(0, 5, n).astype(i32)
    ref0, ref1 = padded(0), padded(2)
    geo = dict(width=16, height=16, size=16, sign=0, fwidth=W, fheight=H,
               bitdepth=8)
    mvc = dict(mvc_y=ME1080_MVC[0], mvc_x=ME1080_MVC[1])
    me = (org, ref0, PADDING_Y, ys, xs, mvp[:, 0], mvp[:, 1], lam,
          cand[:, :, 0], cand[:, :, 1], cn)
    out = {
        "me_fast": ("motion_estimate_batch", me, dict(geo, maxcand=4)),
        "me_telescope": ("motion_estimate_batch", me, dict(
            geo, maxcand=4, telescope=True, widesad32=True, **mvc)),
        "me_speed0": ("motion_estimate_batch", me, dict(
            geo, maxcand=4, telescope=True, speed0=True, bipred=0, **mvc)),
        "me_bi": ("motion_estimate_bi_batch",
                  (org, ref0, ref1, PADDING_Y, ys, xs, mvp[:, 0], mvp[:, 1],
                   lam, cand[:, :, 0], cand[:, :, 1], bi_cn),
                  dict(geo, bipred=1, **mvc))}
    # the sync search: sub-PU k of parent p at row 4 * p + k, offsets
    # (8 * (k >> 1), 8 * (k & 1)); slots 4 and 5 hold mvp and 0
    sub = blocks(8).reshape(H // 16, 2, W // 16, 2, 8, 8).transpose(
        0, 2, 1, 3, 4, 5).reshape(4 * n, 8, 8)
    k = np.tile(np.arange(4, dtype=i32), n)
    smvp = rng.integers(-12, 13, (4 * n, 2)).astype(i32)
    scand = rng.integers(-10, 11, (4 * n, 6, 2)).astype(i32)
    scand[:, 4] = smvp
    scand[:, 5] = 0
    out["me_sync"] = ("motion_estimate_sync_batch", (
        sub, ref0, PADDING_Y, np.repeat(ys, 4), np.repeat(xs, 4),
        8 * (k >> 1), 8 * (k & 1), smvp[:, 0], smvp[:, 1],
        rng.uniform(1.0, 8.0, 4 * n), scand[:, :, 0], scand[:, :, 1]),
        dict(geo, width=8, height=8, bipred=0, **mvc))
    return out


def me_digest(sad, mv_y, mv_x):
    """sha256 of a search's output: sad as little-endian int64, then mv_y
    and mv_x as little-endian int32."""
    import numpy as np
    return hashlib.sha256(b"".join(
        np.ascontiguousarray(np.asarray(a), dt).tobytes()
        for a, dt in ((sad, "<i8"), (mv_y, "<i4"), (mv_x, "<i4")))
    ).hexdigest()


def phase_me(device, card, frames):
    """Phase 12: thor_tpu's lockstep motion search on the card at 1080p
    (see the module docstring); returns the launches of each search and
    K1's result on the first bi_sad call's cells."""
    import torch
    from thor_tpu_torch.ops import mc as MC
    from thor_tpu_torch.ops import me_batch as ME
    t_phase = time.time()
    inputs = me1080_inputs(frames)
    launches, out, luma_calls = {}, {}, []
    kernel = MC.mc_cells_luma
    seen = [0]

    def captured(*args):
        if seen[0] in ME1080_HELD:
            luma_calls.append(args)
        seen[0] += 1
        return kernel(*args)

    for name, (fn, args, kw) in inputs.items():
        args = [torch.as_tensor(a, device=device) if hasattr(a, "shape")
                else a for a in args]

        def run():
            return getattr(ME, fn)(*args, **kw)
        torch.cuda.synchronize()
        reset_launches(MC)
        if name == "me_bi":
            MC.mc_cells_luma = captured
        try:
            res = run()
            torch.cuda.synchronize()
        finally:
            MC.mc_cells_luma = kernel
        launches[name] = read_launches(MC)
        digest = me_digest(*(t.cpu().numpy() for t in res))
        if digest != ME1080_SHA256[name]:
            raise AssertionError(f"phase 12: {name}: sha256 {digest}, not "
                                 f"the reference {ME1080_SHA256[name]}")
        check_launches(launches[name], name)
        # seconds of one call, synchronised on both sides, then the torch
        # operations of one call (views left out)
        secs = []
        for _ in range(2):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        ops = count_ops([(ME, fn)], run)[fn]
        out[name] = {"s": min(secs), "s_calls": secs, "ops": ops[0],
                     "blocks": int(args[0].shape[0]),
                     "launches": launches[name]}
        print(f"phase 12: {name} ({fn}, {out[name]['blocks']} blocks of "
              f"{kw['width']}x{kw['height']}): sha256 equals thor_tpu's; "
              f"{min(secs):.4f} s a call (synchronised; calls {secs}); "
              f"{ops[0]} torch operations a call; launches "
              f"{launches[name]}; card {card}", flush=True)
    # K1 against its plain version on one bi_sad call's two MC calls
    # (8,160 blocks of 16 cells each; ME1080_HELD), timed on the first
    if len(luma_calls) != len(ME1080_HELD):
        raise AssertionError(f"phase 12: the bi-prediction search made "
                             f"{seen[0]} luma calls, expected "
                             f"{ME1080_K1['me_bi']}")
    cells = hold_and_time("mc_luma_cells", luma_calls, card,
                          "phase 12: mc_luma_cells on the bi-prediction "
                          "search's slot-0 bi_sad cells")
    out["phase_s"] = time.time() - t_phase
    print(f"phase 12: {out['phase_s']:.3f} s in all", flush=True)
    return launches, cells, out


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
    ap.add_argument("--turbo", action="store_true",
                    help="build the kernels and run phase 8 (the turbo "
                    "encoder) alone")
    ap.add_argument("--exact", action="store_true",
                    help="build the kernels and run phase 9 (the exact "
                    "encoder) alone")
    ap.add_argument("--device-enc", action="store_true",
                    help="build the kernels and run phase 10 (the "
                    "wavefront device encoder) alone, with the 1080p P "
                    "frame and its operation count")
    ap.add_argument("--multistream", action="store_true",
                    help="build the kernels and run phase 11 (the "
                    "multi-stream decode and encode, GOP lanes) alone")
    ap.add_argument("--me", action="store_true",
                    help="build the kernels, decode the bench stream's "
                    "first three frames and run phase 12 (the lockstep "
                    "motion search) alone")
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

    if args.turbo:
        _, _, turbo = phase_turbo(device, card, N=6)
        print(json.dumps({"turbo_encode": turbo}))
        return 0
    if args.exact:
        _, exact = phase_exact(device, card)
        print(json.dumps({"exact_encode": exact}))
        return 0
    if args.device_enc:
        _, devenc = phase_device_enc(device, card, frames=2, count=True)
        print(json.dumps({"device_encode": devenc}))
        return 0
    if args.multistream:
        _, multi = phase_multistream(device, card)
        print(json.dumps({"multistream": multi}))
        return 0
    if args.me:
        _, _, me = phase_me(device, card, bench_frames(3, device))
        print(json.dumps({"lockstep_me": me}))
        return 0
    rand = phase_kernels(device, card)
    phase_goldens(device)
    launches, real, frames, fused_times = phase_main_path(device, card)
    res = phase_real_cells(device, card, real, rand)
    tile_launches, tiles = phase_tiles(device, card)
    phase_tempinterp(device, card, frames)
    unfused_launches, k2_err, unfused = phase_unfused(device, card, real,
                                                      fused_times)
    turbo_launches, turbo_cells, turbo = phase_turbo(device, card)
    mixed_launches, exact = phase_exact(device, card)
    devenc_launches, devenc = phase_device_enc(device, card)
    multi_launches, multi = phase_multistream(device, card,
                                              unfused["per_frame_s"])
    me_launches, me_cells, me = phase_me(device, card, frames)

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
                   "unfused_decode": unfused_launches[name],
                   "turbo_encode": turbo_launches[name],
                   "exact_encode": sum(e["launches"][name]
                                       for k, e in exact.items()
                                       if k != MIXED[0]),
                   "mixed_encode": mixed_launches[name],
                   "device_encode": devenc_launches[name],
                   **{path: n[name] for path, n in multi_launches.items()},
                   **{path: n[name] for path, n in me_launches.items()}}
        if name in turbo_cells:
            sets["turbo finalizer frame 1"] = turbo_cells[name]
        batched = multi["multistream_decode"]["cells"]
        if name in batched:
            sets["pair decode frame 1 (2 streams)"] = batched[name]
        if name == "mc_luma_cells":
            sets["lockstep ME bi_sad (8,160 blocks)"] = me_cells
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
            "other_cells": {what: {k: x.get(k) for k in keys}
                            for what, x in sets.items()}})
    print(json.dumps({"unfused_decode": unfused}))
    print(json.dumps({"turbo_encode": turbo}))
    print(json.dumps({"exact_encode": exact}))
    print(json.dumps({"device_encode": devenc}))
    print(json.dumps({"multistream": multi}))
    print(json.dumps({"lockstep_me": me}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
