"""Command line of the port, compatible with Thorenc/Thordec.

Usage:
  python -m thor_tpu_torch.cli enc [Thorenc flags...]
  python -m thor_tpu_torch.cli dec str.bit out.yuv

A copy of thor_tpu/cli.py (`main_enc`: per-frame lines and the summary
as Thorenc prints them; `_dec_stats_report`, `main_dec`: statistics on
stdout as Thordec prints them) on the port's encode_sequence and
decode_stream.  The encoder is thor_tpu's exact host-RDO encoder, or with
`-turbo 1` the turbo encoder where it supports the frame; with
`-device_enc 1` (thor_tpu's wavefront device encoder, not ported) `enc`
exits with status 1 and says so.  Both run on the CUDA card; the environment
variable THOR_TORCH_DEVICE names another torch device (`cpu`), as
thor_tpu's CLI takes JAX_PLATFORMS.  With no card and no other device
asked for, they exit with status 1 and say so.
"""
from __future__ import annotations

import math
import os
import sys

import numpy as np

from .io_y4m import (FRAME_MARKER, extract_raw_frames, probe_y4m,
                     y4m_file_header)


def _psnr(a: np.ndarray, b: np.ndarray, maxval: int) -> float:
    d = a.astype(np.int64) - b.astype(np.int64)
    mse = float((d * d).sum()) / (maxval * maxval * a.size)
    return -10.0 * math.log10(mse) if mse > 0 else float("inf")


def main_enc(argv, device):
    from .enc.params import EncParams, apply_args
    from .enc.encoder import encode_sequence, NOT_PORTED

    p = EncParams()
    infile = outfile = reconfile = statfile = None
    args = []
    i = 0
    while i < len(argv):
        if argv[i] == "-if":
            infile = argv[i + 1]
            i += 2
        elif argv[i] == "-of":
            outfile = argv[i + 1]
            i += 2
        elif argv[i] == "-rf":
            reconfile = argv[i + 1]
            i += 2
        elif argv[i] == "-stat":
            statfile = argv[i + 1]
            i += 2
        else:
            args.append(argv[i])
            i += 1
    apply_args(p, args)
    if p.device_enc == 1:
        print(f"thor_tpu_torch.cli: {NOT_PORTED}", file=sys.stderr)
        return 1
    yuv = open(infile, "rb").read()
    y4m = probe_y4m(yuv)
    if y4m is not None:
        # stream header geometry overrides config (enc/strings.c:376-450)
        for a in ("width", "height", "frame_rate", "subsample",
                  "aspectnum", "aspectden"):
            v = getattr(y4m, a)
            if v is not None:
                setattr(p, a, v)
        if y4m.input_bitdepth is not None and y4m.input_bitdepth > 8:
            p.input_bitdepth = y4m.input_bitdepth
            p.frame_bitdepth = 16
    p.validate()
    bpp = 1 + (p.input_bitdepth > 8)
    ys = p.width * p.height
    cs = ((ys >> (2 * (p.subsample != 444))) << (p.subsample == 422)) \
        * (p.subsample != 400)
    fsize = (ys + 2 * cs) * bpp
    if y4m is not None:
        yuv = extract_raw_frames(yuv, y4m, fsize)

    from .enc.encoder import I_FRAME, P_FRAME

    maxval = (1 << p.input_bitdepth) - 1
    dt = np.uint16 if p.input_bitdepth > 8 else np.uint8
    stats = {"n": 0, "bits": 0, "psnr": [0.0, 0.0, 0.0]}

    def frame_psnr(rec, orig_frame):
        r = np.frombuffer(rec, dt)
        o = np.frombuffer(yuv, dt, count=r.size, offset=orig_frame * fsize)
        ys2 = ys
        vals = [_psnr(r[:ys2], o[:ys2], maxval)]
        if p.subsample != 400:
            half = (r.size - ys2) // 2
            vals.append(_psnr(r[ys2:ys2 + half], o[ys2:ys2 + half], maxval))
            vals.append(_psnr(r[ys2 + half:], o[ys2 + half:], maxval))
        else:
            vals += [0.0, 0.0]
        return vals

    def progress(fnum, ftype, info):
        # per-frame line mirroring the reference's stdout (mainenc.c:569-592)
        stats["n"] += 1
        stats["bits"] += info["bits"]
        if p.snrcalc:
            py, pu, pv = frame_psnr(info["rec"], info["orig_frame"])
        else:
            py = pu = pv = 0.0
        for k, v in enumerate((py, pu, pv)):
            stats["psnr"][k] += v
        tc = "I" if ftype == I_FRAME else ("P" if ftype == P_FRAME else "B")
        line = "%4d %s %4d %10d %10.4f %8.4f %8.4f " % (
            fnum, tc, info["qp"], info["bits"], py, pu, pv)
        ra = info["ref_array"]
        rfn = info["ref_frame_nums"]
        for r in range(info["num_ref"]):
            if ra[r] == -1:
                line += "I(%d,%d) " % (ra[r + 1], ra[r + 2])
            else:
                line += "%3d" % ra[r]
        line += "   " * (p.max_num_ref - info["num_ref"]) + " | "
        for r in range(info["num_ref"]):
            if ra[r] == -1:
                line += "I(%d,%d)" % (rfn[r + 1], rfn[r + 2])
            else:
                line += "%3d" % rfn[r]
        print(line)

    # "SH:" line + header bits counted into kbps (mainenc.c:219-225)
    from .bitstream import BitWriter
    from .enc.writer import write_sequence_header
    _bw = BitWriter()
    write_sequence_header(_bw, p)
    stats["bits"] += _bw.get_bit_pos()
    print("SH:  %4d bits" % _bw.get_bit_pos())

    bits, recon = encode_sequence(p, yuv, progress=progress, device=device)
    if outfile:
        open(outfile, "wb").write(bits)
    if reconfile:
        with open(reconfile, "wb") as f:
            if reconfile.endswith(".y4m"):
                f.write(y4m_file_header(p.width, p.height, p.frame_rate,
                                        p.aspectnum, p.aspectden,
                                        p.subsample, p.input_bitdepth))
                rs = len(recon) // max(1, stats["n"])
                for i in range(stats["n"]):
                    f.write(FRAME_MARKER)
                    f.write(recon[i * rs:(i + 1) * rs])
            else:
                f.write(recon)

    # sequence summary (mainenc.c:644-651) + cumulative stat file
    # (mainenc.c:653-672)
    n = max(1, stats["n"])
    kbps = 0.001 * p.frame_rate * stats["bits"] / n
    print("------------------- Average data for all frames "
          "------------------------------")
    print(f"kbps            : {kbps:12.3f}")
    print(f"PSNR Y          : {stats['psnr'][0] / n:12.3f}")
    print(f"PSNR U          : {stats['psnr'][1] / n:12.3f}")
    print(f"PSNR V          : {stats['psnr'][2] / n:12.3f}")
    print("-----------------------------------------------------------"
          "-------------------")
    if statfile:
        new = not os.path.exists(statfile)
        with open(statfile, "a") as f:
            if new:
                f.write(" NFR     kbps     PSNRY  PSNRU  PSNRV\n")
            f.write("%4d %12.3f %6.3f %6.3f %6.3f\n" % (
                p.num_frames, kbps, stats["psnr"][0] / n,
                stats["psnr"][1] / n, stats["psnr"][2] / n))
    return 0


def _dec_stats_report(bc, max_num_ref):
    """BIT/PARAMETER STATISTICS report, format-identical with the
    reference decoder (dec/maindec.c:210-346, including its averaging
    quirks: MV/Skip-idx/Total 'average' columns for I pictures repeat the
    total, and zero P/B frame counts divide by 1<<30)."""
    out = []
    tot = [bc.frame_header[i] + bc.super_mode[i] + bc.intra_mode[i] +
           bc.mv[i] + bc.skip_idx[i] + bc.coeff_y[i] + bc.coeff_u[i] +
           bc.coeff_v[i] + bc.cbp[i] + bc.clpf[i] for i in range(3)]
    tot[0] += bc.sequence_header
    ni = bc.frame_type[0]
    np_ = bc.frame_type[1] or (1 << 30)
    nb = bc.frame_type[2] or (1 << 30)

    def row6(label, a, i_avg=None):
        ia = a[0] // ni if i_avg is None else i_avg
        return ("%s%9d  %9d  %9d  %9d  %9d  %9d" %
                (label, a[0], ia, a[1], a[1] // np_, a[2], a[2] // nb))

    out.append("\n\nBIT STATISTICS:")
    out.append("Sequence header: %4d" % bc.sequence_header)
    out.append("                           I pictures:           "
               "P pictures:           B pictures:")
    out.append("                           total    average      total"
               "    average      total    average")
    out.append(row6("Frame header:          ", bc.frame_header))
    out.append(row6("Super mode:            ", bc.super_mode))
    out.append(row6("Intra mode:            ", bc.intra_mode))
    out.append(row6("MV:                    ", bc.mv, i_avg=bc.mv[0]))
    out.append(row6("Skip idx:              ", bc.skip_idx,
                    i_avg=bc.skip_idx[0]))
    out.append(row6("Coeff_y:               ", bc.coeff_y))
    out.append(row6("Coeff_u:               ", bc.coeff_u))
    out.append(row6("Coeff_v:               ", bc.coeff_v))
    out.append(row6("CBP (TU-split):        ", bc.cbp))
    out.append(row6("CLPF:                  ", bc.clpf))
    out.append(row6("Total:                 ", tot, i_avg=tot[0]))
    out.append("-" * 87 + "\n")

    out.append("PARAMETER STATISTICS:")
    out.append("                           I pictures:           "
               "P pictures:           B pictures:")
    out.append("                           total    average      total"
               "    average      total    average")
    mode_rows = [("Skip-blocks (8x8):     ", 0),
                 ("Intra-blocks (8x8):    ", 1),
                 ("Inter-blocks (8x8):    ", 2),
                 ("Bipred-blocks (8x8):   ", 3),
                 ("Merge-blocks (8x8):    ", 4)]
    for label, m in mode_rows:
        out.append(row6(label, [bc.mode[i][m] for i in range(3)]))
    out.append("")
    size_rows = ["8x8-blocks (8x8):      ", "16x16-blocks (8x8):    ",
                 "32x32-blocks (8x8):    ", "64x64-blocks (8x8):    ",
                 "128x128-blocks (8x8):  "]
    for idx, label in enumerate(size_rows):
        out.append(row6(label, [bc.size[i][idx] for i in range(3)]))

    for ftname, ft in (("P", 1), ("B", 2)):
        out.append("")
        out.append("Mode and size distribution for %s pictures:" % ftname)
        out.append("                            SKIP      INTRA      INTER"
                   "     BIPRED      MERGE")
        for idx, label in enumerate(size_rows):
            out.append(label + "%9d  %9d  %9d  %9d  %9d" % tuple(
                bc.size_and_mode[ft][idx][m] for m in range(5)))

    for ftname, ft in (("P", 1), ("B", 2)):
        num = 5 + max_num_ref
        hdr = ("                    SKIP   SPLIT INTERr0   MERGE   BIPRED"
               "  INTRA ")
        hdr += "".join("INTERr%1d " % i for i in range(1, max_num_ref))
        out.append("\nSuper-mode distribution for %s pictures:" % ftname)
        out.append(hdr)
        for idx in range(5):
            size = 8 << idx
            out.append("%3d x %3d-blocks: " % (size, size) + "".join(
                "%8d" % bc.super_mode_stat[ft][idx][i] for i in range(num)))

    for ftname, ft in (("P", 1), ("B", 2)):
        out.append("")
        out.append("Ref_idx and size distribution for %s pictures:"
                   % ftname)
        for idx in range(5):
            size = 1 << (idx + 3)
            out.append("%3d x %3d-blocks: " % (size, size) + "".join(
                "%6d" % bc.size_and_ref_idx[ft][idx][j]
                for j in range(max_num_ref)))

    out.append("")
    out.append("bi-ref-P:  " + "".join("%7d" % bc.bi_ref[1][j]
                                       for j in range(16)))
    out.append("bi-ref-B:  " + "".join("%7d" % bc.bi_ref[2][j]
                                       for j in range(16)))
    out.append("-" * 65)
    return "\n".join(out)


def main_dec(argv, device):
    from .dec.decoder import decode_stream

    data = open(argv[0], "rb").read()

    def progress(n, disp, bitcnt):
        # per-frame line mirroring dec/maindec.c:193-194.  The reference
        # re-inits the stream (resetting bitcnt) BEFORE printing, so its
        # bitcnt field is always 0; replicate for output parity.
        print("decode_frame_num=%4d display_frame_num=%4d "
              "input_file_size=%12d bitcnt=%12d" % (n, disp, len(data), 0))

    hdr, frames = decode_stream(data, progress=progress, device=device)
    print(_dec_stats_report(hdr.bit_count, hdr.max_num_ref))
    with open(argv[1], "wb") as f:
        if argv[1].endswith(".y4m"):
            # dec/maindec.c:163-175: F is hardwired 30:1, A 1:1
            f.write(y4m_file_header(hdr.width, hdr.height, 30.0, 1, 1,
                                    hdr.subsample, hdr.input_bitdepth))
            for fr in frames:
                f.write(FRAME_MARKER)
                f.write(fr)
        else:
            for fr in frames:
                f.write(fr)
    # our own summary goes to stderr so stdout stays byte-identical with
    # the reference decoder (diff-able against Thordec)
    print(f"decoded {len(frames)} frames {hdr.width}x{hdr.height}",
          file=sys.stderr)
    return 0


def main():
    if len(sys.argv) < 3 or sys.argv[1] not in ("enc", "dec") or (
            sys.argv[1] == "dec" and len(sys.argv) < 4):
        print(__doc__)
        return 2
    from .dec.decoder import resolve_device
    try:
        device = resolve_device(os.environ.get("THOR_TORCH_DEVICE", "cuda"))
    except RuntimeError as e:
        print(f"thor_tpu_torch.cli: {e}", file=sys.stderr)
        return 1
    if sys.argv[1] == "enc":
        return main_enc(sys.argv[2:], device)
    return main_dec(sys.argv[2:], device)


if __name__ == "__main__":
    sys.exit(main())
