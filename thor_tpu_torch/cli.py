"""Decoder command line of the port, compatible with Thordec.

Usage:
  python -m thor_tpu_torch.cli dec str.bit out.yuv

A copy of thor_tpu/cli.py's decoder half (`_dec_stats_report`,
`main_dec`: statistics on stdout as Thordec prints them) on the port's
decode_stream.  It decodes on the CUDA card; the environment variable
THOR_TORCH_DEVICE names another torch device (`cpu`), as thor_tpu's CLI
takes JAX_PLATFORMS.  With no card and no other device asked for, it
exits with status 1 and says so.  The encoder half is not ported yet
(ROADMAP.md Queue 1, item 10).
"""
from __future__ import annotations

import os
import sys

from .io_y4m import FRAME_MARKER, y4m_file_header


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
    if len(sys.argv) < 4 or sys.argv[1] != "dec":
        print(__doc__)
        return 2
    from .dec.decoder import resolve_device
    try:
        device = resolve_device(os.environ.get("THOR_TORCH_DEVICE", "cuda"))
    except RuntimeError as e:
        print(f"thor_tpu_torch.cli: {e}", file=sys.stderr)
        return 1
    return main_dec(sys.argv[2:], device)


if __name__ == "__main__":
    sys.exit(main())
