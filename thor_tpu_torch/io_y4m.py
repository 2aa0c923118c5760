"""YUV4MPEG2 (.y4m) probing and header emission.

Mirrors the reference's y4m handling:
  - input probing: enc/strings.c:376-450 (geometry from the stream header
    overrides config/command-line geometry; C420/C422/C444/Cmono plus
    'p<depth>' high-bitdepth suffix; only progressive 'Ip' accepted).
  - output headers: enc/mainenc.c:149-161 (recon) and dec/maindec.c:163-175
    (decode), including the 'XYSCSS=' tag for >8-bit and the per-frame
    'FRAME\\n' markers.

Frame layout in a y4m file: file header (ends with '\\n'), then for each
frame a 6-byte 'FRAME\\n' marker followed by raw planar samples.  The
reference records these as file_headerlen / frame_headerlen and seeks with
  frame_num*(frame_size+frame_headerlen) + file_headerlen + frame_headerlen
(enc/mainenc.c:542).
"""
from __future__ import annotations


class Y4mInfo:
    def __init__(self):
        self.width = None
        self.height = None
        self.frame_rate = None
        self.subsample = None
        self.input_bitdepth = None
        self.aspectnum = None
        self.aspectden = None
        self.file_headerlen = 0
        self.frame_headerlen = 0


def probe_y4m(data: bytes):
    """Parse a y4m file header.  Returns Y4mInfo or None if not y4m.

    Raises ValueError for interlaced input or a corrupt header, matching
    the reference's fatal paths (enc/strings.c:406-409, 441-444).
    """
    buf = data[:256]
    if not buf.startswith(b"YUV4MPEG2 "):
        return None
    info = Y4mInfo()
    pos = 10
    n = len(buf)

    def skip_token(pos):
        while pos < n and buf[pos:pos + 1] != b"\n" and buf[pos:pos + 1] != b" ":
            pos += 1
        if pos < n and buf[pos:pos + 1] == b" ":
            pos += 1
        return pos

    def read_int(pos):
        start = pos
        if pos < n and buf[pos:pos + 1] in (b"-", b"+"):
            pos += 1
        while pos < n and buf[pos:pos + 1].isdigit():
            pos += 1
        return int(buf[start:pos] or b"0"), pos

    while pos < n and buf[pos:pos + 1] != b"\n":
        tag = buf[pos:pos + 1]
        pos += 1
        if tag == b"W":
            info.width, pos = read_int(pos)
            pos = skip_token(pos)
        elif tag == b"H":
            info.height, pos = read_int(pos)
            pos = skip_token(pos)
        elif tag == b"F":
            den, pos = read_int(pos)
            pos += 1  # ':'
            num, pos = read_int(pos)
            info.frame_rate = float(den) / num
            pos = skip_token(pos)
        elif tag == b"I":
            if buf[pos:pos + 1] != b"p":
                raise ValueError("Only progressive input supported")
            pos = skip_token(pos)
        elif tag == b"C":
            if buf[pos:pos + 4] == b"mono":
                info.subsample = 400
                pos += 4
            else:
                info.subsample, pos = read_int(pos)
            if buf[pos:pos + 1] == b"p":
                info.input_bitdepth, pos = read_int(pos + 1)
            pos = skip_token(pos)
        elif tag == b"A":
            info.aspectnum, pos = read_int(pos)
            pos += 1  # ':'
            info.aspectden, pos = read_int(pos)
            pos = skip_token(pos)
        else:  # 'X' and unknown tags
            while pos < n and buf[pos:pos + 1] not in (b" ", b"\n"):
                pos += 1
            if pos < n and buf[pos:pos + 1] == b" ":
                pos += 1
    if buf[pos:pos + 7] != b"\nFRAME\n":
        raise ValueError("Corrupt Y4M file")
    info.file_headerlen = pos + 1
    info.frame_headerlen = 6
    return info


def _colour_tag(subsample: int, input_bitdepth: int) -> str:
    s = "mono" if subsample == 400 else str(subsample)
    if input_bitdepth > 8:
        s += "p%d XYSCSS=%dp%d" % (input_bitdepth, subsample, input_bitdepth)
    return s


def y4m_file_header(width: int, height: int, frame_rate: float,
                    aspectnum: int, aspectden: int, subsample: int,
                    input_bitdepth: int) -> bytes:
    """Output-side header (enc/mainenc.c:149-161).  F is '%d:1'."""
    return ("YUV4MPEG2 W%d H%d F%d:1 Ip A%d:%d C%s\n" % (
        width, height, int(frame_rate), aspectnum, aspectden,
        _colour_tag(subsample, input_bitdepth))).encode()


FRAME_MARKER = b"FRAME\n"


def extract_raw_frames(data: bytes, info: Y4mInfo, frame_size: int) -> bytes:
    """Concatenate the raw planar payloads of every complete frame."""
    out = bytearray()
    pos = info.file_headerlen
    step = info.frame_headerlen + frame_size
    while pos + step <= len(data):
        out += data[pos + info.frame_headerlen:pos + step]
        pos += step
    return bytes(out)
