"""Host-side bitstream layer: bit-exact reader/writer + structured VLC family.

The Thor bitstream is a sequence of frame units, each prefixed by a 4-byte
big-endian length (reference enc/putbits.c:45-80, dec/getbits.c:48-70).
Entropy coding is pure VLC (no arithmetic coding): 19 structured code
families (reference enc/putvlc.c:73-155, dec/getvlc.c:33-115).

This layer is inherently bit-serial and stays on the host in the TPU build;
the device produces/consumes dense coefficient+mode tensors.
"""
from __future__ import annotations


def log2i(n: int) -> int:
    return n.bit_length() - 1


class BitWriter:
    """MSB-first bit accumulator (reference enc/putbits.c).

    Supports position save/rewind, which the encoder RDO uses as a trial
    scratchpad (enc/putbits.c:126-150).  Like the C stream buffer, the
    backing store persists across rewinds: moving backward only moves the
    write position, later writes overwrite in place, and moving forward
    again re-exposes the bytes in between (the CDEF header rewrite depends
    on this).
    """

    __slots__ = ("buf", "bytepos", "bitbuf", "bitrest")

    def __init__(self):
        self.buf = bytearray()
        self.bytepos = 0     # current write position in buf
        self.bitbuf = 0      # up to 32 pending bits, left-aligned
        self.bitrest = 32    # free bits in bitbuf

    def putbits(self, n: int, val: int) -> int:
        val &= (1 << n) - 1
        if n <= self.bitrest:
            self.bitbuf |= val << (self.bitrest - n)
            self.bitrest -= n
        else:
            rest = n - self.bitrest
            self.bitbuf |= (val >> rest) & ((1 << (n - rest)) - 1)
            self._flush_word()
            self.bitbuf |= (val & ((1 << rest) - 1)) << (32 - rest)
            self.bitrest -= rest
        return n

    def _flush_word(self):
        end = self.bytepos + 4
        if len(self.buf) < end:
            self.buf.extend(b"\0" * (end - len(self.buf)))
        self.buf[self.bytepos:end] = self.bitbuf.to_bytes(4, "big")
        self.bytepos = end
        self.bitbuf = 0
        self.bitrest = 32

    def get_bit_pos(self) -> int:
        return 8 * self.bytepos + (32 - self.bitrest)

    # --- stream position save/rewind (RDO scratchpad) ---
    def save_pos(self):
        return (self.bytepos, self.bitbuf, self.bitrest)

    def restore_pos(self, pos):
        bytepos, bitbuf, bitrest = pos
        if bytepos > self.bytepos:
            # moving forward: merge pending bits with the bits already in
            # the buffer at the current position, then flush
            # (reference write_stream_pos, enc/putbits.c:130-144)
            chunk = bytes(self.buf[self.bytepos:self.bytepos + 4])
            tmp = int.from_bytes(chunk.ljust(4, b"\0"), "big")
            tmp &= (1 << self.bitrest) - 1
            self.putbits(self.bitrest, tmp)
            if self.bitrest != 32:
                self._flush_word()
        self.bytepos = bytepos
        self.bitbuf = bitbuf
        self.bitrest = bitrest

    def flush_frame(self) -> bytes:
        """Byte-align pending bits and return the framed unit
        (4-byte BE length + payload), resetting the position (the backing
        store persists, mirroring the C buffer reuse)."""
        nbytes = 4 - self.bitrest // 8
        frame_bytes = self.bytepos + nbytes
        tail = bytes((self.bitbuf >> (24 - 8 * i)) & 0xFF
                     for i in range(nbytes))
        out = (frame_bytes.to_bytes(4, "big") +
               bytes(self.buf[:self.bytepos]) + tail)
        self.bytepos = 0
        self.bitbuf = 0
        self.bitrest = 32
        return out

    # --- VLC family (reference enc/putvlc.c:73) ---
    def put_vlc(self, n: int, cn: int) -> int:
        if n < 0:
            return self.putbits(-n, cn)
        e = 5
        if n in (6, 7):
            if cn == 0:
                return self.putbits(2, 2)
            if n == 6:
                cn += 1
                n = 2
            else:
                if cn == 1:
                    return self.putbits(3, 6)
                if cn < 4:
                    self.putbits(3, 7)
                    self.putbits(1, cn & 1)
                    return 4
                cn += 4
                n = 3
            # falls through to unary/exp-golomb below
        if 0 <= n <= 5:
            if cn < e * (1 << n):
                tmp = 1 << n
                code = tmp + (cn & (tmp - 1))
                length = 1 + n + (cn >> n)
            else:
                code = cn - (e * (1 << n)) + (1 << n)
                length = (e - n) + 1 + 2 * log2i(code)
        elif n == 8:
            if cn > 9:
                raise ValueError("Code too large for VLC 8")
            if cn < 6:
                length = 2 + (cn >> 1)
                code = 2 + (cn & 1)
            else:
                length = 5
                code = cn - 6
        elif n == 10:
            code = cn + 1
            length = 1 + 2 * log2i(code)
        elif 11 <= n <= 18:
            if cn > n - 10:
                raise ValueError("Code too large for VLC %d" % n)
            length = (n - 10) if cn == n - 10 else cn + 1
            code = int(cn != n - 10)
        else:
            raise ValueError("No such VLC table: %d" % n)
        self.putbits(length, code)
        return length

    def put_flc(self, n: int, cn: int) -> int:
        return self.put_vlc(-n, cn)


def cost_vlc(n: int, cn: int) -> int:
    """Bit length put_vlc would emit, without emitting (for RDO counting)."""
    if n < 0:
        return -n
    e = 5
    if n in (6, 7):
        if cn == 0:
            return 2
        if n == 6:
            cn += 1
            n = 2
        else:
            if cn == 1:
                return 3
            if cn < 4:
                return 4
            cn += 4
            n = 3
    if 0 <= n <= 5:
        if cn < e * (1 << n):
            return 1 + n + (cn >> n)
        code = cn - (e * (1 << n)) + (1 << n)
        return (e - n) + 1 + 2 * log2i(code)
    if n == 8:
        return 2 + (cn >> 1) if cn < 6 else 5
    if n == 10:
        return 1 + 2 * log2i(cn + 1)
    if 11 <= n <= 18:
        return (n - 10) if cn == n - 10 else cn + 1
    raise ValueError(n)


class BitReader:
    """MSB-first reader over one framed unit (reference dec/getbits.c).

    Construct per frame via `FrameUnitReader.next_frame()`.
    """

    __slots__ = ("data", "bitpos", "bitcnt")

    def __init__(self, data: bytes):
        self.data = data
        self.bitpos = 0
        self.bitcnt = 0  # mirrors stream->bitcnt for stat parity

    def getbits(self, n: int) -> int:
        if n == 0:
            return 0
        pos = self.bitpos
        self.bitpos += n
        self.bitcnt += n
        end_byte = (self.bitpos + 7) >> 3
        start_byte = pos >> 3
        chunk = self.data[start_byte:end_byte]
        if len(chunk) < end_byte - start_byte:  # past end: zero-pad
            # Cap the overrun: trailing-byte bit padding is legitimate
            # (units are byte-aligned), but a desynced unary VLC would
            # otherwise spin on zero bits forever.  64 spare bits is far
            # beyond any legal read-ahead (showbits<=3, getbits<=32).
            if self.bitpos > (len(self.data) << 3) + 64:
                raise EOFError(
                    "bitstream overrun: read to bit %d of a %d-byte unit"
                    % (self.bitpos, len(self.data)))
            chunk = chunk + b"\0" * (end_byte - start_byte - len(chunk))
        word = int.from_bytes(chunk, "big")
        shift = (end_byte << 3) - self.bitpos
        return (word >> shift) & ((1 << n) - 1)

    def getbits1(self) -> int:
        return self.getbits(1)

    def showbits(self, n: int) -> int:
        pos, cnt = self.bitpos, self.bitcnt
        v = self.getbits(n)
        self.bitpos, self.bitcnt = pos, cnt
        return v

    def flushbits(self, n: int):
        self.bitpos += n
        self.bitcnt += n

    # --- VLC family (reference dec/getvlc.c:33) ---
    def get_vlc(self, n: int) -> int:
        if n < 0:
            return self.getbits(-n)
        e = 5
        diff = 0
        if n in (6, 7):
            if self.showbits(2) == 2:
                self.flushbits(2)
                return 0
            if n == 6:
                diff = 1
                n = 2
            else:
                if self.showbits(3) == 6:
                    self.flushbits(3)
                    return 1
                if self.showbits(3) == 7:
                    self.flushbits(3)
                    return 2 + self.getbits1()
                diff = 4
                n = 3
        if 0 <= n <= 5:
            val = 0
            while not self.getbits1():
                val += 1
            if val <= e:
                val = (val << n) + self.getbits(n)
            else:
                val = (((e - 1) + (1 << (val - e))) << n) + self.getbits(n + val - e)
            return val - diff
        if n == 8:
            val = 0
            while not self.getbits1():
                val += 1
                if val >= 4:
                    break
            val = (val * 2 + self.getbits1()) ^ (14 if val > 2 else 0)
            return val
        if n == 10:
            val = 0
            while not self.getbits1():
                val += 1
            if val:
                val = (1 << val) - 1 + self.getbits(val)
            return val
        if 11 <= n <= 18:
            val = 0
            while not self.getbits1():
                val += 1
                if val >= n - 10:
                    break
            return val
        raise ValueError("Illegal VLC table %d" % n)

    def get_flc(self, n: int) -> int:
        return self.getbits(n)


class FrameUnitReader:
    """Splits a Thor bitstream file into framed units (4-byte BE lengths)."""

    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def next_frame(self) -> BitReader | None:
        if self.off + 4 > len(self.data):
            return None
        length = int.from_bytes(self.data[self.off:self.off + 4], "big")
        payload = self.data[self.off + 4:self.off + 4 + length]
        self.off += 4 + length
        return BitReader(payload)
