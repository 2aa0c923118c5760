/* Native host-side entropy hot paths for thor_tpu.
 *
 * Implements the bit-serial VLC coefficient scan (the volume driver of
 * the bitstream) as a C extension; semantics mirror thor_tpu/bitstream.py
 * and the coefficient codecs in dec/decoder.py + enc/writer.py, which in
 * turn mirror the reference (dec/read_bits.c:142, enc/write_bits.c:145).
 * Exactness is enforced by tests against the Python implementations.
 *
 * Build: tools/build_native.sh (plain cc -O3 -shared).
 */
#include <stdint.h>
#include <string.h>

typedef struct {
    const uint8_t *data;
    long nbytes;
    long bitpos;
} br_t;

static inline uint32_t br_bits(br_t *br, int n)
{
    /* MSB-first read of n (<=24) bits with zero padding past the end */
    long pos = br->bitpos;
    br->bitpos += n;
    if (n == 0) return 0;
    long byte = pos >> 3;
    int shift = (int)(pos & 7);
    uint64_t w = 0;
    for (int i = 0; i < 5; i++) {
        uint8_t b = (byte + i) < br->nbytes ? br->data[byte + i] : 0;
        w = (w << 8) | b;
    }
    return (uint32_t)((w >> (40 - shift - n)) & ((1u << n) - 1));
}

static inline int br_bit(br_t *br)
{
    long pos = br->bitpos++;
    long byte = pos >> 3;
    if (byte >= br->nbytes) return 0;
    return (br->data[byte] >> (7 - (pos & 7))) & 1;
}

/* EOF rule shared with the Python BitReader (bitstream.py:getbits):
 * trailing-byte zero padding is legitimate, but a read more than 64
 * bits past the end of the unit means a desynced unary VLC is spinning
 * on the zero padding.  Mirrors dec/getvlc.c hitting getbits() EOF. */
static inline int br_overrun(const br_t *br)
{
    return br->bitpos > (br->nbytes << 3) + 64;
}

int get_vlc(br_t *br, int n)
{
    if (n < 0) return (int)br_bits(br, -n);
    int e = 5, diff = 0;
    if (n == 6 || n == 7) {
        long save = br->bitpos;
        if (br_bits(br, 2) == 2) return 0;
        br->bitpos = save;
        if (n == 6) { diff = 1; n = 2; }
        else {
            if (br_bits(br, 3) == 6) return 1;
            br->bitpos = save;
            if (br_bits(br, 3) == 7) return 2 + br_bit(br);
            br->bitpos = save;
            diff = 4; n = 3;
        }
    }
    if (n <= 5) {
        int val = 0;
        while (!br_bit(br)) {
            if (br_overrun(br)) return 0; /* unterminated unary: EOF */
            /* legal levels fit int16 => val <= e + 16; a longer unary
             * prefix is a desynced stream (in-bounds zero run) - cap it
             * so the shifts below stay defined */
            if (++val > 24) return 0;
        }
        if (val <= e) val = (val << n) + (int)br_bits(br, n);
        else val = (((e - 1) + (1 << (val - e))) << n) +
                   (int)br_bits(br, n + val - e);
        return val - diff;
    }
    if (n == 8) {
        int val = 0;
        while (!br_bit(br) && ++val < 4) ;
        val = (val * 2 + br_bit(br)) ^ (val > 2 ? 14 : 0);
        return val;
    }
    if (n == 10) {
        int val = 0;
        while (!br_bit(br)) {
            if (br_overrun(br)) return 0; /* unterminated unary: EOF */
            val++;
        }
        if (val > 24) return 0;  /* >24-bit payload: corrupt stream */
        if (val) val = (1 << val) - 1 + (int)br_bits(br, val);
        return val;
    }
    /* 11..18 */
    {
        int val = 0;
        while (!br_bit(br) && ++val < n - 10) ;
        return val;
    }
}

/* Decode one coefficient block scan into scoeff (zigzag order); the
 * caller de-scans the first N=qsize^2 entries.  The buffer MUST have
 * SCOEFF_CAP entries: run-mode can land past N on valid streams (the
 * encoder may signal end-of-block with an overshooting run) and the
 * reference absorbs those writes in a fixed 256-entry scratch
 * (dec/read_bits.c:144).  We clamp at SCOEFF_CAP for robustness against
 * corrupt streams (where the reference itself would smash its stack). */
#define SCOEFF_CAP 512
void read_coeff_scan(br_t *br, int16_t *scoeff, int qsize, int type)
{
    int N = qsize * qsize;
    int chroma_flag = type & 1;
    int intra_flag = (type >> 1) & 1;
    int vlc_adaptive = intra_flag && !chroma_flag;
    int pos = 0, level, sign;
    memset(scoeff, 0, (size_t)N * sizeof(int16_t));
    if (chroma_flag == 1) {
        if (br_bit(br)) {
            sign = br_bit(br);
            scoeff[0] = sign ? -1 : 1;
            pos = N;
        }
    }
    int level_mode = 1;
    level = 1;
    int big = !chroma_flag || qsize > 4; /* size>8 in samples: qsize is
                                            min(16,size) so size<=8 <=>
                                            qsize<=8; caller passes flag */
    (void)big;
    while (pos < N) {
        if (level_mode) {
            while (pos < N && level > 0) {
                level = get_vlc(br, vlc_adaptive);
                sign = level ? br_bit(br) : 1;
                scoeff[pos] = (int16_t)(sign ? -level : level);
                if (chroma_flag == 0) vlc_adaptive = level > 3;
                pos++;
            }
        }
        if (pos >= N) break;
        int eob_pos = chroma_flag ? 0 : 2;
        int code = get_vlc(br, (chroma_flag && qsize <= 8 && N <= 64) ?
                           10 : 6);
        if (code == eob_pos) break;
        if (code > eob_pos) code -= 1;
        int level_flag = (code % 5) == 4;
        int run = level_flag ? code / 5 : 4 * (code / 5) + code % 5;
        pos += run;
        if (level_flag) {
            int tmp = get_vlc(br, 0);
            sign = tmp & 1;
            level = (tmp >> 1) + 2;
        } else {
            level = 1;
            sign = br_bit(br);
        }
        if (pos < SCOEFF_CAP)
            scoeff[pos] = (int16_t)(sign ? -level : level);
        level_mode = level > 1;
        pos++;
    }
}

/* ---------------- writer ---------------- */

typedef struct {
    uint8_t *buf;
    long cap;
    long bytepos;
    uint32_t bitbuf;
    int bitrest;
} bw_t;

static inline void bw_flush_word(bw_t *w)
{
    w->buf[w->bytepos + 0] = (uint8_t)(w->bitbuf >> 24);
    w->buf[w->bytepos + 1] = (uint8_t)(w->bitbuf >> 16);
    w->buf[w->bytepos + 2] = (uint8_t)(w->bitbuf >> 8);
    w->buf[w->bytepos + 3] = (uint8_t)(w->bitbuf);
    w->bytepos += 4;
    w->bitbuf = 0;
    w->bitrest = 32;
}

static inline void bw_putbits(bw_t *w, int n, uint32_t val)
{
    val &= (n == 32) ? 0xFFFFFFFFu : ((1u << n) - 1);
    if (n <= w->bitrest) {
        w->bitbuf |= val << (w->bitrest - n);
        w->bitrest -= n;
    } else {
        int rest = n - w->bitrest;
        w->bitbuf |= val >> rest;
        bw_flush_word(w);
        w->bitbuf |= (val & ((1u << rest) - 1)) << (32 - rest);
        w->bitrest -= rest;
    }
}

/* non-inline export for blockemit.c */
void bw_putbits_x(bw_t *w, int n, uint32_t val) { bw_putbits(w, n, val); }

static int ilog2(unsigned v) { int c = -1; while (v) { v >>= 1; c++; } return c; }

void put_vlc(bw_t *w, int n, unsigned cn)
{
    if (n < 0) { bw_putbits(w, -n, cn); return; }
    unsigned e = 5, len, tmp, code;
    if (n == 6 || n == 7) {
        if (!cn) { bw_putbits(w, 2, 2); return; }
        if (n == 6) { cn++; n = 2; }
        else {
            if (cn == 1) { bw_putbits(w, 3, 6); return; }
            if (cn < 4) { bw_putbits(w, 3, 7); bw_putbits(w, 1, cn & 1); return; }
            cn += 4; n = 3;
        }
    }
    if (n <= 5) {
        if (cn < e * (1u << n)) {
            tmp = 1u << n;
            code = tmp + (cn & (tmp - 1));
            len = 1 + n + (cn >> n);
        } else {
            code = cn - (e * (1u << n)) + (1u << n);
            len = (e - n) + 1 + 2 * ilog2(code);
        }
    } else if (n == 8) {
        if (cn < 6) { len = 2 + (cn >> 1); code = 2 + (cn & 1); }
        else { len = 5; code = cn - 6; }
    } else if (n == 10) {
        code = cn + 1;
        len = 1 + 2 * ilog2(code);
    } else { /* 11..18 */
        len = cn == (unsigned)(n - 10) ? (unsigned)(n - 10) : cn + 1;
        code = cn != (unsigned)(n - 10);
    }
    bw_putbits(w, (int)len, code);
}

/* Write one coefficient scan (scoeff in zigzag order, length N). */
void write_coeff_scan(bw_t *w, const int16_t *scoeff, int qsize, int type,
                      int vlc10)
{
    int N = qsize * qsize;
    int chroma_flag = type & 1;
    int intra_flag = (type >> 1) & 1;
    int vlc_adaptive = intra_flag && !chroma_flag;
    unsigned eob_pos = chroma_flag ? 0 : 2;
    int pos, last_pos, level_mode, level, c = 0;

    for (pos = N - 1; !scoeff[pos] && pos; pos--) ;
    last_pos = pos;
    pos = 0;
    if (chroma_flag) {
        if (last_pos == 0 && (scoeff[0] == 1 || scoeff[0] == -1)) {
            bw_putbits(w, 2, 2 + (scoeff[0] < 0));
            pos = N;
        } else
            bw_putbits(w, 1, 0);
    }
    level_mode = level = 1;
    while (pos <= last_pos) {
        if (level_mode) {
            while (pos <= last_pos && level > 0) {
                c = scoeff[pos++];
                level = c < 0 ? -c : c;
                put_vlc(w, vlc_adaptive, level);
                if (level > 0) bw_putbits(w, 1, c < 0);
                if (chroma_flag == 0) vlc_adaptive = level > 3;
            }
        }
        int run = 0;
        c = 0;
        while (c == 0 && pos <= last_pos) {
            c = scoeff[pos++];
            run += !c;
            if (c) {
                int interval = 5;
                level = c < 0 ? -c : c;
                int sign = c < 0;
                unsigned cn = level == 1 ?
                    (unsigned)((run * interval) / (interval - 1)) :
                    (unsigned)(run * interval + interval - 1);
                put_vlc(w, vlc10 ? 10 : 6, cn + (cn >= eob_pos));
                level_mode = level > 1;
                if (level > 1) put_vlc(w, 0, (level - 2) * 2 + sign);
                else bw_putbits(w, 1, sign);
                run = 0;
            }
        }
    }
    if (pos < N && level_mode) {
        put_vlc(w, vlc_adaptive, 0);
        pos++;
    }
    if (pos < N) put_vlc(w, vlc10 ? 10 : 6, eob_pos);
}
