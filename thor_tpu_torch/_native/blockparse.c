/* Native host-side block-layer syntax parser for thor_tpu.
 *
 * One call parses a whole frame's superblock walk: super-mode decode,
 * MV candidate/MVP derivation, coefficient scans, deblock-data grid
 * updates, delta-QP, bit accounting, and (optionally) the dense MC-plan
 * grids + dense coefficient planes consumed by the device pixel
 * executor (dec/device_pixels.py).  Semantics mirror the Python
 * decoder's syntax walk (thor_tpu/dec/decoder.py), which in turn
 * mirrors the reference (dec/decode_block.c:225-672, dec/read_bits.c:252,
 * common/inter_prediction.c:413-881, common/common_block.c:283).
 * Exactness is enforced by tests comparing against the Python walk.
 *
 * Built together with entropy.c into libthorentropy.so.
 */
#include <stdint.h>
#include <string.h>

#include "thor_native.h"

static inline uint32_t bp_bits(br_t *br, int n)
{
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

enum { STAT_SKIP = 0, STAT_SPLIT, STAT_REF_IDX0, STAT_MERGE, STAT_BIPRED,
       STAT_INTRA, STAT_REF_IDX1 };

/* stats layout (int64), mirrors dec/decoder.py BitCount */
#define ST_SUPER_MODE 0
#define ST_INTRA_MODE 3
#define ST_MV 6
#define ST_SKIP_IDX 9
#define ST_COEFF_Y 12
#define ST_COEFF_U 15
#define ST_COEFF_V 18
#define ST_CBP 21
#define ST_MODE 24            /* [3][5] */
#define ST_SIZE 39            /* [3][5] */
#define ST_SIZE_AND_MODE 54   /* [3][5][5] */
#define ST_SMS 129            /* [3][5][9] */
#define ST_SIZE_AND_REF 264   /* [3][5][4] */
#define ST_BI_REF 324         /* [3][16] */
#define ST_TOTAL 372

static int ilog2i(int v) { int c = -1; while (v) { v >>= 1; c++; } return c; }

int rec_qpc(int qpY, int sub);

/* ---------- availability (common/common_block.h:52-95) ---------- */

static int upright_avail(int ypos, int xpos, int bw, int bh, int fw, int fh,
                         int sb)
{
    int avail = (ypos > 0) && (xpos + bw < fw);
    int size = bw > bh ? bw : bh;
    int s2 = size;
    while (s2 < sb) {
        if ((ypos % (s2 << 1)) == s2 && (xpos % s2) == (s2 - size))
            avail = 0;
        s2 *= 2;
    }
    return avail;
}

static int downleft_avail(int ypos, int xpos, int bw, int bh, int fw, int fh,
                          int sb)
{
    int avail = (xpos > 0) && (ypos + bh < fh);
    int size = bw > bh ? bw : bh;
    if ((ypos % sb) == (sb - size) && (xpos % sb) == 0)
        avail = 0;
    int s2 = 2 * size;
    while (s2 <= sb) {
        if ((ypos % s2) == (s2 - size) && (xpos % s2) > 0)
            avail = 0;
        s2 *= 2;
    }
    return avail;
}

/* ---------- MV prediction / candidates ---------- */

static cand_t dd_pred(const parse_ctx_t *c, long bi)
{
    cand_t p;
    p.mv0y = c->dd_mv0[2 * bi];     p.mv0x = c->dd_mv0[2 * bi + 1];
    p.mv1y = c->dd_mv1[2 * bi];     p.mv1x = c->dd_mv1[2 * bi + 1];
    p.ref0 = c->dd_ref0[bi];        p.ref1 = c->dd_ref1[bi];
    p.dir  = c->dd_bipred[bi];
    return p;
}

static int med3(int a, int b, int cc)
{
    if (a < b) { int m = a > cc ? a : cc; return b < m ? b : m; }
    { int m = b > cc ? b : cc; return a < m ? a : m; }
}

/* inter_prediction.c:413-526 */
void get_mv_pred(const parse_ctx_t *c, int ypos, int xpos, int size,
                        int *mvy, int *mvx)
{
    int bsz = size / MIN_PB;
    long bstr = c->bs;
    long bi = (long)(ypos / MIN_PB) * bstr + xpos / MIN_PB;
    long up0 = bi - bstr, up1 = bi - bstr + (bsz - 1) / 2;
    long up2 = bi - bstr + bsz - 1;
    long left0 = bi - 1, left1 = bi + bstr * ((bsz - 1) / 2) - 1;
    long left2 = bi + bstr * (bsz - 1) - 1;
    long downleft = bi + bstr * bsz - 1;
    long upright = bi - bstr + bsz;
    long upleft = bi - bstr - 1;
    int U = ypos > 0, L = xpos > 0;
    int UR = upright_avail(ypos, xpos, size, size, c->width, c->height,
                           c->sb_size);
    int DL = downleft_avail(ypos, xpos, size, size, c->width, c->height,
                            c->sb_size);
    long a = -1, b = -1, d = -1;
    if (U && !UR && !L && !DL)      { a = up0; b = up1; d = up2; }
    else if (U && UR && !L && !DL)  { a = up0; b = up2; d = upright; }
    else if (!U && !UR && L && !DL) { a = left0; b = left1; d = left2; }
    else if (U && !UR && L && !DL)  { a = upleft; b = up2; d = left2; }
    else if (U && UR && L && !DL)   { a = up0; b = upright; d = left2; }
    else if (!U && !UR && L && DL)  { a = left0; b = left2; d = downleft; }
    else if (U && !UR && L && DL)   { a = up2; b = left0; d = downleft; }
    else if (U && UR && L && DL)    { a = up0; b = upright; d = left0; }
    int ay = 0, ax = 0, by = 0, bx = 0, dy = 0, dx = 0;
    if (a >= 0) {
        ay = c->dd_mv0[2 * a]; ax = c->dd_mv0[2 * a + 1];
        by = c->dd_mv0[2 * b]; bx = c->dd_mv0[2 * b + 1];
        dy = c->dd_mv0[2 * d]; dx = c->dd_mv0[2 * d + 1];
    }
    *mvy = med3(ay, by, dy);
    *mvx = med3(ax, bx, dx);
}

/* inter_prediction.c:565-679 (LIMITED_SKIP gather + dedup) */
int gather_skip_merge(const parse_ctx_t *c, int ypos, int xpos,
                             int size, cand_t out[2])
{
    int bsz = size / MIN_PB;
    long bstr = c->bs;
    long bi = (long)(ypos / MIN_PB) * bstr + xpos / MIN_PB;
    long up0 = bi - bstr, up2 = bi - bstr + bsz - 1;
    long left0 = bi - 1, left2 = bi + bstr * (bsz - 1) - 1;
    long upright = bi - bstr + bsz;
    int up = ypos > 0, left = xpos > 0;
    int ur = upright_avail(ypos, xpos, size, size, c->width, c->height,
                           c->sb_size);
    if (ypos + size > c->height) left2 = left0;
    if (xpos + size > c->width) up2 = up0;
    cand_t zero; memset(&zero, 0, sizeof zero);
    cand_t c0 = left ? dd_pred(c, left2) : zero;
    cand_t c1;
    if (ur) c1 = dd_pred(c, upright);
    else if (up) c1 = dd_pred(c, up2);
    else c1 = zero;
    out[0] = c0;
    int n = 1;
    /* dedup (inter_prediction.c:661-679) */
    if (!(c1.mv0y == c0.mv0y && c1.mv0x == c0.mv0x &&
          c1.mv1y == c0.mv1y && c1.mv1x == c0.mv1x &&
          c1.ref0 == c0.ref0 && c1.ref1 == c0.ref1 &&
          (c1.dir == c0.dir || c1.dir == -1)))
        out[n++] = c1;
    return n;
}

/* inter_prediction.c:836-881 (interp_ref=2 temporal skip candidates) */
int skip_temp(const parse_ctx_t *c, int ypos, int xpos, int size,
                     cand_t *cands, int n)
{
    int gop = c->num_reorder_pics + 1;
    int phase = c->phase;
    int bw = size < c->width - xpos ? size : c->width - xpos;
    int bh = size < c->height - ypos ? size : c->height - ypos;
    cand_t c0 = cands[0];
    int duplicate = 1;
    for (int m = 0; m < bh / MIN_PB; m++)
        for (int nn = 0; nn < bw / MIN_PB; nn++) {
            long bi = (long)(ypos / MIN_PB + m) * c->bs + xpos / MIN_PB + nn;
            int m0y = c->dd_arr_mv0[(bi * 16 + phase) * 2];
            int m0x = c->dd_arr_mv0[(bi * 16 + phase) * 2 + 1];
            int m1y = m0y, m1x = m0x;
            if (gop == 3 && phase == 1) { m1y *= 2; m1x *= 2; }
            if (m0y != c0.mv0y || m0x != c0.mv0x || m1y != c0.mv1y ||
                m1x != c0.mv1x || c0.ref0 != 0 || c0.ref1 != 1 ||
                c0.dir != 2)
                duplicate = 0;
        }
    cand_t new0 = c0;
    new0.ref0 = 0; new0.ref1 = 1; new0.dir = 2;
    if (!duplicate) {
        cands[1] = c0;
        cands[0] = new0;
        return 2;
    }
    cands[0] = new0;
    return 1;
}

/* common/common_block.c:283-303 -> (split_ctx, cbp_ctx, ctx_index) */
void block_contexts(const parse_ctx_t *c, int ypos, int xpos,
                           int size, int *cbp_ctx, int *ctx_index)
{
    *cbp_ctx = -1; *ctx_index = -1;
    if (ypos >= MIN_BLOCK && xpos >= MIN_BLOCK &&
        ypos + size < c->height && xpos + size < c->width &&
        c->use_block_contexts && size <= 128) {
        long bs = c->bs;
        long bi = (long)(ypos / MIN_PB) * bs + xpos / MIN_PB;
        int split = (c->dd_size[bi - bs] < size) + (c->dd_size[bi - 1] < size);
        int cbp1 = (c->dd_cbp_y[bi - bs] > 0) + (c->dd_cbp_y[bi - 1] > 0);
        int cbp2 = ((c->dd_cbp_y[bi - bs] > 0 || c->dd_cbp_u[bi - bs] > 0 ||
                     c->dd_cbp_v[bi - bs] > 0) +
                    (c->dd_cbp_y[bi - 1] > 0 || c->dd_cbp_u[bi - 1] > 0 ||
                     c->dd_cbp_v[bi - 1] > 0));
        *cbp_ctx = cbp1;
        *ctx_index = 3 * split + cbp2;
    }
}

/* ---------- super mode (dec/decode_block.c:458-611) ---------- */

static void super_mode(parse_ctx_t *c, br_t *br, int size,
                       int decode_this_size, int ctx_index, int *split,
                       int *mode, int *ref_idx)
{
    *split = 0; *mode = MODE_SKIP; *ref_idx = 0;
    if (c->frame_type == I_FRAME) {
        if (size > MIN_BLOCK && decode_this_size)
            *split = (int)bp_bits(br, 1);
        else
            *split = !decode_this_size;
        *mode = MODE_INTRA;
        return;
    }
    if (!decode_this_size) {
        *split = !bp_bits(br, 1);
        return;
    }
    if (size > 128) {
        *split = !bp_bits(br, 1);
        return;
    }
    int num_ref = c->num_ref;
    int bipred_possible = num_ref > 1 && c->bipred;
    int split_possible = size > MIN_BLOCK;
    int maxbit = 2 + num_ref + split_possible + bipred_possible;
    int interp_ref = c->interp_ref;
    if (interp_ref > 2) maxbit -= 1;
    int code = get_vlc(br, 10 + maxbit);
    int64_t *sms = c->stats + ST_SMS +
        ((long)c->stat_frame_type * 5 + (ilog2i(size) - 3)) * 9;
    if (interp_ref) {
        if ((ctx_index == 2 || ctx_index > 3) && size > MIN_BLOCK)
            if (code < 3) code = (code + 1) % 3;
        if (split_possible && code == 1) { sms[STAT_SPLIT]++; *split = 1; return; }
        if (!split_possible && code > 0) code += 1;
        if (!bipred_possible && code >= 3) code += 1;
        if (code == 0) { sms[STAT_SKIP]++; return; }
        if (code == 2) { sms[STAT_MERGE]++; *mode = MODE_MERGE; return; }
        if (code == 3) { sms[STAT_BIPRED]++; *mode = MODE_BIPRED; return; }
        if (code == 4) { sms[STAT_INTRA]++; *mode = MODE_INTRA; return; }
        if (code == 4 + num_ref) { sms[STAT_REF_IDX0]++; *mode = MODE_INTER;
                                   return; }
        sms[STAT_REF_IDX1 + code - 5]++;
        *mode = MODE_INTER; *ref_idx = code - 4;
    } else {
        if ((ctx_index == 2 || ctx_index > 3) && size > MIN_BLOCK)
            if (code < 4) code = (code + 1) % 4;
        if (split_possible && code == 1) { sms[STAT_SPLIT]++; *split = 1; return; }
        if (!split_possible && code > 0) code += 1;
        if (!bipred_possible && code >= 4) code += 1;
        if (code == 0) { sms[STAT_SKIP]++; return; }
        if (code == 2) { sms[STAT_REF_IDX0]++; *mode = MODE_INTER; return; }
        if (code == 3) { sms[STAT_MERGE]++; *mode = MODE_MERGE; return; }
        if (code == 4) { sms[STAT_BIPRED]++; *mode = MODE_BIPRED; return; }
        if (code == 5) { sms[STAT_INTRA]++; *mode = MODE_INTRA; return; }
        sms[STAT_REF_IDX1 + code - 6]++;
        *mode = MODE_INTER; *ref_idx = code - 5;
    }
}

/* ---------- coefficient TB (dec/read_bits.c:142-241 + descan) ---------- */

static long read_tb(parse_ctx_t *c, br_t *br, int blk_idx, int plane,
                    int size, int ypos, int xpos, int qp, int ctype,
                    int dense)
{
    int qsize = size < MAX_QUANT ? size : MAX_QUANT;
    int N = qsize * qsize;
    int16_t scan[512];
    read_coeff_scan(br, scan, qsize, ctype);
    if (c->n_tb >= c->tb_cap || c->coef_len + N > c->coef_cap) {
        c->error = 1;
        return -1;
    }
    const int32_t *zz = qsize == 4 ? c->zz4 : qsize == 8 ? c->zz8 : c->zz16;
    int16_t *dst = c->coef + c->coef_len;
    for (int i = 0; i < N; i++)
        dst[i] = scan[zz[i]];
    int32_t *t = c->tb + c->n_tb * TREC_W;
    t[T_PLANE] = plane; t[T_SIZE] = size; t[T_YPOS] = ypos; t[T_XPOS] = xpos;
    t[T_QP] = qp; t[T_OFF] = (int32_t)c->coef_len; t[T_BLK] = blk_idx;
    t[T_DENSE] = dense;
    long off = c->coef_len;
    c->n_tb++;
    c->coef_len += N;
    if (dense && c->enable_plan) {
        int16_t *dc; long stride; int32_t *q4, *l4; long q4s;
        if (plane == 0) { dc = c->dcoef_y; stride = c->dcy_stride;
                          q4 = c->qp4_y; l4 = c->ls4_y; q4s = c->q4y_stride; }
        else { dc = plane == 1 ? c->dcoef_u : c->dcoef_v;
               stride = c->dcc_stride;
               q4 = c->qp4_c; l4 = c->ls4_c; q4s = c->q4c_stride; }
        for (int i = 0; i < qsize; i++)
            memcpy(dc + (long)(ypos + i) * stride + xpos, dst + i * qsize,
                   qsize * sizeof(int16_t));
        int ls = ilog2i(size);
        for (int i = ypos / 4; i < (ypos + size) / 4; i++)
            for (int j = xpos / 4; j < (xpos + size) / 4; j++) {
                q4[i * q4s + j] = qp;
                l4[i * q4s + j] = ls;
            }
    }
    return off;
}

/* ---------- MC planning (dec/device_pixels.py mirrors) ---------- */

static void clip_mv(int *mvy, int *mvx, int ypos, int xpos, int fw, int fh,
                    int bw, int bh, int sign)
{
    int y = *mvy, x = *mvx;
    if (sign) { y = -y; x = -x; }
    if (ypos + y / 4 < -MAX_MV_EXT) y = 4 * (-MAX_MV_EXT - ypos);
    if (ypos + y / 4 + bh > fh + MAX_MV_EXT) y = 4 * (fh + MAX_MV_EXT - ypos - bh);
    if (xpos + x / 4 < -MAX_MV_EXT) x = 4 * (-MAX_MV_EXT - xpos);
    if (xpos + x / 4 + bw > fw + MAX_MV_EXT) x = 4 * (fw + MAX_MV_EXT - xpos - bw);
    if (sign) { y = -y; x = -x; }
    *mvy = y; *mvx = x;
}

static void plan_fill_luma(parse_ctx_t *c, int lst, int ypos, int xpos,
                           int bw, int bh, int op, int y0, int x0, int vf,
                           int hf, int fs, int slot)
{
    int base = lst ? LY_OP1 : LY_OP0;
    long gw = c->gw;
    for (int i = 0; i < bh / 4; i++) {
        long row = ((long)(ypos / 4) + i) * gw + xpos / 4;
        for (int j = 0; j < bw / 4; j++) {
            c->ly[base + 0][row + j] = op;
            c->ly[base + 1][row + j] = y0 + i * 4;
            c->ly[base + 2][row + j] = x0 + j * 4;
            c->ly[base + 3][row + j] = vf;
            c->ly[base + 4][row + j] = hf;
            c->ly[base + 5][row + j] = fs;
            c->ly[base + 6][row + j] = slot;
        }
    }
}

static void plan_fill_chroma(parse_ctx_t *c, int lst, int ypos, int xpos,
                             int bw, int bh, int op, int y0, int x0,
                             int vf, int hf)
{
    int base = lst ? CH_OP1 : CH_OP0;
    long gw = c->gw;
    for (int i = 0; i < bh / 4; i++) {
        long row = ((long)(ypos / 4) + i) * gw + xpos / 4;
        for (int j = 0; j < bw / 4; j++) {
            c->ch[base + 0][row + j] = op;
            c->ch[base + 1][row + j] = y0 + i * 2;
            c->ch[base + 2][row + j] = x0 + j * 2;
            c->ch[base + 3][row + j] = vf;
            c->ch[base + 4][row + j] = hf;
        }
    }
}

/* mc_luma prologue (inter_prediction.c:117-150) */
static void plan_one_luma(parse_ctx_t *c, int lst, int mvy, int mvx,
                          int ypos, int xpos, int bw, int bh, int sign,
                          int bipred_arg, int cl_y, int cl_x, int slot)
{
    if (sign) { mvy = -mvy; mvx = -mvx; }
    int vf = mvy & 3, hf = mvx & 3;
    int vi = mvy >> 2, hi = mvx >> 2;
    int W = c->width, H = c->height;
    if (vi > H - cl_y) vi = H - cl_y;
    if (vi < -cl_x - bh) vi = -cl_x - bh;   /* reference quirk: xpos clamp */
    if (hi > W - cl_x) hi = W - cl_x;
    if (hi < -cl_x - bw) hi = -cl_x - bw;
    int y0 = ypos + vi, x0 = xpos + hi;
    int op, ovf = 0, ohf = 0, fs = 0;
    if (vf == 0 && hf == 0) op = OP_COPY;
    else if (vf == 2 && hf == 2 && bipred_arg < 2) op = OP_LOWPASS;
    else { op = OP_SIXTAP; ovf = vf; ohf = hf; fs = bipred_arg ? 1 : 0; }
    plan_fill_luma(c, lst, ypos, xpos, bw, bh, op, y0, x0, ovf, ohf, fs,
                   slot);
}

/* mc_chroma prologue (inter_prediction.c:65-90); coords in luma units,
 * plan origins in chroma units */
static void plan_one_chroma(parse_ctx_t *c, int lst, int mvy, int mvx,
                            int yposL, int xposL, int bwL, int bhL,
                            int sign, int cl_yL, int cl_xL)
{
    int ypos = yposL >> 1, xpos = xposL >> 1;
    int bw = bwL >> 1, bh = bhL >> 1;
    int cl_y = cl_yL >> 1, cl_x = cl_xL >> 1;
    int W2 = c->width >> 1, H2 = c->height >> 1;
    if (sign) { mvy = -mvy; mvx = -mvx; }
    int vf = mvy & 7, hf = mvx & 7;
    int vi = mvy >> 3, hi = mvx >> 3;
    if (vi > H2 - cl_y) vi = H2 - cl_y;
    if (vi < -cl_x - bh) vi = -cl_x - bh;
    if (hi > W2 - cl_x) hi = W2 - cl_x;
    if (hi < -cl_x - bw) hi = -cl_x - bw;
    int y0 = ypos + vi, x0 = xpos + hi;
    int op = (vf == 0 && hf == 0) ? OP_COPY : OP_SIXTAP;
    if (op == OP_COPY) { vf = 0; hf = 0; }
    plan_fill_chroma(c, lst, yposL, xposL, bwL, bhL, op, y0, x0, vf, hf);
}

static void plan_one_list(parse_ctx_t *c, const int32_t *rec, int lst,
                          int ridx, int sign, int bipred_arg, int split,
                          int ypos, int xpos, int bwidth, int bheight)
{
    int slot = c->ref_slot[ridx];
    int div = split + 1;
    int bw = bwidth / div, bh = bheight / div;
    const int32_t *mv = rec + (lst == 0 ? B_MV0 : B_MV1);
    for (int index = 0; index < div * div; index++) {
        int idx = index & 1, idy = (index >> 1) & 1;
        int oy = idy * bh, ox = idx * bw;
        int mvy = mv[2 * index], mvx = mv[2 * index + 1];
        clip_mv(&mvy, &mvx, ypos, xpos, c->width, c->height, bw, bh, sign);
        plan_one_luma(c, lst, mvy, mvx, ypos + oy, xpos + ox, bw, bh, sign,
                      bipred_arg, ypos, xpos, slot);
        plan_one_chroma(c, lst, mvy, mvx, ypos + oy, xpos + ox, bw, bh,
                        sign, ypos, xpos);
    }
}

static void plan_temp(parse_ctx_t *c, int ypos, int xpos, int bwidth,
                      int bheight, int slot0, int slot1)
{
    int gop = c->num_reorder_pics + 1;
    int phase = c->phase;
    for (int m = 0; m < bheight; m += MIN_PB)
        for (int n = 0; n < bwidth; n += MIN_PB) {
            long bi = (long)((ypos + m) / MIN_PB) * c->bs +
                (xpos + n) / MIN_PB;
            int mvy = c->dd_arr_mv0[(bi * 16 + phase) * 2];
            int mvx = c->dd_arr_mv0[(bi * 16 + phase) * 2 + 1];
            int yb = ypos + m, xb = xpos + n;
            int my = mvy, mx = mvx;
            clip_mv(&my, &mx, yb, xb, c->width, c->height, MIN_PB, MIN_PB, 0);
            plan_one_luma(c, 0, my, mx, yb, xb, MIN_PB, MIN_PB, 0, 2,
                          yb, xb, slot0);
            plan_one_chroma(c, 0, my, mx, yb, xb, MIN_PB, MIN_PB, 0, yb, xb);
            int m1y = mvy, m1x = mvx;
            if (gop == 3 && phase == 1) { m1y *= 2; m1x *= 2; }
            clip_mv(&m1y, &m1x, yb, xb, c->width, c->height, MIN_PB, MIN_PB,
                    1);
            plan_one_luma(c, 1, m1y, m1x, yb, xb, MIN_PB, MIN_PB, 1, 2,
                          yb, xb, slot1);
            plan_one_chroma(c, 1, m1y, m1x, yb, xb, MIN_PB, MIN_PB, 1, yb,
                            xb);
        }
}

static void plan_mark(parse_ctx_t *c, int32_t *grid, int ypos, int xpos,
                      int bw, int bh)
{
    for (int i = 0; i < bh / 4; i++) {
        long row = ((long)(ypos / 4) + i) * c->gw + xpos / 4;
        for (int j = 0; j < bw / 4; j++)
            grid[row + j] = 1;
    }
}

/* plan_block_mc (dec/device_pixels.py:189-259) */
void plan_block(parse_ctx_t *c, const int32_t *rec)
{
    int ypos = rec[B_YPOS], xpos = rec[B_XPOS], size = rec[B_SIZE];
    int mode = rec[B_MODE];
    int bwidth = size < c->width - xpos ? size : c->width - xpos;
    int bheight = size < c->height - ypos ? size : c->height - ypos;
    plan_mark(c, c->inter, ypos, xpos, bwidth, bheight);
    int temp_case = (mode == MODE_SKIP && rec[B_DIR] == 2 &&
                     c->stat_frame_type == B_FRAME &&
                     c->seq_interp_ref == 2 && rec[B_SKIP_IDX] == 0);
    if (temp_case) {
        plan_mark(c, c->avg, ypos, xpos, bwidth, bheight);
        plan_temp(c, ypos, xpos, bwidth, bheight,
                  c->ref_slot[rec[B_REF0]], c->ref_slot[rec[B_REF1]]);
        return;
    }
    int rn = c->rec_frame_num;
    if (mode == MODE_SKIP || mode == MODE_MERGE) {
        if (rec[B_DIR] == 2) {
            int r0 = rec[B_REF0], r1 = rec[B_REF1];
            int s0 = c->ref_frame_num[r0] >= rn;
            int s1 = c->ref_frame_num[r1] >= rn;
            plan_one_list(c, rec, 0, r0, s0, c->bipred, 0, ypos, xpos,
                          bwidth, bheight);
            plan_one_list(c, rec, 1, r1, s1, c->bipred, 0, ypos, xpos,
                          bwidth, bheight);
            plan_mark(c, c->avg, ypos, xpos, bwidth, bheight);
        } else {
            int r0 = rec[B_REF0];
            int s0 = c->ref_frame_num[r0] > rn;
            plan_one_list(c, rec, 0, r0, s0, c->bipred, 0, ypos, xpos,
                          bwidth, bheight);
        }
    } else if (mode == MODE_INTER) {
        int r0 = rec[B_REF0];
        int s0 = c->ref_frame_num[r0] > rn;
        plan_one_list(c, rec, 0, r0, s0, c->bipred, c->pb_split, ypos, xpos,
                      bwidth, bheight);
    } else if (mode == MODE_BIPRED) {
        int r0 = rec[B_REF0], r1 = rec[B_REF1];
        int s0 = c->ref_frame_num[r0] >= rn;
        int s1 = c->ref_frame_num[r1] >= rn;
        plan_one_list(c, rec, 0, r0, s0, c->bipred, c->pb_split, ypos, xpos,
                      bwidth, bheight);
        plan_one_list(c, rec, 1, r1, s1, c->bipred, c->pb_split, ypos, xpos,
                      bwidth, bheight);
        plan_mark(c, c->avg, ypos, xpos, bwidth, bheight);
    }
}

/* ---------- deblock-data copy (dec/decode_block.c:178-223) ---------- */

void copy_deblock_data(parse_ctx_t *c, const int32_t *rec)
{
    int ypos = rec[B_YPOS], xpos = rec[B_XPOS], size = rec[B_SIZE];
    int bwidth = size < c->width - xpos ? size : c->width - xpos;
    int bheight = size < c->height - ypos ? size : c->height - ypos;
    int posy = ypos / MIN_PB, posx = xpos / MIN_PB;
    int div = size / (2 * MIN_PB);
    int tb_split = rec[B_TBSPLIT] > 0;
    int pb_part = rec[B_MODE] == MODE_INTER ? rec[B_PBPART] : 0;
    int temp_case = (c->stat_frame_type == B_FRAME &&
                     c->seq_interp_ref == 2 && rec[B_MODE] == MODE_SKIP &&
                     rec[B_SKIP_IDX] == 0);
    int phase = c->phase;
    for (int m = 0; m < bheight / MIN_PB; m++)
        for (int n = 0; n < bwidth / MIN_PB; n++) {
            long bi = (long)(posy + m) * c->bs + posx + n;
            c->dd_cbp_y[bi] = rec[B_CBP_Y];
            c->dd_cbp_u[bi] = rec[B_CBP_U];
            c->dd_cbp_v[bi] = rec[B_CBP_V];
            c->dd_tb_split[bi] = tb_split;
            c->dd_pb_part[bi] = pb_part;
            c->dd_size[bi] = size;
            c->dd_mode[bi] = rec[B_MODE];
            if (temp_case) {
                int my = c->dd_arr_mv0[(bi * 16 + phase) * 2];
                int mx = c->dd_arr_mv0[(bi * 16 + phase) * 2 + 1];
                c->dd_mv0[2 * bi] = my; c->dd_mv0[2 * bi + 1] = mx;
                if (c->num_reorder_pics == 2 && phase == 1) {
                    c->dd_mv1[2 * bi] = 2 * my; c->dd_mv1[2 * bi + 1] = 2 * mx;
                } else {
                    c->dd_mv1[2 * bi] = my; c->dd_mv1[2 * bi + 1] = mx;
                }
            } else {
                int iy = div > 0 ? (m / div > 1 ? 1 : m / div) : 0;
                int ix = div > 0 ? (n / div > 1 ? 1 : n / div) : 0;
                int pidx = 2 * iy + ix;
                c->dd_mv0[2 * bi] = rec[B_MV0 + 2 * pidx];
                c->dd_mv0[2 * bi + 1] = rec[B_MV0 + 2 * pidx + 1];
                c->dd_mv1[2 * bi] = rec[B_MV1 + 2 * pidx];
                c->dd_mv1[2 * bi + 1] = rec[B_MV1 + 2 * pidx + 1];
            }
            c->dd_ref0[bi] = rec[B_REF0];
            c->dd_ref1[bi] = rec[B_REF1];
            c->dd_bipred[bi] = rec[B_DIR];
        }
}

/* ---------- read_block (dec/read_bits.c:252-773) ---------- */

static void read_mv_d(br_t *br, int py, int px, int *oy, int *ox)
{
    int mvabs = get_vlc(br, 7);
    int mvsign = mvabs ? (int)bp_bits(br, 1) : 0;
    int dx = mvsign ? -mvabs : mvabs;
    mvabs = get_vlc(br, 7);
    if (mvabs) mvsign = (int)bp_bits(br, 1);
    int dy = mvsign ? -mvabs : mvabs;
    *oy = py + dy;
    *ox = px + dx;
}

static const int cbp_table[8] = { 1, 0, 5, 2, 6, 3, 7, 4 };

static void read_block_c(parse_ctx_t *c, br_t *br, int size, int ypos,
                         int xpos, int mode, int ref_idx, int ctx_cbp,
                         int qpY, int qpC, int32_t *rec)
{
    int ft = c->stat_frame_type;
    int64_t *st = c->stats;
    int sizeY = size;
    int sizeC = c->mono ? 0 : size >> c->sub;
    long blk_idx = c->n_blk;
    memset(rec, 0, BREC_W * sizeof(int32_t));
    rec[B_YPOS] = ypos; rec[B_XPOS] = xpos; rec[B_SIZE] = size;
    rec[B_MODE] = mode; rec[B_QPY] = qpY; rec[B_QPC] = qpC;
    long bit_start = br->bitpos;

    if (mode == MODE_SKIP || mode == MODE_MERGE) {
        cand_t cands[3];
        int num = gather_skip_merge(c, ypos, xpos, size, cands);
        if (mode == MODE_SKIP && ft == B_FRAME && c->seq_interp_ref == 2)
            num = skip_temp(c, ypos, xpos, size, cands, num);
        int skip_idx = 0;
        if (num == 4) skip_idx = (int)bp_bits(br, 2);
        else if (num == 3) skip_idx = get_vlc(br, 12);
        else if (num == 2) skip_idx = (int)bp_bits(br, 1);
        st[ST_SKIP_IDX + ft] += br->bitpos - bit_start;
        cand_t cc = skip_idx == num ? cands[0] : cands[skip_idx];
        rec[B_SKIP_IDX] = skip_idx;
        rec[B_REF0] = cc.ref0; rec[B_REF1] = cc.ref1; rec[B_DIR] = cc.dir;
        for (int i = 0; i < 4; i++) {
            rec[B_MV0 + 2 * i] = cc.mv0y; rec[B_MV0 + 2 * i + 1] = cc.mv0x;
            rec[B_MV1 + 2 * i] = cc.mv1y; rec[B_MV1 + 2 * i + 1] = cc.mv1x;
        }
    } else if (mode == MODE_INTER) {
        int pb_part = c->pb_split ? get_vlc(br, 13) : 0;
        rec[B_PBPART] = pb_part;
        st[ST_SIZE_AND_REF + ((long)ft * 5 + (ilog2i(size) - 3)) * 4 +
           ref_idx]++;
        int py, px;
        get_mv_pred(c, ypos, xpos, size, &py, &px);
        int mv[4][2];
        read_mv_d(br, py, px, &mv[0][0], &mv[0][1]);
        if (pb_part == 0) {
            mv[1][0] = mv[2][0] = mv[3][0] = mv[0][0];
            mv[1][1] = mv[2][1] = mv[3][1] = mv[0][1];
        } else if (pb_part == 1) {           /* HOR */
            read_mv_d(br, mv[0][0], mv[0][1], &mv[2][0], &mv[2][1]);
            mv[1][0] = mv[0][0]; mv[1][1] = mv[0][1];
            mv[3][0] = mv[2][0]; mv[3][1] = mv[2][1];
        } else if (pb_part == 2) {           /* VER */
            read_mv_d(br, mv[0][0], mv[0][1], &mv[1][0], &mv[1][1]);
            mv[2][0] = mv[0][0]; mv[2][1] = mv[0][1];
            mv[3][0] = mv[1][0]; mv[3][1] = mv[1][1];
        } else {
            read_mv_d(br, mv[0][0], mv[0][1], &mv[1][0], &mv[1][1]);
            read_mv_d(br, mv[0][0], mv[0][1], &mv[2][0], &mv[2][1]);
            read_mv_d(br, mv[0][0], mv[0][1], &mv[3][0], &mv[3][1]);
        }
        for (int i = 0; i < 4; i++) {
            rec[B_MV0 + 2 * i] = mv[i][0]; rec[B_MV0 + 2 * i + 1] = mv[i][1];
            rec[B_MV1 + 2 * i] = mv[i][0]; rec[B_MV1 + 2 * i + 1] = mv[i][1];
        }
        st[ST_MV + ft] += br->bitpos - bit_start;
        rec[B_REF0] = rec[B_REF1] = ref_idx;
        rec[B_DIR] = 0;
    } else if (mode == MODE_BIPRED) {
        int py, px;
        get_mv_pred(c, ypos, xpos, size, &py, &px);
        int m0y, m0x, m1y, m1x;
        read_mv_d(br, py, px, &m0y, &m0x);
        int p2y = py, p2x = px;
        if (ft == B_FRAME) { p2y = m0y; p2x = m0x; }
        read_mv_d(br, p2y, p2x, &m1y, &m1x);
        for (int i = 0; i < 4; i++) {
            rec[B_MV0 + 2 * i] = m0y; rec[B_MV0 + 2 * i + 1] = m0x;
            rec[B_MV1 + 2 * i] = m1y; rec[B_MV1 + 2 * i + 1] = m1x;
        }
        if (ft == B_FRAME) {
            rec[B_REF0] = c->interp_ref > 0 ? 1 : 0;
            rec[B_REF1] = c->interp_ref > 0 ? 2 : 1;
        } else {
            if (c->num_ref == 2) {
                int code = get_vlc(br, 13);
                rec[B_REF0] = (code >> 1) & 1;
                rec[B_REF1] = code & 1;
            } else {
                int code = get_vlc(br, 10);
                rec[B_REF0] = (code >> 2) & 3;
                rec[B_REF1] = code & 3;
            }
        }
        rec[B_DIR] = 2;
        st[ST_BI_REF + (long)ft * 16 + rec[B_REF0] * c->num_ref +
           rec[B_REF1]]++;
        st[ST_MV + ft] += br->bitpos - bit_start;
    } else if (mode == MODE_INTRA) {
        rec[B_INTRA_MODE] = c->num_intra_modes <= 4 ? (int)bp_bits(br, 2)
                                                    : get_vlc(br, 8);
        st[ST_INTRA_MODE + ft] += br->bitpos - bit_start;
        rec[B_DIR] = -1;
    }

    if (mode != MODE_SKIP) {
        int ctype = (mode == MODE_INTRA) << 1;
        int tb_split = 0, code = 0;
        int cbpy = 0, cbpu = 0, cbpv = 0;
        if (c->mono) {
            cbpy = (int)bp_bits(br, 1);
            if (c->tb_split_enable && cbpy) {
                tb_split = (int)bp_bits(br, 1);
                cbpy &= !tb_split;
            }
        } else {
            bit_start = br->bitpos;          /* read_bits.c:563 */
            code = get_vlc(br, 0);
            int off = mode == MODE_MERGE ? 1 : 2;
            if (c->tb_split_enable) {
                tb_split = code == off;
                if (code > off) code -= 1;
            }
        }
        rec[B_TBSPLIT] = tb_split;
        st[ST_CBP + ft] += br->bitpos - bit_start;
        if (tb_split == 0) {
            if (!c->mono) {
                if (mode == MODE_MERGE) {
                    if (code == 7) code = 1;
                    else if (code > 0) code += 1;
                } else {
                    if (ctx_cbp == 0 && code < 2) code = 1 - code;
                }
                int tmp = 0;
                while (tmp < 8 && code != cbp_table[tmp]) tmp++;
                cbpy = tmp & 1; cbpu = (tmp >> 1) & 1; cbpv = (tmp >> 2) & 1;
            }
            rec[B_CBP_Y] = cbpy; rec[B_CBP_U] = cbpu; rec[B_CBP_V] = cbpv;
            int dense = 1;
            if (cbpy) {
                bit_start = br->bitpos;
                read_tb(c, br, (int)blk_idx, 0, sizeY, ypos, xpos, qpY,
                        ctype | 0, dense);
                st[ST_COEFF_Y + ft] += br->bitpos - bit_start;
            }
            if (!c->mono) {
                if (cbpu) {
                    bit_start = br->bitpos;
                    read_tb(c, br, (int)blk_idx, 1, sizeC, ypos >> c->sub,
                            xpos >> c->sub, qpC, ctype | 1, dense);
                    st[ST_COEFF_U + ft] += br->bitpos - bit_start;
                }
                if (cbpv) {
                    bit_start = br->bitpos;
                    read_tb(c, br, (int)blk_idx, 2, sizeC, ypos >> c->sub,
                            xpos >> c->sub, qpC, ctype | 1, dense);
                    st[ST_COEFF_V + ft] += br->bitpos - bit_start;
                }
            }
        } else {
            int dense = 1;
            int s2 = sizeY / 2;
            if (sizeC > 4) {
                int sc2 = sizeC / 2;
                for (int index = 0; index < 4; index++) {
                    int oy = (index >> 1) * s2, ox = (index & 1) * s2;
                    int oyc = (index >> 1) * sc2, oxc = (index & 1) * sc2;
                    bit_start = br->bitpos;
                    code = get_vlc(br, 0);
                    int tmp = 0;
                    while (tmp < 8 && code != cbp_table[tmp]) tmp++;
                    if (ctx_cbp == 0 && tmp < 2) tmp = 1 - tmp;
                    int cy = tmp & 1, cu = (tmp >> 1) & 1, cv = (tmp >> 2) & 1;
                    st[ST_CBP + ft] += br->bitpos - bit_start;
                    if (cy) {
                        bit_start = br->bitpos;
                        read_tb(c, br, (int)blk_idx, 0, s2, ypos + oy,
                                xpos + ox, qpY, ctype | 0, dense);
                        st[ST_COEFF_Y + ft] += br->bitpos - bit_start;
                    }
                    if (cu) {
                        bit_start = br->bitpos;
                        read_tb(c, br, (int)blk_idx, 1, sc2,
                                (ypos >> c->sub) + oyc,
                                (xpos >> c->sub) + oxc, qpC, ctype | 1,
                                dense);
                        st[ST_COEFF_U + ft] += br->bitpos - bit_start;
                    }
                    if (cv) {
                        bit_start = br->bitpos;
                        read_tb(c, br, (int)blk_idx, 2, sc2,
                                (ypos >> c->sub) + oyc,
                                (xpos >> c->sub) + oxc, qpC, ctype | 1,
                                dense);
                        st[ST_COEFF_V + ft] += br->bitpos - bit_start;
                    }
                }
            } else {
                for (int index = 0; index < 4; index++) {
                    int oy = (index >> 1) * s2, ox = (index & 1) * s2;
                    bit_start = br->bitpos;
                    int cy = (int)bp_bits(br, 1);
                    st[ST_CBP + ft] += br->bitpos - bit_start;
                    if (cy) {
                        bit_start = br->bitpos;
                        read_tb(c, br, (int)blk_idx, 0, s2, ypos + oy,
                                xpos + ox, qpY, ctype | 0, dense);
                        st[ST_COEFF_Y + ft] += br->bitpos - bit_start;
                    }
                }
                if (!c->mono) {
                    bit_start = br->bitpos;
                    int tmp = get_vlc(br, 13);
                    int cu = tmp & 1, cv = (tmp >> 1) & 1;
                    st[ST_CBP + ft] += br->bitpos - bit_start;
                    if (cu) {
                        bit_start = br->bitpos;
                        read_tb(c, br, (int)blk_idx, 1, sizeC,
                                ypos >> c->sub, xpos >> c->sub, qpC,
                                ctype | 1, dense);
                        st[ST_COEFF_U + ft] += br->bitpos - bit_start;
                    }
                    if (cv) {
                        bit_start = br->bitpos;
                        read_tb(c, br, (int)blk_idx, 2, sizeC,
                                ypos >> c->sub, xpos >> c->sub, qpC,
                                ctype | 1, dense);
                        st[ST_COEFF_V + ft] += br->bitpos - bit_start;
                    }
                }
            }
            rec[B_CBP_Y] = 1; rec[B_CBP_U] = 1; rec[B_CBP_V] = 1;
        }
    }

    /* mode/size statistics in 8x8 units (read_bits.c:766-771) */
    int bwidth = size < c->width - xpos ? size : c->width - xpos;
    int bheight = size < c->height - ypos ? size : c->height - ypos;
    long n8 = (long)(bwidth / MIN_BLOCK) * (bheight / MIN_BLOCK);
    int ls = ilog2i(size) - 3;
    st[ST_MODE + (long)ft * 5 + mode] += n8;
    st[ST_SIZE + (long)ft * 5 + ls] += n8;
    st[ST_SIZE_AND_MODE + ((long)ft * 5 + ls) * 5 + mode] += n8;
}

/* ---------- recursion (dec/decode_block.c:614-672) ---------- */

static void process_block_c(parse_ctx_t *c, br_t *br, int size, int ypos,
                            int xpos)
{
    if (ypos >= c->height || xpos >= c->width || c->error)
        return;
    /* Desynced/truncated stream: reading ran off the end of the unit
     * (same 64-bit-slack EOF rule as entropy.c:br_overrun and the
     * Python BitReader).  Flag the error so parse_frame returns -1 and
     * the caller falls back to the Python walk, which raises EOFError. */
    if (br->bitpos > (br->nbytes << 3) + 64) {
        c->error = 1;
        return;
    }
    int decode_this_size = (ypos + size <= c->height &&
                            xpos + size <= c->width);
    int decode_rect = !decode_this_size && c->frame_type != I_FRAME;
    long bit_start = br->bitpos;
    int cbp_ctx, ctx_index;
    block_contexts(c, ypos, xpos, size, &cbp_ctx, &ctx_index);
    int split, mode, ref_idx;
    super_mode(c, br, size, decode_this_size, ctx_index, &split, &mode,
               &ref_idx);
    if (size == c->sb_size && (split || mode != MODE_SKIP) &&
        c->max_delta_qp > 0) {
        int abs_dq = get_vlc(br, 0);
        int sign_dq = abs_dq > 0 ? (int)bp_bits(br, 1) : 0;
        int delta_qp = sign_dq ? -abs_dq : abs_dq;
        int prev_qp = (ypos == 0 && xpos == 0) ? c->qp : c->qpb;
        c->qpb = prev_qp + delta_qp;
    }
    c->stats[ST_SUPER_MODE + c->stat_frame_type] += br->bitpos - bit_start;
    if (split && size >= MIN_BLOCK) {
        int ns = size / 2;
        process_block_c(c, br, ns, ypos, xpos);
        process_block_c(c, br, ns, ypos + ns, xpos);
        process_block_c(c, br, ns, ypos, xpos + ns);
        process_block_c(c, br, ns, ypos + ns, xpos + ns);
    } else if (decode_this_size || decode_rect) {
        if (c->n_blk >= c->blk_cap) { c->error = 1; return; }
        int qpY = c->qpb;
        int qpC = rec_qpc(qpY, c->sub);
        int32_t *rec = c->blk + c->n_blk * BREC_W;
        read_block_c(c, br, size, ypos, xpos, mode, ref_idx, cbp_ctx, qpY,
                     qpC, rec);
        c->n_blk++;
        if (c->enable_plan && mode != MODE_INTRA)
            plan_block(c, rec);
        copy_deblock_data(c, rec);
    }
}

/* chroma QP mapping (common tables): CHROMA_QP[qp] when sub else qp */
static const int chroma_qp_tab[52] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 29,
    30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37, 38,
    39, 40, 41, 42, 43, 44, 45 };

int rec_qpc(int qpY, int sub)
{
    if (!sub) return qpY;
    if (qpY < 0) return qpY;
    if (qpY > 51) qpY = 51;
    return chroma_qp_tab[qpY];
}

/* ---------- entry point ---------- */

long parse_frame(parse_ctx_t *c)
{
    br_t br;
    br.data = c->data;
    br.nbytes = c->nbytes;
    br.bitpos = c->bitpos;
    c->n_blk = 0;
    c->n_tb = 0;
    c->coef_len = 0;
    c->error = 0;
    int sb = c->sb_size;
    int nh = (c->height + sb - 1) / sb;
    int nw = (c->width + sb - 1) / sb;
    for (int k = 0; k < nh && !c->error; k++)
        for (int l = 0; l < nw && !c->error; l++)
            process_block_c(c, &br, sb, k * sb, l * sb);
    c->bitpos = br.bitpos;
    return c->error ? -1 : c->n_blk;
}
