/* Native host-side block-layer emitter for the turbo encoder.
 *
 * Two entry points, mirroring enc/turbo_final.py's two host passes
 * around the device finalization dispatch:
 *
 *   plan_frame_turbo  - pass 1: walk the decided quadtree in coding
 *     order, derive the normative skip candidates / MVP (same helpers
 *     the native decoder parse uses, blockparse.c), resolve the skip
 *     index by nearest-candidate match, fill deblock data (geometry/mv
 *     now, cbp in pass 2), the dense MC plan grids and the qp/size
 *     grids, and append one extended leaf record per block.
 *
 *   emit_frame_turbo  - pass 2 (after the device computed quantized
 *     coefficients): re-walk the records, derive block contexts from
 *     the live deblock-data state, and write the complete frame syntax:
 *     super mode, intra mode / MVs / skip index, cbp code and
 *     coefficient scans (enc/write_bits.c:257-600).  Deblock data is
 *     re-filled with the real cbp as emission proceeds so later
 *     contexts and the filter tail see the coded state.
 *
 * Scope matches turbo_supported (enc/turbo.py): I/P/B, 4:2:0 8-bit,
 * no tb/pb split, no merge, fixed QP, 128 superblocks.  Semantics
 * mirror enc/writer.py (itself mirroring the reference
 * enc/write_bits.c); exactness is enforced by tests comparing the
 * native emission byte-for-byte against the Python emitter.
 */
#include <stdint.h>
#include <string.h>

#include "thor_native.h"

/* extended record layout: BREC fields + turbo extras */
#define EREC_W 40
enum { E_MVPY = 32, E_MVPX, E_NSKIP, E_ISEG, E_ILANE, E_KIND };
/* E_KIND: 0 = split node, 1 = leaf */

static int eilog2(int v) { int c = -1; while (v) { v >>= 1; c++; } return c; }

/* ---------------------------------------------------------------------
 * pass 1: plan walk
 * ------------------------------------------------------------------- */

typedef struct {
    /* decision grids per size index (log2(size)-3: 8,16,32,64,128) */
    const int32_t *choice[5];
    const int32_t *mv_skip[5];   /* [n][2] skip probe MV (y,x) */
    const int32_t *mv_int[5];    /* [n][2] list-0 inter MV */
    const int32_t *mv_int1[5];   /* [n][2] list-1 inter MV (B), else NULL */
    const int32_t *imode[5];     /* [n] intra mode */
    int32_t gw[5];               /* decision-grid width in blocks */
    int32_t is_b, r0i, r1i, qp, qpc;
    /* decided tb_split flags per size (HE presets), or NULL:
     * bit0 inter(list0), bit1 inter(list1), bit2 bipred */
    const int32_t *tb[5];
} turbo_plan_t;

static int32_t *next_rec(parse_ctx_t *c)
{
    if (c->n_blk >= c->blk_cap) { c->error = 1; return 0; }
    int32_t *r = c->blk + c->n_blk * EREC_W;
    c->n_blk++;
    memset(r, 0, EREC_W * sizeof(int32_t));
    return r;
}

static void mark_qp4(parse_ctx_t *c, int ypos, int xpos, int size,
                     int qp, int qpc, int tb)
{
    /* tb_split halves the TB size (luma always; chroma unless it would
     * drop below 4x4, i.e. 8-blocks keep one 4x4 chroma TB) */
    int ls = eilog2(size) - (tb ? 1 : 0);
    for (int i = 0; i < size / 4; i++) {
        long row = ((long)(ypos / 4) + i) * c->q4y_stride + xpos / 4;
        for (int j = 0; j < size / 4; j++) {
            c->qp4_y[row + j] = qp;
            c->ls4_y[row + j] = ls;
        }
    }
    int sC = size >> 1, yC = ypos >> 1, xC = xpos >> 1;
    int lsC = eilog2(sC) - ((tb && sC > 4) ? 1 : 0);
    for (int i = 0; i < sC / 4; i++) {
        long row = ((long)(yC / 4) + i) * c->q4c_stride + xC / 4;
        for (int j = 0; j < sC / 4; j++) {
            c->qp4_c[row + j] = qpc;
            c->ls4_c[row + j] = lsC;
        }
    }
}

static void plan_walk(parse_ctx_t *c, const turbo_plan_t *t, int size,
                      int ypos, int xpos)
{
    if (ypos + 8 > c->height || xpos + 8 > c->width || c->error)
        return;
    int encode_this = (ypos + size <= c->height &&
                       xpos + size <= c->width);
    int si = eilog2(size) - 3;
    long flat = (long)(ypos / size) * t->gw[si] + xpos / size;
    int ch = encode_this ? t->choice[si][flat] : 3;

    if (ch == 3 && size > 8) {
        int32_t *r = next_rec(c);
        if (!r) return;
        r[B_YPOS] = ypos; r[B_XPOS] = xpos; r[B_SIZE] = size;
        r[E_KIND] = 0;
        int ns = size / 2;
        plan_walk(c, t, ns, ypos, xpos);
        plan_walk(c, t, ns, ypos + ns, xpos);
        plan_walk(c, t, ns, ypos, xpos + ns);
        plan_walk(c, t, ns, ypos + ns, xpos + ns);
        return;
    }

    int32_t *r = next_rec(c);
    if (!r) return;
    r[B_YPOS] = ypos; r[B_XPOS] = xpos; r[B_SIZE] = size;
    r[B_QPY] = t->qp; r[B_QPC] = t->qpc;
    r[E_KIND] = 1;
    r[E_ISEG] = -1; r[E_ILANE] = -1;
    int is_p = c->frame_type != I_FRAME;

    if (ch == 2 || !is_p) {
        r[B_MODE] = MODE_INTRA;
        r[B_INTRA_MODE] = t->imode[si][flat];
        r[B_DIR] = -1;
    } else if (ch == 0) {
        /* skip: exact candidate match to the probed MV (turbo_final.py).
         * The decision's skip SSD was computed WITH the probe MV; coding
         * the nearest-but-different candidate realizes a different
         * (possibly much worse) prediction, so on P frames a probe MV
         * absent from the true list demotes the block to MODE_INTER with
         * the probed MV - the pixels the decision costed, plus residual
         * coding, at a few extra MV/cbp bits.  B frames demote with
         * ref_idx 0 = slot 0, the same reference the skip probes used
         * (the interpolated frame under interp_ref=1 - the reference
         * encoder likewise allows MODE_INTER with ref_idx 0 there,
         * enc/encode_block.c:1966-1973). */
        cand_t cands[2];
        int n = gather_skip_merge(c, ypos, xpos, size, cands);
        int wy = t->mv_skip[si][2 * flat], wx = t->mv_skip[si][2 * flat + 1];
        int bidx = 0;
        long bdist = 1L << 30;
        for (int i = 0; i < n; i++) {
            long d = (cands[i].mv0y > wy ? cands[i].mv0y - wy
                                         : wy - cands[i].mv0y) +
                     (cands[i].mv0x > wx ? cands[i].mv0x - wx
                                         : wx - cands[i].mv0x);
            if (d < bdist) { bdist = d; bidx = i; }
        }
        if (bdist != 0) {
            int mvpy, mvpx;
            get_mv_pred(c, ypos, xpos, size, &mvpy, &mvpx);
            r[B_MODE] = MODE_INTER;
            r[B_REF0] = 0; r[B_REF1] = 0; r[B_DIR] = 0;
            r[E_MVPY] = mvpy; r[E_MVPX] = mvpx;
            for (int i = 0; i < 4; i++) {
                r[B_MV0 + 2 * i] = wy; r[B_MV0 + 2 * i + 1] = wx;
                r[B_MV1 + 2 * i] = wy; r[B_MV1 + 2 * i + 1] = wx;
            }
        } else {
        cand_t *k = &cands[bidx];
        r[B_MODE] = MODE_SKIP;
        r[B_SKIP_IDX] = bidx;
        r[E_NSKIP] = n;
        r[B_REF0] = k->ref0; r[B_REF1] = k->ref1; r[B_DIR] = k->dir;
        for (int i = 0; i < 4; i++) {
            r[B_MV0 + 2 * i] = k->mv0y; r[B_MV0 + 2 * i + 1] = k->mv0x;
            r[B_MV1 + 2 * i] = k->mv1y; r[B_MV1 + 2 * i + 1] = k->mv1x;
        }
        }
    } else if (ch == 5) {
        /* bipred: list-0 MV direct, list-1 negated (future ref is MC'd
         * with sign=1, which negates the emitted vector) */
        int mvpy, mvpx;
        get_mv_pred(c, ypos, xpos, size, &mvpy, &mvpx);
        if (t->tb[si])
            r[B_TBSPLIT] = (t->tb[si][flat] >> 2) & 1;
        r[B_MODE] = MODE_BIPRED;
        r[B_REF0] = t->r0i; r[B_REF1] = t->r1i; r[B_DIR] = 2;
        r[E_MVPY] = mvpy; r[E_MVPX] = mvpx;
        int m0y = t->mv_int[si][2 * flat], m0x = t->mv_int[si][2 * flat + 1];
        int m1y = -t->mv_int1[si][2 * flat];
        int m1x = -t->mv_int1[si][2 * flat + 1];
        for (int i = 0; i < 4; i++) {
            r[B_MV0 + 2 * i] = m0y; r[B_MV0 + 2 * i + 1] = m0x;
            r[B_MV1 + 2 * i] = m1y; r[B_MV1 + 2 * i + 1] = m1x;
        }
    } else {
        /* uni inter: ch 1 = list 0 (past), ch 4 = list 1 (future,
         * emitted negated for sign=1 MC) */
        int mvpy, mvpx;
        get_mv_pred(c, ypos, xpos, size, &mvpy, &mvpx);
        int mvy, mvx, ridx;
        if (ch == 4) {
            mvy = -t->mv_int1[si][2 * flat];
            mvx = -t->mv_int1[si][2 * flat + 1];
            ridx = t->r1i;
            if (t->tb[si])
                r[B_TBSPLIT] = (t->tb[si][flat] >> 1) & 1;
        } else {
            mvy = t->mv_int[si][2 * flat];
            mvx = t->mv_int[si][2 * flat + 1];
            ridx = t->is_b ? t->r0i : 0;
            if (t->tb[si])
                r[B_TBSPLIT] = t->tb[si][flat] & 1;
        }
        r[B_MODE] = MODE_INTER;
        /* ref_idx1 mirrors ref_idx0 (read_block sets both to the
         * signalled ref) so deblock-data-derived candidates stay in
         * sync with the decoder */
        r[B_REF0] = ridx; r[B_REF1] = ridx; r[B_DIR] = 0;
        r[E_MVPY] = mvpy; r[E_MVPX] = mvpx;
        for (int i = 0; i < 4; i++) {
            r[B_MV0 + 2 * i] = mvy; r[B_MV0 + 2 * i + 1] = mvx;
            r[B_MV1 + 2 * i] = mvy; r[B_MV1 + 2 * i + 1] = mvx;
        }
    }

    if (r[B_MODE] == MODE_SKIP || r[B_MODE] == MODE_INTER ||
        r[B_MODE] == MODE_BIPRED)
        plan_block(c, r);
    if (r[B_MODE] == MODE_INTER || r[B_MODE] == MODE_BIPRED)
        mark_qp4(c, ypos, xpos, size, t->qp, t->qpc, r[B_TBSPLIT]);
    /* geometry/mv deblock fill (cbp still 0 here; corrected in pass 2)
     * so later candidate derivation sees the coded state */
    copy_deblock_data(c, r);
}

long plan_frame_turbo(parse_ctx_t *c, const turbo_plan_t *t)
{
    int sb = c->sb_size;
    int nsh = (c->width + sb - 1) / sb;
    int nsv = (c->height + sb - 1) / sb;
    c->n_blk = 0;
    c->error = 0;
    for (int k = 0; k < nsv; k++)
        for (int l = 0; l < nsh; l++)
            plan_walk(c, t, sb, k * sb, l * sb);
    return c->error ? -1 : c->n_blk;
}

/* ---------------------------------------------------------------------
 * pass 2: syntax emission
 * ------------------------------------------------------------------- */

typedef struct {
    const int16_t *icq;   /* [3][S][L][16][16] intra quantized coeffs */
    const int32_t *icb;   /* [S][L][3] intra cbp flags */
    long S, L;
} turbo_emit_t;

/* enc/write_bits.c:123-143 */
static void emit_mv(bw_t *w, int mvy, int mvx, int mvpy, int mvpx)
{
    int dx = mvx - mvpx, dy = mvy - mvpy;
    unsigned ax = dx < 0 ? -dx : dx, ay = dy < 0 ? -dy : dy;
    put_vlc(w, 7, ax);
    if (ax) bw_putbits_x(w, 1, dx < 0);
    put_vlc(w, 7, ay);
    if (ay) bw_putbits_x(w, 1, dy < 0);
}

/* enc/write_bits.c:257-358 */
static void emit_super_mode(const parse_ctx_t *c, bw_t *w, int size,
                            int mode, int ref0, int split,
                            int encode_this, int ctx_index)
{
    if (c->frame_type != I_FRAME) {
        if (!encode_this) { bw_putbits_x(w, 1, !split); return; }
        int bipred_possible = c->num_ref > 1 && c->bipred;
        int split_possible = size > 8;
        int ir = c->interp_ref;
        int maxbit = 2 + c->num_ref + split_possible + bipred_possible;
        if (ir > 2) maxbit--;
        if (split == 1) {
            if (size > 128) { bw_putbits_x(w, 1, 0); return; }
            int code = 1;
            if (ctx_index == 2 || ctx_index > 3) code = (code + 3) % 4;
            put_vlc(w, 10 + maxbit, (unsigned)code);
            return;
        }
        int code;
        if (ir) {
            if (mode == MODE_SKIP) code = 0;
            else if (mode == MODE_MERGE) code = 2;
            else if (mode == MODE_BIPRED) code = 3;
            else if (mode == MODE_INTRA) code = 4;
            else if (mode == MODE_INTER && ref0 > 0) code = 4 + ref0;
            else code = 4 + c->num_ref;
            if (!bipred_possible && code > 3) code--;
            if (!split_possible && code > 1) code--;
            if ((ctx_index == 2 || ctx_index > 3) && size > 8 && code < 3)
                code = (code + 2) % 3;
        } else {
            if (mode == MODE_SKIP) code = 0;
            else if (mode == MODE_INTER && ref0 == 0) code = 2;
            else if (mode == MODE_MERGE) code = 3;
            else if (mode == MODE_BIPRED) code = 4;
            else if (mode == MODE_INTRA) code = 5;
            else code = 5 + ref0;
            if (!bipred_possible && code > 4) code--;
            if (!split_possible && code > 1) code--;
            if ((ctx_index == 2 || ctx_index > 3) && size > 8 && code < 4)
                code = (code + 3) % 4;
        }
        put_vlc(w, 10 + maxbit, (unsigned)code);
    } else {
        if (encode_this && (size > 8 || split == 1))
            bw_putbits_x(w, 1, split);
    }
}

static const int cbp_code_tab[8] = { 1, 0, 5, 2, 6, 3, 7, 4 };

/* zigzag-scan a raster block into sc16 (scan[zz[i]] = raster[i]);
 * returns 1 if any nonzero */
static int zz_scan(const parse_ctx_t *c, const int16_t *src, long stride,
                   int qsize, int16_t *sc16)
{
    const int32_t *zz = qsize == 4 ? c->zz4 : (qsize == 8 ? c->zz8
                                                          : c->zz16);
    int any = 0;
    memset(sc16, 0, qsize * qsize * sizeof(int16_t));
    for (int i = 0; i < qsize; i++)
        for (int j = 0; j < qsize; j++) {
            int16_t v = src[i * stride + j];
            sc16[zz[i * qsize + j]] = v;
            any |= v;
        }
    return any != 0;
}

long emit_frame_turbo(parse_ctx_t *c, bw_t *w, const turbo_emit_t *t)
{
    long icq_plane = t->S * t->L * 256;

    for (long bi = 0; bi < c->n_blk; bi++) {
        int32_t *r = c->blk + bi * EREC_W;
        int size = r[B_SIZE], ypos = r[B_YPOS], xpos = r[B_XPOS];
        int encode_this = (ypos + size <= c->height &&
                           xpos + size <= c->width);
        int cbp_ctx, ctx_index;
        block_contexts(c, ypos, xpos, size, &cbp_ctx, &ctx_index);

        if (w->bytepos + 16384 > w->cap) { c->error = 1; return -1; }

        if (r[E_KIND] == 0) {           /* split */
            emit_super_mode(c, w, size, MODE_SKIP, 0, 1, encode_this,
                            ctx_index);
            continue;
        }

        int mode = r[B_MODE];
        emit_super_mode(c, w, size, mode, r[B_REF0], 0, encode_this,
                        ctx_index);

        /* coefficient block pointers + cbp */
        const int16_t *cy = 0, *cu = 0, *cv = 0;
        long sy = 0, sc_ = 0;
        int qs = size < MAX_QUANT ? size : MAX_QUANT;
        int sC = size >> 1;
        int qsc = sC < MAX_QUANT ? sC : MAX_QUANT;
        int cbp_y = 0, cbp_u = 0, cbp_v = 0;

        if (mode == MODE_INTRA) {
            if (c->num_intra_modes <= 4)
                bw_putbits_x(w, 2, (uint32_t)r[B_INTRA_MODE]);
            else
                put_vlc(w, 8, (unsigned)r[B_INTRA_MODE]);
            long off = (r[E_ISEG] * t->L + r[E_ILANE]) * 256;
            cy = t->icq + off;
            cu = t->icq + icq_plane + off;
            cv = t->icq + 2 * icq_plane + off;
            sy = 16; sc_ = 16;
            const int32_t *cb = t->icb + (r[E_ISEG] * t->L +
                                          r[E_ILANE]) * 3;
            cbp_y = cb[0]; cbp_u = cb[1]; cbp_v = cb[2];
        } else if (mode == MODE_INTER) {
            /* PU partition code precedes the MVs when pb_split is
             * enabled (enc/write_bits.c:405-406); turbo always codes
             * PART_NONE */
            if (c->pb_split)
                put_vlc(w, 13, 0);
            emit_mv(w, r[B_MV0], r[B_MV0 + 1], r[E_MVPY], r[E_MVPX]);
        } else if (mode == MODE_BIPRED) {
            int mvpy = r[E_MVPY], mvpx = r[E_MVPX];
            emit_mv(w, r[B_MV0], r[B_MV0 + 1], mvpy, mvpx);
            if (c->frame_type == B_FRAME) {
                mvpy = r[B_MV0]; mvpx = r[B_MV0 + 1];
            }
            emit_mv(w, r[B_MV1], r[B_MV1 + 1], mvpy, mvpx);
            if (c->frame_type == P_FRAME) {
                if (c->num_ref == 2)
                    put_vlc(w, 13,
                            (unsigned)(2 * r[B_REF0] + r[B_REF1]));
                else
                    put_vlc(w, 10,
                            (unsigned)(4 * r[B_REF0] + r[B_REF1]));
            }
        } else {                         /* MODE_SKIP */
            int n = r[E_NSKIP];
            if (n == 4) bw_putbits_x(w, 2, (uint32_t)r[B_SKIP_IDX]);
            else if (n == 3) put_vlc(w, 12, (unsigned)r[B_SKIP_IDX]);
            else if (n == 2) bw_putbits_x(w, 1, (uint32_t)r[B_SKIP_IDX]);
        }

        if (mode != MODE_SKIP && r[B_TBSPLIT]) {
            /* tb_split=1: cbp/tb code = off (2 for non-merge), then
             * per-quadrant cbp + coefficient scans
             * (enc/write_bits.c:505-560, writer.py tb branch) */
            put_vlc(w, 0, 2);
            long dy0 = (long)ypos * c->dcy_stride + xpos;
            long dc0 = (long)(ypos >> 1) * c->dcc_stride + (xpos >> 1);
            int s2 = size >> 1;
            int qs2 = s2 < MAX_QUANT ? s2 : MAX_QUANT;
            int16_t scy[MAX_QUANT * MAX_QUANT];
            int16_t scu[MAX_QUANT * MAX_QUANT];
            int16_t scv[MAX_QUANT * MAX_QUANT];
            cbp_y = cbp_u = cbp_v = 0;
            if (sC > 4) {
                int sC2 = sC >> 1;
                int qsc2 = sC2 < MAX_QUANT ? sC2 : MAX_QUANT;
                int vlc10 = sC2 <= 8;
                for (int idx = 0; idx < 4; idx++) {
                    const int16_t *py = c->dcoef_y + dy0 +
                        (long)(idx >> 1) * s2 * c->dcy_stride +
                        (idx & 1) * s2;
                    const int16_t *pu = c->dcoef_u + dc0 +
                        (long)(idx >> 1) * sC2 * c->dcc_stride +
                        (idx & 1) * sC2;
                    const int16_t *pv = c->dcoef_v + dc0 +
                        (long)(idx >> 1) * sC2 * c->dcc_stride +
                        (idx & 1) * sC2;
                    int ay = zz_scan(c, py, c->dcy_stride, qs2, scy);
                    int au = zz_scan(c, pu, c->dcc_stride, qsc2, scu);
                    int av = zz_scan(c, pv, c->dcc_stride, qsc2, scv);
                    int cbp = ay + (au << 1) + (av << 2);
                    int code = cbp_code_tab[cbp];
                    if (cbp_ctx == 0 && code < 2)
                        code = 1 - code;
                    put_vlc(w, 0, (unsigned)code);
                    if (ay) write_coeff_scan(w, scy, qs2, 0, 0);
                    if (au) write_coeff_scan(w, scu, qsc2, 1, vlc10);
                    if (av) write_coeff_scan(w, scv, qsc2, 1, vlc10);
                    cbp_y = (cbp_y << 1) + ay;
                    cbp_u = (cbp_u << 1) + au;
                    cbp_v = (cbp_v << 1) + av;
                }
            } else {
                /* size 8: luma 4x4 quadrants, chroma unsplit 4x4 */
                for (int idx = 0; idx < 4; idx++) {
                    const int16_t *py = c->dcoef_y + dy0 +
                        (long)(idx >> 1) * s2 * c->dcy_stride +
                        (idx & 1) * s2;
                    int ay = zz_scan(c, py, c->dcy_stride, qs2, scy);
                    bw_putbits_x(w, 1, (uint32_t)(ay != 0));
                    if (ay) write_coeff_scan(w, scy, qs2, 0, 0);
                    cbp_y = (cbp_y << 1) + ay;
                }
                int au = zz_scan(c, c->dcoef_u + dc0, c->dcc_stride,
                                 qsc, scu);
                int av = zz_scan(c, c->dcoef_v + dc0, c->dcc_stride,
                                 qsc, scv);
                put_vlc(w, 13, (unsigned)(au + 2 * av));
                if (au) write_coeff_scan(w, scu, qsc, 1, 1);
                if (av) write_coeff_scan(w, scv, qsc, 1, 1);
                cbp_u = au;
                cbp_v = av;
            }
        } else if (mode != MODE_SKIP) {
            if (mode != MODE_INTRA) {
                cy = c->dcoef_y + (long)ypos * c->dcy_stride + xpos;
                cu = c->dcoef_u + (long)(ypos >> 1) * c->dcc_stride +
                     (xpos >> 1);
                cv = c->dcoef_v + (long)(ypos >> 1) * c->dcc_stride +
                     (xpos >> 1);
                sy = c->dcy_stride; sc_ = c->dcc_stride;
            }
            int16_t scy[MAX_QUANT * MAX_QUANT];
            int16_t scu[MAX_QUANT * MAX_QUANT];
            int16_t scv[MAX_QUANT * MAX_QUANT];
            int ay = zz_scan(c, cy, sy, qs, scy);
            int au = zz_scan(c, cu, sc_, qsc, scu);
            int av = zz_scan(c, cv, sc_, qsc, scv);
            if (mode == MODE_INTRA) {
                /* device cbp is authoritative (it decided the recon) */
                ay = cbp_y; au = cbp_u; av = cbp_v;
            }
            cbp_y = ay; cbp_u = au; cbp_v = av;

            int cbp = (ay != 0) + ((au != 0) << 1) + ((av != 0) << 2);
            int code = cbp_code_tab[cbp];
            if (cbp_ctx == 0 && code < 2)
                code = 1 - code;
            /* tb-split-capable presets widen the cbp code space
             * (enc/write_bits.c:505-516): tb_split=0 codes shift past
             * the tb_split slot */
            if (c->tb_split_enable == 1 && code >= 2)
                code += 1;
            put_vlc(w, 0, (unsigned)code);

            int ctype = (mode == MODE_INTRA) << 1;
            int vlc10 = sC <= 8;
            if (ay) write_coeff_scan(w, scy, qs, ctype | 0, 0);
            if (au) write_coeff_scan(w, scu, qsc, ctype | 1, vlc10);
            if (av) write_coeff_scan(w, scv, qsc, ctype | 1, vlc10);
        }

        r[B_CBP_Y] = cbp_y; r[B_CBP_U] = cbp_u; r[B_CBP_V] = cbp_v;
        copy_deblock_data(c, r);
    }
    return 0;
}
