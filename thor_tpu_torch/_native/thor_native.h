/* Shared types + helper prototypes for the native host-side tier
 * (entropy.c bit I/O, blockparse.c decoder walk, blockemit.c encoder
 * walk).  The Python mirror of parse_ctx_t lives in _native/__init__.py
 * (ParseCtx) - field order must match exactly.
 */
#ifndef THOR_NATIVE_H
#define THOR_NATIVE_H

#include <stdint.h>

/* ---- bit reader (entropy.c) ---- */
typedef struct {
    const uint8_t *data;
    long nbytes;
    long bitpos;
} br_t;
int get_vlc(br_t *br, int n);
void read_coeff_scan(br_t *br, int16_t *scoeff, int qsize, int type);

/* ---- bit writer (entropy.c) ---- */
typedef struct {
    uint8_t *buf;
    long cap;
    long bytepos;
    uint32_t bitbuf;
    int bitrest;
} bw_t;
void put_vlc(bw_t *w, int n, unsigned cn);
void write_coeff_scan(bw_t *w, const int16_t *scoeff, int qsize, int type,
                      int vlc10);
void bw_putbits_x(bw_t *w, int n, uint32_t val);

/* ---- codec constants (common/global.h) ---- */
#define MIN_PB 4
#define MIN_BLOCK 8
#define MAX_QUANT 16
#define MAX_MV_EXT 144

enum { I_FRAME = 0, P_FRAME = 1, B_FRAME = 2 };
enum { MODE_SKIP = 0, MODE_INTRA = 1, MODE_INTER = 2, MODE_BIPRED = 3,
       MODE_MERGE = 4 };

/* leaf block record (int32 x 32); blockemit.c extends to EREC_W=40 */
#define BREC_W 32
enum { B_YPOS = 0, B_XPOS, B_SIZE, B_MODE, B_TBSPLIT, B_PBPART,
       B_INTRA_MODE, B_SKIP_IDX, B_REF0, B_REF1, B_DIR, B_CBP_Y, B_CBP_U,
       B_CBP_V, B_QPY, B_QPC, B_MV0 = 16, B_MV1 = 24 };

/* TB record (int32 x 8) */
#define TREC_W 8
enum { T_PLANE = 0, T_SIZE, T_YPOS, T_XPOS, T_QP, T_OFF, T_BLK, T_DENSE };

/* luma / chroma plan grid indices */
enum { LY_OP0 = 0, LY_Y0, LY_X0, LY_VF0, LY_HF0, LY_FS0, LY_R0,
       LY_OP1, LY_Y1, LY_X1, LY_VF1, LY_HF1, LY_FS1, LY_R1 };
enum { CH_OP0 = 0, CH_Y0, CH_X0, CH_VF0, CH_HF0,
       CH_OP1, CH_Y1, CH_X1, CH_VF1, CH_HF1 };
enum { OP_NONE = 0, OP_COPY = 1, OP_SIXTAP = 2, OP_LOWPASS = 3 };

typedef struct {
    /* geometry / sequence */
    int32_t width, height, sb_size;
    int32_t pb_split, tb_split_enable, max_delta_qp, use_block_contexts;
    int32_t bipred, seq_interp_ref, num_reorder_pics;
    int32_t sub, mono;
    /* frame */
    int32_t frame_type, stat_frame_type, num_ref, interp_ref;
    int32_t num_intra_modes, qp, qpb;
    int32_t phase, rec_frame_num;
    int32_t ref_frame_num[8];
    int32_t ref_slot[8];
    /* deblock-data grid [rows*bs] */
    int32_t bs, rows;
    int32_t *dd_mode, *dd_size, *dd_tb_split, *dd_pb_part;
    int32_t *dd_cbp_y, *dd_cbp_u, *dd_cbp_v;
    int32_t *dd_mv0, *dd_mv1;           /* [n][2] (y,x) */
    int32_t *dd_ref0, *dd_ref1, *dd_bipred;
    const int32_t *dd_arr_mv0;          /* [n][16][2] */
    /* leaf records */
    int32_t *blk; long blk_cap; long n_blk;
    /* TB records + compact coeffs (descanned, qsize*qsize each) */
    int32_t *tb; long tb_cap; long n_tb;
    int16_t *coef; long coef_cap; long coef_len;
    /* dense MC plan + dense coeff planes (enable_plan) */
    int32_t enable_plan;
    int32_t gh, gw;                     /* 4x4-cell grid dims */
    int32_t *ly[14];
    int32_t *ch[10];
    int32_t *avg, *inter;
    int16_t *dcoef_y, *dcoef_u, *dcoef_v;
    long dcy_stride, dcc_stride;
    int32_t *qp4_y, *ls4_y, *qp4_c, *ls4_c;
    long q4y_stride, q4c_stride;
    /* zigzag tables (position -> zigzag index), sizes 4/8/16 */
    const int32_t *zz4, *zz8, *zz16;
    /* stats */
    int64_t *stats;
    /* stream (bitpos in/out) */
    const uint8_t *data; long nbytes; long bitpos;
    /* error flag: 1 = capacity overflow (caller falls back to Python) */
    int32_t error;
} parse_ctx_t;

typedef struct { int32_t mv0y, mv0x, mv1y, mv1x, ref0, ref1, dir; } cand_t;

/* shared derivation helpers (blockparse.c) */
int rec_qpc(int qpY, int sub);
void get_mv_pred(const parse_ctx_t *c, int ypos, int xpos, int size,
                 int *mvy, int *mvx);
int gather_skip_merge(const parse_ctx_t *c, int ypos, int xpos,
                      int size, cand_t out[2]);
int skip_temp(const parse_ctx_t *c, int ypos, int xpos, int size,
              cand_t *cands, int n);
void block_contexts(const parse_ctx_t *c, int ypos, int xpos,
                    int size, int *cbp_ctx, int *ctx_index);
void copy_deblock_data(parse_ctx_t *c, const int32_t *rec);
void plan_block(parse_ctx_t *c, const int32_t *rec);

#endif /* THOR_NATIVE_H */
