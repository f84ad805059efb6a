/* Frame commit engine: the serial, context-exact encode pass.
 *
 * The device search (ops/jax_backend.py) evaluates the mode/partition
 * search densely over all superblocks of a frame; this engine performs the
 * normative commit walk the wavefront dependency forces to be sequential:
 * intra prediction from reconstructed neighbors, transform/quantize,
 * reconstruction, and tile entropy coding with adaptive CDFs.
 *
 * Reference counterparts (behavioral, no code shared):
 *   - encode pass        Source/Lib/Codec/coding_loop.c
 *   - entropy coding     Source/Lib/Codec/entropy_coding.c (write_modes_b)
 *   - intra prediction   Source/Lib/Codec/intra_prediction.c
 * The walk trusts the device's partition decisions (the PD_PASS_0 analog)
 * and RD-trials the device's top-K mode candidates (the md_stage_3
 * analog); inter_backend.c builds the P-frame walk on the same helpers.
 */
#include <math.h>
#include <stdatomic.h>
#include <stdlib.h>
#include <stdio.h>
#include <string.h>
#include <time.h>

#include "commit_internal.h"

/* ---- native phase profiler (SVT_NATIVE_PROF=1) --------------------------
 * Wall-clock accumulators per phase, summed across tile threads — the
 * SRM-occupancy pipeline-monitor analog for the C walk (SURVEY §5).
 * Buckets: 0 fwd txfm, 1 quantize, 2 coeff rate, 3 inv txfm,
 *          4 intra predict, 5 txb write (EC), 6 trial-total, 7 spare. */
static int g_prof_on = -1;
static _Atomic long long g_prof_ns[12];

static inline int prof_enabled(void) {
    if (g_prof_on < 0) {
        const char *e = getenv("SVT_NATIVE_PROF");
        g_prof_on = (e && *e && *e != '0') ? 1 : 0;
    }
    return g_prof_on;
}

static inline long long prof_now(void) {
    struct timespec t;
    clock_gettime(CLOCK_MONOTONIC, &t);
    return t.tv_sec * 1000000000LL + t.tv_nsec;
}

#define PROF_BEGIN long long _pt = prof_enabled() ? prof_now() : 0
#define PROF_MARK(k)                                                   \
    do {                                                               \
        if (_pt) {                                                     \
            long long _n = prof_now();                                 \
            atomic_fetch_add(&g_prof_ns[k], _n - _pt);                 \
            _pt = _n;                                                  \
        }                                                              \
    } while (0)

static _Atomic long long g_trial_ct[19];

void tpuc_prof_reset(void) {
    for (int i = 0; i < 12; i++) g_prof_ns[i] = 0;
    for (int i = 0; i < 19; i++) g_trial_ct[i] = 0;
}

void tpuc_prof_counts(long long *out19) {
    for (int i = 0; i < 19; i++) out19[i] = g_trial_ct[i];
}

/* cross-TU accumulation hook for inter_backend.c's phase spans */
int tpuc_prof_enabled(void) { return prof_enabled(); }
long long tpuc_prof_now(void) { return prof_now(); }
void tpuc_prof_add(int k, long long ns) {
    atomic_fetch_add(&g_prof_ns[k % 12], ns);
}

void tpuc_prof_get(long long *out) {
    for (int i = 0; i < 12; i++) out[i] = g_prof_ns[i];
}

/* ---- geometry tables (AV1 spec constants) ------------------------------ */
static const int TXW[19] = {4, 8, 16, 32, 64, 4, 8, 8, 16, 16,
                            32, 32, 64, 4, 16, 8, 32, 16, 64};
static const int TXH[19] = {4, 8, 16, 32, 64, 8, 4, 16, 8, 32,
                            16, 64, 32, 16, 4, 32, 8, 64, 16};
static const int TX_SQR[19] = {0, 1, 2, 3, 4, 0, 0, 1, 1, 2,
                               2, 3, 3, 0, 0, 1, 1, 2, 2};
static const int TX_SQR_UP[19] = {0, 1, 2, 3, 4, 1, 1, 2, 2, 3,
                                  3, 4, 4, 2, 2, 3, 3, 4, 4};
/* compact (coded) tx size: 64-side sizes keep 32 coefficients */
static const int TX_ADJ[19] = {0, 1, 2, 3, 3, 5, 6, 7, 8, 9,
                               10, 3, 3, 13, 14, 15, 16, 9, 10};

int tpu_sq_bsize(int s) {
    return s == 8 ? 3 : s == 16 ? 6 : s == 32 ? 9 : 12;
}
int tpu_sq_tx(int s) {
    return s == 8 ? 1 : s == 16 ? 2 : s == 32 ? 3 : 4;
}
int tpu_uv_tx(int s) {
    return s == 8 ? 0 : s == 16 ? 1 : s == 32 ? 2 : 3;
}
/* partition-context byte per subblock pixel dim (definitions.h
 * partition_context_lookup) */
static int part_ctx_byte(int dim) {
    switch (dim) {
        case 4: return 31;
        case 8: return 30;
        case 16: return 28;
        case 32: return 24;
        case 64: return 16;
        default: return 0;
    }
}
/* intra_mode_context: mode -> kf_y context bucket */
static const int IMODE_CTX[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
/* size_group_lookup (y_mode cdf row on inter frames) */
static const int SIZE_GROUP[22] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3,
                                   3, 3, 3, 3, 3, 0, 0, 1, 1, 2, 2};
/* mode -> base angle (V..D67) */
static const int MODE_ANGLE[13] = {0, 90, 180, 45, 135, 113, 157, 203, 67,
                                   0, 0, 0, 0};
/* intra mode -> derived tx type (libaom intra_mode_to_tx_type):
 * DCT=0 ADST_DCT=1 DCT_ADST=2 ADST_ADST=3 */
static const int MODE2TXFM[14] = {0, 1, 2, 0, 3, 1, 2, 2, 1, 3, 1, 2, 3, 0};
/* txb skip contexts [min][max] */
static const int SKIP_CTXS[5][5] = {{1, 2, 2, 2, 3},
                                    {1, 4, 4, 4, 5},
                                    {1, 4, 4, 4, 5},
                                    {1, 4, 4, 4, 5},
                                    {1, 4, 4, 4, 6}};
/* smooth-predictor weights (spec 7.11.2.6) */
static const int SMW4[4] = {255, 149, 85, 64};
static const int SMW8[8] = {255, 197, 146, 105, 73, 50, 37, 32};
static const int SMW16[16] = {255, 225, 196, 170, 145, 123, 102, 84,
                              68, 54, 43, 33, 26, 20, 17, 16};
static const int SMW32[32] = {255, 240, 225, 210, 196, 182, 169, 157,
                              145, 133, 122, 111, 101, 92, 83, 74,
                              66, 59, 52, 45, 39, 34, 29, 25,
                              21, 17, 14, 12, 10, 9, 8, 8};
static const int SMW64[64] = {255, 248, 240, 233, 225, 218, 210, 203,
                              196, 189, 182, 176, 169, 163, 156, 150,
                              144, 138, 133, 127, 121, 116, 111, 106,
                              101, 96, 91, 86, 82, 77, 73, 69,
                              65, 61, 57, 54, 50, 47, 44, 41,
                              38, 35, 32, 29, 27, 25, 22, 20,
                              18, 16, 15, 13, 12, 10, 9, 8,
                              7, 6, 6, 5, 5, 4, 4, 4};
static const int *smw(int n) {
    switch (n) {
        case 4: return SMW4;
        case 8: return SMW8;
        case 16: return SMW16;
        case 32: return SMW32;
        default: return SMW64;
    }
}
static const int EDGE_KERNEL[3][5] = {{0, 4, 8, 4, 0},
                                      {0, 5, 6, 5, 0},
                                      {2, 4, 4, 4, 2}};
/* intra ext-tx sets: candidates and symbol mapping */
static int intra_tx_set_of(int ts) {
    if (TX_SQR_UP[ts] >= 3) return 0;
    return TX_SQR[ts] == 2 ? 2 : 1;
}
static const int SET1_FWD[16] = {1, 5, 6, 4, -1, -1, -1, -1, -1,
                                 0, 2, 3, -1, -1, -1, -1};
static const int SET2_FWD[16] = {1, 3, 4, 2, -1, -1, -1, -1, -1,
                                 0, -1, -1, -1, -1, -1, -1};
static const int SET_SIZES[3] = {1, 7, 5};
static int txtype_sym(int set, int tt) {
    return set == 1 ? SET1_FWD[tt] : SET2_FWD[tt];
}
#define N_MODE_CANDS 3
/* candidate luma tx types per set (mirrors IntraEncoder._luma_tx_types) */
static const int SET0_CANDS[1] = {0};
static const int SET1_CANDS[5] = {0, 3, 9, 10, 11};
static const int SET2_CANDS[3] = {0, 3, 9};

/* inter ext-tx set types (tx_sets.py inter_tx_set_type):
 * type 0 DCTONLY, 1 DCT_IDTX(2), 4 DTT9_IDTX_1DDCT(12), 5 ALL16(16) */
static int inter_tx_set_type_of(int ts) {
    int up = TX_SQR_UP[ts];
    if (up > 3) return 0;
    if (up == 3) return 1;
    return TX_SQR[ts] == 2 ? 4 : 5;
}
static const int INTER_SET_SIZES[6] = {1, 2, 5, 7, 12, 16};
static const int INTER_SET_TO_IDX[6] = {0, 3, -1, -1, 2, 1};
static const int INTER_FWD_T1[16] = {1, 0, 0, 0, 0, 0, 0, 0,
                                     0, 0, 0, 0, 0, 0, 0, 0};
static const int INTER_FWD_T4[16] = {3, 4, 5, 8, 6, 7, 9, 10,
                                     11, 0, 1, 2, 0, 0, 0, 0};
static const int INTER_FWD_T5[16] = {7, 8, 9, 12, 10, 11, 13, 14,
                                     15, 0, 1, 2, 3, 4, 5, 6};

static int eob_multi_size_of(int ts) {
    int w = TXW[ts] < 32 ? TXW[ts] : 32;
    int h = TXH[ts] < 32 ? TXH[ts] : 32;
    int n = w * h, b = 0;
    while ((1 << (b + 1)) <= n) b++;
    return b - 4 < 0 ? 0 : b - 4;
}
static int txs_entropy_ctx_of(int ts) {
    return (TX_SQR[ts] + TX_SQR_UP[ts] + 1) >> 1;
}
static int tx_class_of(int tt) {
    if (tt < 10) return 0;
    return (tt & 1) ? 1 : 2;
}

/* ---- uploads ----------------------------------------------------------- */
static int16_t *g_scan[19][16];
static int16_t *g_iscan[19][16];    /* raster pos -> scan index + 1;
                                       0 = pos not in the scan */
static int g_scan_n[19][16];
static int32_t g_dr[90];

void tpuc_upload_scan(int tx_size, int tx_type, const int16_t *scan, int n) {
    int16_t *p = (int16_t *)malloc(sizeof(int16_t) * n);
    memcpy(p, scan, sizeof(int16_t) * n);
    free(g_scan[tx_size][tx_type]);
    g_scan[tx_size][tx_type] = p;
    g_scan_n[tx_size][tx_type] = n;
    /* inverse scan: lets the trial find eob in ONE linear pass over the
     * quantized buffer (gathering only at nonzero positions) instead of
     * an O(n) gather walk through the scan table */
    int adj = TX_ADJ[tx_size];
    int npos = TXW[adj] * TXH[adj];
    int16_t *iv = (int16_t *)calloc(npos, sizeof(int16_t));
    for (int i = 0; i < n; i++)
        if (scan[i] < npos) iv[scan[i]] = (int16_t)(i + 1);
    free(g_iscan[tx_size][tx_type]);
    g_iscan[tx_size][tx_type] = iv;
}
void tpuc_upload_dr(const int32_t *dr) { memcpy(g_dr, dr, sizeof(g_dr)); }
int16_t *tpu_scan(int ts, int tt, int *n) {
    *n = g_scan_n[ts][tt];
    return g_scan[ts][tt];
}

static int dr_dx(int a) { return a < 90 ? g_dr[a] : g_dr[180 - a]; }
static int dr_dy(int a) { return a < 180 ? g_dr[a - 90] : g_dr[270 - a]; }

/* ---- lifecycle --------------------------------------------------------- */
TpuCommit *tpuc_new(int width, int height, int bd) {
    TpuCommit *c = (TpuCommit *)calloc(1, sizeof(TpuCommit));
    c->width = width;
    c->height = height;
    c->bd = bd;
    c->mi_cols = 2 * ((width + 7) >> 3);
    c->mi_rows = 2 * ((height + 7) >> 3);
    int aw = c->mi_cols * 4, ah = c->mi_rows * 4;
    int paw = (aw + 63) & ~63, pah = (ah + 63) & ~63;
    c->ystride = paw + 64;
    c->cstride = paw / 2 + 64;
    c->plane[0] = (uint16_t *)calloc((pah + 64) * c->ystride, 2);
    c->plane[1] = (uint16_t *)calloc((pah / 2 + 64) * c->cstride, 2);
    c->plane[2] = (uint16_t *)calloc((pah / 2 + 64) * c->cstride, 2);
    c->planes_owned = 1;
    c->t_mi_row0 = 0;
    c->t_mi_row1 = c->mi_rows;
    c->t_mi_col0 = 0;
    c->t_mi_col1 = c->mi_cols;
    c->above_part = (uint8_t *)calloc(c->mi_cols, 1);
    c->left_part = (uint8_t *)calloc(c->mi_rows, 1);
    c->above_mode = (uint8_t *)calloc(c->mi_cols, 1);
    c->left_mode = (uint8_t *)calloc(c->mi_rows, 1);
    c->above_skip = (uint8_t *)calloc(c->mi_cols, 1);
    c->left_skip = (uint8_t *)calloc(c->mi_rows, 1);
    c->above_skip_mode = (uint8_t *)calloc(c->mi_cols, 1);
    c->left_skip_mode = (uint8_t *)calloc(c->mi_rows, 1);
    for (int p = 0; p < 3; p++) {
        int n = p ? (c->mi_cols + 1) >> 1 : c->mi_cols;
        int m = p ? (c->mi_rows + 1) >> 1 : c->mi_rows;
        c->above_coef[p] = (uint8_t *)calloc(n, 1);
        c->left_coef[p] = (uint8_t *)calloc(m, 1);
    }
    for (int p = 0; p < 2; p++) {
        c->above_smooth[p] = (uint8_t *)calloc(c->mi_cols, 1);
        c->left_smooth[p] = (uint8_t *)calloc(c->mi_rows, 1);
    }
    /* TX-size context rows (spec AboveTxWidth/LeftTxHeight, init 64) */
    c->above_txw = (uint8_t *)malloc(c->mi_cols);
    c->left_txh = (uint8_t *)malloc(c->mi_rows);
    memset(c->above_txw, 64, c->mi_cols);
    memset(c->left_txh, 64, c->mi_rows);
    c->sb_r4 = c->sb_c4 = -1;
    return c;
}

/* TX_MODE_SELECT for the intra walk: per-block depth-1 TX split search
 * + tx_size signalling (spec 5.11.15 read_tx_size). */
/* allow_high_precision_mv for the inter walk: MV writer hp bits, MVP
 * precision lowering and the eighth-pel subpel search all key off it
 * (spec 5.9.10; the field doubles as the MVP builder's allow_hp) */
void tpuc_set_allow_hp(TpuCommit *c, int enable) {
    c->tpl_allow_hp = enable;
}

void tpuc_set_tx_select(TpuCommit *c, int enable) {
    c->tx_select = enable;
}

void tpuc_attach_planes(TpuCommit *c, uint16_t *y, uint16_t *u, uint16_t *v,
                        int ystride, int cstride) {
    if (c->planes_owned)
        for (int p = 0; p < 3; p++) free(c->plane[p]);
    c->planes_owned = 0;
    c->plane[0] = y;
    c->plane[1] = u;
    c->plane[2] = v;
    c->ystride = ystride;
    c->cstride = cstride;
}

void tpuc_attach_lfmaps(TpuCommit *c, uint8_t *txdim_y, uint8_t *txdim_uv,
                        int ystride, int cstride) {
    c->lf_txdim[0] = txdim_y;
    c->lf_txdim[1] = txdim_uv;
    c->lf_stride[0] = ystride;
    c->lf_stride[1] = cstride;
}

void tpuc_attach_skipmap(TpuCommit *c, uint8_t *skip, int stride) {
    c->skip_map = skip;
    c->skip_stride = stride;
}

void tpuc_set_ref(TpuCommit *c, const uint16_t *y, const uint16_t *u,
                  const uint16_t *v, int ystride, int cstride) {
    c->refp[0] = y;
    c->refp[1] = u;
    c->refp[2] = v;
    c->ref_stride[0] = ystride;
    c->ref_stride[1] = c->ref_stride[2] = cstride;
}

void tpuc_free(TpuCommit *c) {
    if (!c) return;
    for (int p = 0; p < 3; p++) {
        if (c->planes_owned) free(c->plane[p]);
        free(c->above_coef[p]);
        free(c->left_coef[p]);
    }
    free(c->above_part);
    free(c->left_part);
    free(c->above_mode);
    free(c->left_mode);
    free(c->above_skip);
    free(c->left_skip);
    free(c->above_skip_mode);
    free(c->left_skip_mode);
    for (int p = 0; p < 2; p++) {
        free(c->above_smooth[p]);
        free(c->left_smooth[p]);
    }
    free(c->above_txw);
    free(c->left_txh);
    if (c->grid) tpui_grid_free(c->grid);
    free(c);
}

void tpuc_set_src(TpuCommit *c, const uint16_t *y, const uint16_t *u,
                  const uint16_t *v, int ystride, int cstride) {
    c->src[0] = y;
    c->src[1] = u;
    c->src[2] = v;
    c->sstride[0] = ystride;
    c->sstride[1] = c->sstride[2] = cstride;
}

void tpuc_set_qtab(TpuCommit *c, const int32_t *qtab) {
    memcpy(c->qtab, qtab, sizeof(c->qtab));
}

void tpuc_set_psy_rd(TpuCommit *c, double strength) {
    c->psy_rd = strength;
}

void tpuc_set_rdmult_scale(TpuCommit *c, double scale) {
    c->rdmult_scale = scale;
}

/* SB lambda from its qindex: the base 0.12*qstep^2 point scaled by the
 * frame-kind factor (tpuc_set_rdmult_scale) and, when the SB's q differs
 * from the frame base q (delta-q AQ), by the reference's qdiff
 * modulation (ref rc_process.c:1089-1108 stats_based_sb_lambda
 * modulation: boosted-SB lambda follows the SB's operating point). */
double tpu_lambda_for_q(const TpuCommit *c, const int32_t *pq, int q,
                        int frame_base_q) {
    double qstep = pq[8] / 8.0;
    double l = 0.12 * qstep * qstep;
    if (c->rdmult_scale > 0.0) l *= c->rdmult_scale;
    int qdiff = q - frame_base_q;
    if (qdiff < 0)
        l = l * (qdiff <= -8 ? 90 : 115) / 128.0;
    else if (qdiff > 0)
        l = l * (qdiff <= 8 ? 135 : 150) / 128.0;
    return l;
}

uint16_t *tpuc_plane(TpuCommit *c, int plane, int *stride) {
    *stride = plane ? c->cstride : c->ystride;
    return c->plane[plane];
}

/* ---- block-decoded maps (spec 5.11.31) --------------------------------- */
void tpu_bd_reset_sb(TpuCommit *c, int sbr4, int sbc4) {
    c->sb_r4 = sbr4;
    c->sb_c4 = sbc4;
    for (int plane = 0; plane < 3; plane++) {
        int sub = plane ? 1 : 0;
        int n = 16 >> sub;
        uint8_t *m = c->bdmap[plane];
        memset(m, 0, 18 * 18);
        int sb_w4 = (c->t_mi_col1 - sbc4) >> sub;  /* avail to tile end */
        int sb_h4 = (c->t_mi_row1 - sbr4) >> sub;
        for (int x = -1; x <= n; x++)
            m[0 * 18 + (x + 1)] = x < sb_w4;
        for (int y = 0; y <= n; y++)
            m[(y + 1) * 18 + 0] = y < sb_h4;
        m[(n + 1) * 18 + 0] = 0;
    }
}
static int bd_get(TpuCommit *c, int plane, int y4, int x4) {
    int sub = plane ? 1 : 0;
    int ry = y4 - (c->sb_r4 >> sub);
    int rx = x4 - (c->sb_c4 >> sub);
    int n = 16 >> sub;
    if (ry < -1 || rx < -1 || ry > n || rx > n) return 0;
    return c->bdmap[plane][(ry + 1) * 18 + rx + 1];
}
void tpu_bd_set(TpuCommit *c, int plane, int y4, int x4, int h4, int w4) {
    int sub = plane ? 1 : 0;
    int ry = y4 - (c->sb_r4 >> sub);
    int rx = x4 - (c->sb_c4 >> sub);
    for (int i = 0; i < h4; i++)
        memset(&c->bdmap[plane][(ry + 1 + i) * 18 + rx + 1], 1, w4);
}

/* ---- filter intra (spec 7.11.6; twin of ops/intra.filter_intra_pred) -- */
/* 5 modes x 8 outputs x 8 taps (7 used), uploaded from
 * constants/av1_tables.npz filter_intra_taps */
static int32_t FI_TAPS[5][8][8];

void tpuc_upload_fi(const int32_t *taps) {
    memcpy(FI_TAPS, taps, sizeof(FI_TAPS));
}

static void fi_predict(int bd, int fm, const int32_t *above,
                       const int32_t *left, int32_t al, int w, int h,
                       int32_t *pred) {
    static __thread int32_t buf[33 * 33];
    int bw = w + 1;
    int hi = (1 << bd) - 1;
    buf[0] = al;
    for (int j = 0; j < w; j++) buf[1 + j] = above[j];
    for (int i = 0; i < h; i++) buf[(i + 1) * bw] = left[i];
    for (int r2 = 1; r2 <= h; r2 += 2)
        for (int c2 = 1; c2 <= w; c2 += 4) {
            int32_t p[7];
            p[0] = buf[(r2 - 1) * bw + c2 - 1];
            p[1] = buf[(r2 - 1) * bw + c2];
            p[2] = buf[(r2 - 1) * bw + (c2 + 1 <= w ? c2 + 1 : w)];
            p[3] = buf[(r2 - 1) * bw + (c2 + 2 <= w ? c2 + 2 : w)];
            p[4] = buf[(r2 - 1) * bw + (c2 + 3 <= w ? c2 + 3 : w)];
            p[5] = buf[r2 * bw + c2 - 1];
            p[6] = buf[(r2 + 1 <= h ? r2 + 1 : h) * bw + c2 - 1];
            for (int k = 0; k < 8; k++) {
                int ro = k >> 2, co = k & 3;
                long sum = 0;
                for (int t = 0; t < 7; t++)
                    sum += (long)FI_TAPS[fm][k][t] * p[t];
                int val = sum >= 0 ? (int)((sum + 8) >> 4)
                                   : -(int)((-sum + 8) >> 4);
                if (val < 0) val = 0;
                if (val > hi) val = hi;
                buf[(r2 + ro) * bw + c2 + co] = val;
            }
        }
    for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++)
            pred[i * w + j] = buf[(i + 1) * bw + 1 + j];
}

/* ---- intra prediction (spec 7.11.2) ------------------------------------ */
static void edge_filter_buf(int32_t *buf, int sz, int strength) {
    if (strength == 0 || sz <= 1) return;
    const int *k = EDGE_KERNEL[strength - 1];
    int32_t tmp[64 + 64 + 20];
    tmp[0] = tmp[1] = buf[0];
    memcpy(tmp + 2, buf, sizeof(int32_t) * sz);
    tmp[sz + 2] = tmp[sz + 3] = buf[sz - 1];
    for (int i = 1; i < sz; i++) {
        long acc = 0;
        for (int j = 0; j < 5; j++) acc += (long)tmp[i + j] * k[j];
        buf[i] = (int32_t)((acc + 8) >> 4);
    }
}

static int edge_filter_strength(int w, int h, int ftype, int delta) {
    int d = delta < 0 ? -delta : delta;
    int wh = w + h, s = 0;
    if (ftype == 0) {
        if (wh <= 8) {
            if (d >= 56) s = 1;
        } else if (wh <= 12) {
            if (d >= 40) s = 1;
        } else if (wh <= 16) {
            if (d >= 40) s = 1;
        } else if (wh <= 24) {
            if (d >= 8) s = 1;
            if (d >= 16) s = 2;
            if (d >= 32) s = 3;
        } else if (wh <= 32) {
            s = 1;
            if (d >= 4) s = 2;
            if (d >= 32) s = 3;
        } else {
            s = 3;
        }
    } else {
        if (wh <= 8) {
            if (d >= 40) s = 1;
            if (d >= 64) s = 2;
        } else if (wh <= 16) {
            if (d >= 20) s = 1;
            if (d >= 48) s = 2;
        } else if (wh <= 24) {
            if (d >= 4) s = 3;
        } else {
            s = 3;
        }
    }
    return s;
}

static int use_edge_upsample(int w, int h, int ftype, int delta) {
    int d = delta < 0 ? -delta : delta;
    int wh = w + h;
    if (d <= 0 || d >= 40) return 0;
    return ftype ? wh <= 8 : wh <= 16;
}

static void edge_upsample(int32_t *buf, int num_px, int bd) {
    int32_t dup[64 + 64 + 8];
    int hi = (1 << bd) - 1;
    dup[0] = buf[1];
    for (int i = 0; i <= num_px; i++) dup[1 + i] = buf[1 + i];
    dup[num_px + 2] = buf[num_px + 1];
    buf[0] = dup[0];
    for (int i = 0; i < num_px; i++) {
        int32_t s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
        s = (s + 8) >> 4;
        if (s < 0) s = 0;
        if (s > hi) s = hi;
        buf[1 + 2 * i] = s;
        buf[2 + 2 * i] = dup[i + 2];
    }
}

static void predict_block(TpuCommit *c, int plane, int mode, int ad,
                          const int32_t *above, const int32_t *left,
                          int32_t al, int w, int h, int have_above,
                          int have_left, int n_top_px, int n_left_px,
                          int ftype, int32_t *pred) {
    if (mode >= 100) {    /* filter intra: mode = 100 + fi_mode */
        fi_predict(c->bd, mode - 100, above, left, al, w, h, pred);
        return;
    }
    int bd = c->bd;
    int base = 1 << (bd - 1);
    int hi = (1 << bd) - 1;
    if (mode == 0) { /* DC */
        int dc;
        if (have_above && have_left) {
            long s = 0;
            for (int i = 0; i < w; i++) s += above[i];
            for (int i = 0; i < h; i++) s += left[i];
            dc = (int)((s + ((w + h) >> 1)) / (w + h));
        } else if (have_above) {
            long s = 0;
            for (int i = 0; i < w; i++) s += above[i];
            int lw = 0;
            while ((1 << (lw + 1)) <= w) lw++;
            dc = (int)((s + (w >> 1)) >> lw);
        } else if (have_left) {
            long s = 0;
            for (int i = 0; i < h; i++) s += left[i];
            int lh = 0;
            while ((1 << (lh + 1)) <= h) lh++;
            dc = (int)((s + (h >> 1)) >> lh);
        } else {
            dc = base;
        }
        for (int i = 0; i < h * w; i++) pred[i] = dc;
        return;
    }
    if (mode >= 9 && mode <= 11) { /* SMOOTH family */
        const int *wx = smw(w), *wy = smw(h);
        int below = left[h - 1], right = above[w - 1];
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) {
                int32_t v;
                if (mode == 9)
                    v = (wy[i] * above[j] + (256 - wy[i]) * below +
                         wx[j] * left[i] + (256 - wx[j]) * right + 256) >> 9;
                else if (mode == 10)
                    v = (wy[i] * above[j] + (256 - wy[i]) * below + 128) >> 8;
                else
                    v = (wx[j] * left[i] + (256 - wx[j]) * right + 128) >> 8;
                pred[i * w + j] = v;
            }
        return;
    }
    if (mode == 12) { /* PAETH */
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) {
                int a = above[j], l = left[i];
                int pb = a + l - al;
                int pa = abs(pb - a), pl = abs(pb - l), pal = abs(pb - al);
                pred[i * w + j] = (pa <= pl && pa <= pal) ? a
                                  : (pl <= pal ? l : al);
            }
        return;
    }
    int p_angle = MODE_ANGLE[mode] + ad * 3;
    if (p_angle == 90) {
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) pred[i * w + j] = above[j];
        return;
    }
    if (p_angle == 180) {
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) pred[i * w + j] = left[i];
        return;
    }
    int32_t ab[2 + 64 + 64 + 16 + 128], le[2 + 64 + 64 + 16 + 128];
    memset(ab, 0, sizeof(ab));
    memset(le, 0, sizeof(le));
    ab[1] = al;
    le[1] = al;
    for (int i = 0; i < w + h; i++) {
        ab[2 + i] = above[i];
        le[2 + i] = left[i];
    }
    int ua = 0, ul = 0;
    {
        if (p_angle > 90 && p_angle < 180 && (w + h) >= 24) {
            int v = (5 * le[2] + 6 * ab[1] + 5 * ab[2] + 8) >> 4;
            ab[1] = v;
            le[1] = v;
        }
        if (have_above) {
            int s = edge_filter_strength(w, h, ftype, p_angle - 90);
            int npx = (w < n_top_px ? w : n_top_px) +
                      (p_angle < 90 ? h : 0) + 1;
            edge_filter_buf(ab + 1, npx, s);
        }
        if (have_left) {
            int s = edge_filter_strength(w, h, ftype, p_angle - 180);
            int npx = (h < n_left_px ? h : n_left_px) +
                      (p_angle > 180 ? w : 0) + 1;
            edge_filter_buf(le + 1, npx, s);
        }
        ua = use_edge_upsample(w, h, ftype, p_angle - 90);
        if (ua) {
            int npx = w + (p_angle < 90 ? h : 0);
            edge_upsample(ab, npx, bd);
        }
        ul = use_edge_upsample(w, h, ftype, p_angle - 180);
        if (ul) {
            int npx = h + (p_angle > 180 ? w : 0);
            edge_upsample(le, npx, bd);
        }
    }
    if (p_angle < 90) {
        int dx = dr_dx(p_angle);
        int max_base = (w + h - 1) << ua;
        for (int i = 0; i < h; i++) {
            int idx = (i + 1) * dx;
            int b0 = (idx >> (6 - ua));
            int shift = ((idx << ua) >> 1) & 0x1F;
            for (int j = 0; j < w; j++) {
                int b = b0 + (j << ua);
                int32_t v;
                if (b < max_base)
                    v = (ab[2 + b] * (32 - shift) + ab[2 + b + 1] * shift +
                         16) >> 5;
                else
                    v = ab[2 + max_base];
                if (v < 0) v = 0;
                if (v > hi) v = hi;
                pred[i * w + j] = v;
            }
        }
        return;
    }
    if (p_angle < 180) {
        int dx = dr_dx(p_angle), dy = dr_dy(p_angle);
        for (int i = 0; i < h; i++)
            for (int j = 0; j < w; j++) {
                int idx = (j << 6) - (i + 1) * dx;
                int a_base = idx >> (6 - ua);
                int a_shift = ((idx << ua) >> 1) & 0x1F;
                int use_above = a_base >= -(1 << ua);
                int32_t v;
                if (use_above) {
                    int ba = a_base < -(1 << ua) ? -(1 << ua) : a_base;
                    v = (ab[2 + ba] * (32 - a_shift) +
                         ab[2 + ba + 1] * a_shift + 16) >> 5;
                } else {
                    int idx2 = (i << 6) - (j + 1) * dy;
                    int l_base = idx2 >> (6 - ul);
                    int l_shift = ((idx2 << ul) >> 1) & 0x1F;
                    if (l_base < -2) l_base = -2;
                    v = (le[2 + l_base] * (32 - l_shift) +
                         le[2 + l_base + 1] * l_shift + 16) >> 5;
                }
                if (v < 0) v = 0;
                if (v > hi) v = hi;
                pred[i * w + j] = v;
            }
        return;
    }
    {
        int dy = dr_dy(p_angle);
        int max_base = (w + h - 1) << ul;
        for (int j = 0; j < w; j++) {
            int idx = (j + 1) * dy;
            int b0 = idx >> (6 - ul);
            int shift = ((idx << ul) >> 1) & 0x1F;
            for (int i = 0; i < h; i++) {
                int b = b0 + (i << ul);
                int32_t v;
                if (b < max_base)
                    v = (le[2 + b] * (32 - shift) + le[2 + b + 1] * shift +
                         16) >> 5;
                else
                    v = le[2 + max_base];
                if (v < 0) v = 0;
                if (v > hi) v = hi;
                pred[i * w + j] = v;
            }
        }
    }
}

void tpu_predict_txb(TpuCommit *c, int plane, int mode, int ad, int mi_row,
                     int mi_col, int u_row, int u_col, int ts,
                     int32_t *pred) {
    PROF_BEGIN;
    int sub = plane ? 1 : 0;
    int w = TXW[ts], h = TXH[ts];
    int x = u_col * 4, y = u_row * 4;
    int stride = plane ? c->cstride : c->ystride;
    const uint16_t *rp = c->plane[plane];
    /* availability + edge extension clamp at TILE boundaries */
    int tile_x0 = (c->t_mi_col0 * 4) >> sub;
    int tile_y0 = (c->t_mi_row0 * 4) >> sub;
    int mx_lim = c->t_mi_col1 < c->mi_cols ? c->t_mi_col1 : c->mi_cols;
    int my_lim = c->t_mi_row1 < c->mi_rows ? c->t_mi_row1 : c->mi_rows;
    int max_x = ((mx_lim * 4) >> sub) - 1;
    int max_y = ((my_lim * 4) >> sub) - 1;
    int step_x = w / 4, step_y = h / 4;
    int base = 1 << (c->bd - 1);
    int have_left = x > tile_x0 && bd_get(c, plane, u_row, u_col - 1);
    int have_above = y > tile_y0 && bd_get(c, plane, u_row - 1, u_col);
    int have_ar = bd_get(c, plane, u_row - 1, u_col + step_x);
    int have_bl = bd_get(c, plane, u_row + step_y, u_col - 1);
    int32_t above[128 + 8], left[128 + 8];
    int32_t al;
    if (!have_above && have_left) {
        int32_t v = rp[y * stride + x - 1];
        for (int i = 0; i < w + h; i++) above[i] = v;
    } else if (!have_above) {
        for (int i = 0; i < w + h; i++) above[i] = base - 1;
    } else {
        int lim = x + (have_ar ? 2 * w : w) - 1;
        if (lim > max_x) lim = max_x;
        for (int i = 0; i < w + h; i++) {
            int xi = x + i;
            if (xi > lim) xi = lim;
            above[i] = rp[(y - 1) * stride + xi];
        }
    }
    if (!have_left && have_above) {
        int32_t v = rp[(y - 1) * stride + x];
        for (int i = 0; i < h + w; i++) left[i] = v;
    } else if (!have_left) {
        for (int i = 0; i < h + w; i++) left[i] = base + 1;
    } else {
        int lim = y + (have_bl ? 2 * h : h) - 1;
        if (lim > max_y) lim = max_y;
        for (int i = 0; i < h + w; i++) {
            int yi = y + i;
            if (yi > lim) yi = lim;
            left[i] = rp[yi * stride + x - 1];
        }
    }
    if (have_above && have_left)
        al = rp[(y - 1) * stride + x - 1];
    else if (have_above)
        al = rp[(y - 1) * stride + x];
    else if (have_left)
        al = rp[y * stride + x - 1];
    else
        al = base;

    int ftype = 0;
    if (mode >= 1 && mode <= 8) {
        int pidx = plane ? 1 : 0;
        int mc2 = mi_col < c->mi_cols - 1 ? mi_col : c->mi_cols - 1;
        int mr2 = mi_row < c->mi_rows - 1 ? mi_row : c->mi_rows - 1;
        int ab_sm = have_above ? c->above_smooth[pidx][mc2] : 0;
        int le_sm = have_left ? c->left_smooth[pidx][mr2] : 0;
        ftype = (ab_sm || le_sm) ? 1 : 0;
    }
    predict_block(c, plane, mode, ad, above, left, al, w, h, have_above,
                  have_left, max_x - x + 1, max_y - y + 1, ftype, pred);
    PROF_MARK(4);
}

/* ---- quant + trial ----------------------------------------------------- */
static const int32_t *pq_of(TpuCommit *c, int q, int plane) {
    return c->qtab + ((q * 3) + plane) * 10;
}

void tpuc_set_noise_norm(TpuCommit *c, int strength) {
    c->noise_norm = strength;
}

void tpuc_set_tune_ssim(TpuCommit *c, int on) {
    c->tune_ssim = on;
}

void tpuc_set_max_tx32(TpuCommit *c, int on) {
    c->max_tx32 = on;
}

void tpuc_set_cfl(TpuCommit *c, int on) {
    c->cfl_search = on;
}

void tpuc_set_filter_intra(TpuCommit *c, int on) {
    c->fi_search = on;
}

void tpuc_set_qm(TpuCommit *c,
                 const int32_t *wt_y, const int32_t *iwt_y,
                 const int32_t *wt_u, const int32_t *iwt_u,
                 const int32_t *wt_v, const int32_t *iwt_v) {
    c->qm_wt[0] = wt_y; c->qm_iwt[0] = iwt_y;
    c->qm_wt[1] = wt_u; c->qm_iwt[1] = iwt_u;
    c->qm_wt[2] = wt_v; c->qm_iwt[2] = iwt_v;
}

/* offset of a self-adjusted tx size in the flat QM table (libaom
 * av1_qm_init traversal: TX_SIZES_ALL order, skipping sizes that remap) */
static int qm_offset(int adj_ts) {
    int off = 0, t;
    for (t = 0; t < adj_ts; t++)
        if (TX_ADJ[t] == t) off += TXW[t] * TXH[t];
    return off;
}
static int tx_log_scale(int ts) {
    int w = TXW[ts], h = TXH[ts];
    if (w * h > 1024) return 2;
    if (w * h > 256) return 1;
    return 0;
}

void tpu_trial_txb(TpuCommit *c, int plane, int ts, int tt,
                   const int32_t *resid, int q, int ptype, int sctx_sign,
                   int is_inter, TxTrial *out) {
    int adj = TX_ADJ[ts];
    int cw = TXW[adj], ch = TXH[adj];
    int32_t coeff[32 * 32];
    int32_t rresid[64 * 64];
    (void)is_inter;
    PROF_BEGIN;
    if (prof_enabled()) atomic_fetch_add(&g_trial_ct[ts], 1);
    tputx_fwd2d(resid, coeff, ts, tt, c->bd);
    PROF_MARK(0);
    const int32_t *pq = pq_of(c, q, plane);
    /* QM applies only to 2-D transform types (tx_type < IDTX; libaom
     * IS_2D_TRANSFORM — mirrors decoder/reconstruct.py) */
    if (c->qm_wt[plane] && tt < 9) {
        int qoff = qm_offset(adj);
        tputx_quantize_b_qm(coeff, out->qc, out->dqc, cw * ch,
                            tx_log_scale(ts),
                            pq[0], pq[1], pq[2], pq[3], pq[4], pq[5],
                            pq[6], pq[7], pq[8], pq[9],
                            c->qm_wt[plane] + qoff,
                            c->qm_iwt[plane] + qoff);
    } else
        tputx_quantize_b(coeff, out->qc, out->dqc, cw * ch, tx_log_scale(ts),
                         pq[0], pq[1], pq[2], pq[3], pq[4], pq[5], pq[6],
                         pq[7], pq[8], pq[9]);
    PROF_MARK(1);
    int eob = 0;
    const int16_t *scan = g_scan[ts][tt];
    const int16_t *iscan = g_iscan[ts][tt];
    /* eob in one linear pass (vectorizable): gather the scan index only
     * at nonzero coefficients */
    for (int i = 0; i < cw * ch; i++)
        if (out->qc[i]) {
            int s = iscan[i];
            if (s > eob) eob = s;
        }
    out->eob = eob;
    out->tt = tt;
    out->q = q;
    if (eob == 0) {
        out->rate512 = 0;
        long sse = 0;
        int w = TXW[ts], h = TXH[ts];
        for (int i = 0; i < w * h; i++)
            sse += (long)resid[i] * resid[i];
        out->sse = sse;
        if (c->psy_rd > 0 && TXW[ts] <= 32 && TXH[ts] <= 32) {
            long ea = 0;
            for (int i = 1; i < cw * ch; i++)
                ea += coeff[i] < 0 ? -(long)coeff[i] : coeff[i];
            out->psy = ea >> (3 - tx_log_scale(ts));
        } else {
            out->psy = 0;
        }
        return;
    }
    out->rate512 = tpuec_cost_txb_eob(c->tc, out->qc, scan, eob, cw, ch,
                                      TXW[ts], TXH[ts],
                                      eob_multi_size_of(ts),
                                      txs_entropy_ctx_of(ts),
                                      tx_class_of(tt), ptype, sctx_sign);
    PROF_MARK(2);
    if (TXW[ts] <= 32 && TXH[ts] <= 32) {
        /* transform-domain distortion (ref av1_block_error): the integer
         * DCT gain is 2^(6 - 2*log_scale); avoids one inverse per trial
         * (inverse still runs exactly at commit) */
        long sse = 0;
        for (int i = 0; i < cw * ch; i++) {
            long d = (long)coeff[i] - out->dqc[i];
            sse += d * d;
        }
        out->sse = sse >> (6 - 2 * tx_log_scale(ts));
        if (c->psy_rd > 0) {
            /* PSY energy preservation (psy_rd.c analog): penalize losing
             * AC energy to quantization, computed in the transform
             * domain (amplitude gain 2^(3 - log_scale)) */
            long ea = 0, eb = 0;
            for (int i = 1; i < cw * ch; i++) {
                ea += coeff[i] < 0 ? -(long)coeff[i] : coeff[i];
                eb += out->dqc[i] < 0 ? -(long)out->dqc[i] : out->dqc[i];
            }
            long d = ea - eb;
            out->psy = (d < 0 ? -d : d) >> (3 - tx_log_scale(ts));
        } else {
            out->psy = 0;
        }
        return;
    }
    tputx_inv2d(out->dqc, rresid, ts, tt, c->bd);
    long sse = 0;
    int w = TXW[ts], h = TXH[ts];
    for (int i = 0; i < w * h; i++) {
        long d = (long)resid[i] - rresid[i];
        sse += d * d;
    }
    out->sse = sse;
    out->psy = 0;
}

/* ---- PSY noise normalization (ref full_loop.c:1464) --------------------
 * Encode-pass-only AC coefficient revival: boosts the quantized-down AC
 * coefficient whose dequantized step recovers the largest share of the
 * original energy (textured blocks), or revives one zeroed AC coeff near
 * DC on flat blocks. Luma, non-IDTX, blocks > 4x4 (is_encode_pass gate
 * at full_loop.c:1818). */
void tpu_noise_norm_txb(TpuCommit *c, int ts, const int32_t *resid, int q,
                        TxTrial *t) {
    if (!c->noise_norm || t->eob == 0 || t->tt == 9) return;
    int w = TXW[ts], h = TXH[ts];
    if (w == 4 && h == 4) return;
    int adj = TX_ADJ[ts];
    int cw = TXW[adj], ch = TXH[adj];
    int shift = tx_log_scale(ts);
    static __thread int32_t coeff[32 * 32];
    tputx_fwd2d(resid, coeff, ts, t->tt, c->bd);
    const int32_t *pq = pq_of(c, q, 0);
    const int32_t *iqm = (c->qm_iwt[0] && t->tt < 9)
        ? c->qm_iwt[0] + qm_offset(adj) : NULL;
    const int16_t *scan = g_scan[ts][t->tt];
    int n = g_scan_n[ts][t->tt];
    int thresh = c->noise_norm == 1 ? 9 : c->noise_norm == 2 ? 8
                 : c->noise_norm == 3 ? 6 : 4;
    int best_si = -1;
    long best_gap = 1L << 60;
    int32_t best_qc_low = 0, best_dqc_low = 0;
    if (t->eob > 1) {
        for (int si = 1; si < t->eob; si++) {
            int ci = scan[si];
            int32_t tqc = coeff[ci], qc = t->qc[ci], dqc = t->dqc[ci];
            int sign = tqc < 0;
            if (dqc == 0) continue;
            long atqc = tqc < 0 ? -(long)tqc : tqc;
            long adqc = dqc < 0 ? -(long)dqc : dqc;
            if (atqc - adqc <= 0) continue;
            long dqv = pq[9];                     /* AC dequant */
            if (iqm) dqv = (iqm[ci] * dqv + 16) >> 5;
            long abs_qc_low = (qc < 0 ? -(long)qc : qc) + 1;
            int32_t qc_low = (int32_t)(sign ? -abs_qc_low : abs_qc_low);
            long abs_dqc_low = (abs_qc_low * dqv) >> shift;
            int32_t dqc_low = (int32_t)(sign ? -abs_dqc_low : abs_dqc_low);
            long gap = dqc_low > tqc ? dqc_low - tqc : tqc - dqc_low;
            long step = dqc_low > dqc ? dqc_low - dqc : dqc - dqc_low;
            if (step == 0) continue;
            long ratio = ((step - gap) << 4) / step;
            if (ratio >= thresh) {
                best_si = si;
                best_qc_low = qc_low;
                best_dqc_low = dqc_low;
            }
        }
    } else {
        int lim = (cw * ch) / 16;
        if (lim > n) lim = n;
        for (int si = 1; si < lim; si++) {
            int ci = scan[si];
            int32_t tqc = coeff[ci], dqc = t->dqc[ci];
            int sign = tqc < 0;
            if (dqc != 0 || tqc == 0) continue;
            long dqv = pq[9];
            if (iqm) dqv = (iqm[ci] * dqv + 16) >> 5;
            long abs_dqc_low = dqv >> shift;
            int32_t qc_low = sign ? -1 : 1;
            int32_t dqc_low = (int32_t)(sign ? -abs_dqc_low : abs_dqc_low);
            long gap = dqc_low > tqc ? dqc_low - tqc : tqc - dqc_low;
            long step = dqc_low > dqc ? dqc_low - dqc : dqc - dqc_low;
            if (step == 0) continue;
            long ratio = ((step - gap) << 4) / step;
            if (ratio >= thresh && gap < best_gap) {
                best_gap = gap;
                best_si = si;
                best_qc_low = qc_low;
                best_dqc_low = dqc_low;
            }
        }
    }
    if (best_si > 0) {
        int ci = scan[best_si];
        t->qc[ci] = best_qc_low;
        t->dqc[ci] = best_dqc_low;
        if (best_si >= t->eob) t->eob = best_si + 1;
    }
}

/* ---- coefficient neighbor contexts ------------------------------------- */
int tpu_clamp_w4(TpuCommit *c, int plane, int u_col, int tw4) {
    int n = plane ? (c->mi_cols + 1) >> 1 : c->mi_cols;
    return u_col + tw4 <= n ? tw4 : n - u_col;
}
int tpu_clamp_h4(TpuCommit *c, int plane, int u_row, int th4) {
    int n = plane ? (c->mi_rows + 1) >> 1 : c->mi_rows;
    return u_row + th4 <= n ? th4 : n - u_row;
}

int tpu_txb_skip_ctx(TpuCommit *c, int plane, int u_row, int u_col, int ts,
                     int bw, int bh) {
    int tw4 = tpu_clamp_w4(c, plane, u_col, TXW[ts] / 4);
    int th4 = tpu_clamp_h4(c, plane, u_row, TXH[ts] / 4);
    const uint8_t *above = c->above_coef[plane] + u_col;
    const uint8_t *left = c->left_coef[plane] + u_row;
    if (plane == 0) {
        if (TXW[ts] >= bw && TXH[ts] >= bh) return 0;
        int top = 0, lf = 0;
        for (int i = 0; i < tw4; i++) top |= above[i];
        for (int i = 0; i < th4; i++) lf |= left[i];
        top &= 63;
        lf &= 63;
        int mx = (top | lf) < 4 ? (top | lf) : 4;
        int mn = top < lf ? top : lf;
        if (mn > 4) mn = 4;
        return SKIP_CTXS[mn][mx];
    }
    int ca = 0, cl = 0;
    for (int i = 0; i < tw4; i++)
        if (above[i] & 63) ca = 1;
    for (int i = 0; i < th4; i++)
        if (left[i] & 63) cl = 1;
    int larger = bw * bh > TXW[ts] * TXH[ts];
    return 7 + (larger ? 3 : 0) + ca + cl;
}
int tpu_dc_sign_ctx(TpuCommit *c, int plane, int u_row, int u_col, int ts) {
    int tw4 = tpu_clamp_w4(c, plane, u_col, TXW[ts] / 4);
    int th4 = tpu_clamp_h4(c, plane, u_row, TXH[ts] / 4);
    const uint8_t *above = c->above_coef[plane] + u_col;
    const uint8_t *left = c->left_coef[plane] + u_row;
    int dc = 0;
    for (int i = 0; i < tw4; i++) {
        int s = above[i] >> 6;
        if (s == 1) dc--;
        else if (s == 2) dc++;
    }
    for (int i = 0; i < th4; i++) {
        int s = left[i] >> 6;
        if (s == 1) dc--;
        else if (s == 2) dc++;
    }
    return dc > 0 ? 2 : dc < 0 ? 1 : 0;
}
void tpu_set_coef_ctx(TpuCommit *c, int plane, int u_row, int u_col, int ts,
                      int cul) {
    int tw4 = tpu_clamp_w4(c, plane, u_col, TXW[ts] / 4);
    int th4 = tpu_clamp_h4(c, plane, u_row, TXH[ts] / 4);
    memset(c->above_coef[plane] + u_col, cul, tw4);
    memset(c->left_coef[plane] + u_row, cul, th4);
}

/* ---- recon commit ------------------------------------------------------ */
void tpu_commit_recon(TpuCommit *c, int plane, int u_row, int u_col, int ts,
                      const int32_t *pred, const TxTrial *t) {
    int sub = plane ? 1 : 0;
    int w = TXW[ts], h = TXH[ts];
    int x = u_col * 4, y = u_row * 4;
    int stride = plane ? c->cstride : c->ystride;
    uint16_t *rp = c->plane[plane];
    int max_x = ((c->mi_cols * 4) >> sub) - 1;
    int max_y = ((c->mi_rows * 4) >> sub) - 1;
    int wx = w < max_x + 1 - x ? w : max_x + 1 - x;
    int wy = h < max_y + 1 - y ? h : max_y + 1 - y;
    int hi = (1 << c->bd) - 1;
    if (t == NULL || t->eob == 0) {
        for (int i = 0; i < wy; i++)
            for (int j = 0; j < wx; j++)
                rp[(y + i) * stride + x + j] = (uint16_t)pred[i * w + j];
    } else {
        int32_t rres[64 * 64];
        tputx_inv2d(t->dqc, rres, ts, t->tt, c->bd);
        for (int i = 0; i < wy; i++)
            for (int j = 0; j < wx; j++) {
                int32_t v = pred[i * w + j] + rres[i * w + j];
                if (v < 0) v = 0;
                if (v > hi) v = hi;
                rp[(y + i) * stride + x + j] = (uint16_t)v;
            }
    }
    tpu_bd_set(c, plane, u_row, u_col, h / 4, w / 4);
}

/* ---- syntax helpers ---------------------------------------------------- */
void tpu_write_delta_q(TpuCommit *c, int absv, int sign) {
    tpuec_symbol(c->ec, absv < 3 ? absv : 3, c->mc->delta_q, 4, 1);
    if (absv >= 3) {
        int v = absv - 1, rem = 0;
        while ((1 << (rem + 1)) <= v) rem++;
        tpuec_literal(c->ec, rem - 1, 3);
        tpuec_literal(c->ec, v - (1 << rem), rem);
    }
    if (absv) tpuec_literal(c->ec, sign, 1);
}

void tpu_write_partition(TpuCommit *c, int r, int c4, int size, int part) {
    int w4 = size / 4;
    int bsl = 0;
    while ((1 << (bsl + 1)) <= w4) bsl++;
    int has_rows = r + (w4 >> 1) < c->mi_rows;
    int has_cols = c4 + (w4 >> 1) < c->mi_cols;
    int above = (c->above_part[c4] >> (bsl - 1)) & 1;
    int left = (c->left_part[r] >> (bsl - 1)) & 1;
    int ctx = (bsl - 1) * 4 + left * 2 + above;
    uint16_t *row = c->mc->partition + ctx * 11;
    if (!has_rows && !has_cols) return;
    if (has_rows && has_cols) {
        int nsyms = bsl == 1 ? 4 : 10;
        tpuec_symbol(c->ec, part, row, nsyms, 1);
        return;
    }
    static const int mem_rows[6] = {2, 3, 4, 6, 7, 9};  /* !has_rows */
    static const int mem_cols[6] = {1, 3, 4, 5, 6, 8};  /* !has_cols */
    const int *mem = has_cols ? mem_rows : mem_cols;
    int p0 = 32768;
    for (int i = 0; i < 6; i++) {
        int m = mem[i];
        int prev = m == 0 ? 32768 : row[m - 1];
        p0 -= prev - row[m];
    }
    uint16_t icdf[3] = {(uint16_t)(32768 - p0), 0, 0};
    tpuec_symbol(c->ec, part == 3 ? 1 : 0, icdf, 2, 0);
}

double tpu_sym_cost_bits(const uint16_t *icdf, int s) {
    return tpuec_cost_symbol(icdf, 0, s) / 512.0;
}

void tpu_update_part_ctx(TpuCommit *c, int r, int c4, int size) {
    int w4 = size / 4;
    memset(c->above_part + c4, part_ctx_byte(size),
           w4 < c->mi_cols - c4 ? w4 : c->mi_cols - c4);
    memset(c->left_part + r, part_ctx_byte(size),
           w4 < c->mi_rows - r ? w4 : c->mi_rows - r);
}

/* ---- per-txb residual syntax ------------------------------------------ */
static void write_block_txb(TpuCommit *c, int plane, int u_row, int u_col,
                            int ts, int bw, int bh, int y_mode_for_rate,
                            int is_inter, const TxTrial *t) {
    int sctx = tpu_txb_skip_ctx(c, plane, u_row, u_col, ts, bw, bh);
    int txs_ctx = txs_entropy_ctx_of(ts);
    int all_zero = t->eob == 0;
    tpuec_symbol(c->ec, all_zero,
                 c->mc->txb_skip + (txs_ctx * 13 + sctx) * 3, 2, 1);
    if (all_zero) {
        tpu_set_coef_ctx(c, plane, u_row, u_col, ts, 0);
        return;
    }
    if (plane == 0 && !is_inter) {
        int set = intra_tx_set_of(ts);
        if (set > 0)
            tpuec_symbol(c->ec, txtype_sym(set, t->tt),
                         c->mc->intra_ext_tx +
                             ((set * 4 + TX_SQR[ts]) * 13 +
                              y_mode_for_rate) * 17,
                         SET_SIZES[set], 1);
    } else if (plane == 0) {
        int st = inter_tx_set_type_of(ts);
        if (st > 0) {
            const int *fwd = st == 1 ? INTER_FWD_T1
                             : st == 4 ? INTER_FWD_T4 : INTER_FWD_T5;
            tpuec_symbol(c->ec, fwd[t->tt],
                         c->ic->inter_ext_tx +
                             (INTER_SET_TO_IDX[st] * 4 + TX_SQR[ts]) * 17,
                         INTER_SET_SIZES[st], 1);
        }
    }
    int adj = TX_ADJ[ts];
    int sgn = tpu_dc_sign_ctx(c, plane, u_row, u_col, ts);
    int cul = tpuec_encode_txb(c->ec, c->tc, t->qc, g_scan[ts][t->tt],
                               g_scan_n[ts][t->tt], TXW[adj], TXH[adj],
                               TXW[ts], TXH[ts], eob_multi_size_of(ts),
                               txs_entropy_ctx_of(ts), tx_class_of(t->tt),
                               plane ? 1 : 0, sgn);
    tpu_set_coef_ctx(c, plane, u_row, u_col, ts, cul);
}

void tpu_write_txb_inter(TpuCommit *c, int plane, int u_row, int u_col,
                         int ts, int bw, int bh, const TxTrial *t) {
    write_block_txb(c, plane, u_row, u_col, ts, bw, bh, 0, 1, t);
}

/* exported helper for the inter var-tx search (inter_backend.c) */
int tpu_txs_entropy_ctx(int ts) {
    return txs_entropy_ctx_of(ts);
}

/* inter ext-tx symbol cost for a candidate tx type (0.0 when the size's
 * set codes no symbol); exported for the inter walk's IDTX tail trial */
double tpu_inter_txtype_cost(TpuCommit *c, int ts, int tt) {
    int st = inter_tx_set_type_of(ts);
    if (st == 0) return 0.0;
    const int *fwd = st == 1 ? INTER_FWD_T1
                     : st == 4 ? INTER_FWD_T4 : INTER_FWD_T5;
    return tpu_sym_cost_bits(
        c->ic->inter_ext_tx + (INTER_SET_TO_IDX[st] * 4 + TX_SQR[ts]) * 17,
        fwd[tt]);
}

/* ---- intra block: trial + write/commit split --------------------------- */
typedef struct {
    int y_mode, uv_mode, skip;
    /* CfL (uv_mode 13): joint sign + alpha indices (spec 5.11.45) */
    int cfl_js, cfl_iu, cfl_iv;
    /* filter intra (spec 5.11.7; DC blocks <= 32) */
    int use_fi, fi_mode;
    double cost;     /* sse + rdmult*rate incl. mode signalling */
    int64_t ydist;   /* luma SSE of the winner (post TX-split choice) */
} IntraChoice;

static __thread int32_t s_pred_y[64 * 64], s_resid_y[64 * 64];
static __thread int32_t s_pred_u[32 * 32], s_pred_v[32 * 32];
static __thread TxTrial s_ty, s_tu, s_tv;
static __thread int s_ad;     /* chosen luma angle delta (-3..3) */
static __thread int s_split;  /* depth-1 TX split chosen (TX_SELECT) */
static __thread TxTrial s_sub_t[4];

/* packed cul_level byte (the tpuec_encode_txb return) from a trial */
static int cul_of_trial(const TxTrial *t, int ts) {
    if (t->eob == 0) return 0;
    const int16_t *scan = g_scan[ts][t->tt];
    int cul = 0;
    for (int i = 0; i < t->eob; i++) {
        int v = t->qc[scan[i]];
        cul += v < 0 ? -v : v;
    }
    if (cul > 63) cul = 63;
    int dc = t->qc[scan[0]];
    if (dc < 0)
        cul |= 64;
    else if (dc > 0)
        cul += 128;
    return cul;
}

/* exported for the inter var-tx ctx-row speculation */
int tpu_cul_of_trial(const TxTrial *t, int ts) {
    return cul_of_trial(t, ts);
}

/* get_tx_size_context: INTER neighbors contribute their BLOCK dims
 * instead of the txfm-context rows (libaom get_tx_size_context
 * is_inter override; twin of tile_parser._tx_size_ctx) */
static int tx_depth_ctx(TpuCommit *c, int r, int c4, int ts_y) {
    int av = -1, lh = -1;
    if (r > c->t_mi_row0) {
        int bw = tpui_grid_inter_bw(c->grid, r - 1, c4);
        av = (bw ? bw : (int)c->above_txw[c4]) >= TXW[ts_y];
    }
    if (c4 > c->t_mi_col0) {
        int bh = tpui_grid_inter_bh(c->grid, r, c4 - 1);
        lh = (bh ? bh : (int)c->left_txh[r]) >= TXH[ts_y];
    }
    if (av >= 0 && lh >= 0) return av + lh;
    if (av >= 0) return av;
    if (lh >= 0) return lh;
    return 0;
}

static void intra_trial(TpuCommit *c, int r, int c4, int size,
                        const uint8_t *cand_modes, int q,
                        int frame_is_intra, IntraChoice *out) {
    PROF_BEGIN;
    ModeCdfs *mc = c->mc;
    int ts_y = tpu_sq_tx(size);
    int ts_c = tpu_uv_tx(size);
    int cr = r >> 1, cc = c4 >> 1;
    static __thread int32_t pred_cand[64 * 64], resid_cand[64 * 64];
    static __thread TxTrial tmp, au, av;

    int sgn_y = tpu_dc_sign_ctx(c, 0, r, c4, ts_y);
    const uint16_t *ymode_cdf;
    if (frame_is_intra) {
        int am = r > 0 ? c->above_mode[c4] : 0;
        int lm = c4 > 0 ? c->left_mode[r] : 0;
        ymode_cdf = mc->kf_y + (IMODE_CTX[am] * 5 + IMODE_CTX[lm]) * 14;
    } else {
        ymode_cdf = c->ic->y_mode + SIZE_GROUP[tpu_sq_bsize(size)] * 14;
    }
    int y_mode = cand_modes[0];
    int kmax = c->n_cands < N_MODE_CANDS ? c->n_cands : N_MODE_CANDS;
    double best_mode_cost = -1.0;
    if (kmax > 1) {
        /* stage-0: cheap SAD rank of the candidate predictions; the
         * full transform trial (the expensive part) only runs for
         * candidates within 25% of the best SAD — the md_stage_0 ->
         * md_stage_1 funnel cut (ref mode_decision.c class pruning) */
        static __thread int32_t cres[N_MODE_CANDS][64 * 64];
        long sads[N_MODE_CANDS];
        long best_sad = -1;
        const uint16_t *sp = c->src[0];
        int ss = c->sstride[0];
        for (int k = 0; k < kmax; k++) {
            sads[k] = -1;
            int m = cand_modes[k];
            int dup = 0;
            for (int k2 = 0; k2 < k; k2++)
                if (cand_modes[k2] == m) dup = 1;
            if (dup) continue;
            tpu_predict_txb(c, 0, m, 0, r, c4, r, c4, ts_y, pred_cand);
            long sad = 0;
            for (int i = 0; i < size; i++)
                for (int j = 0; j < size; j++) {
                    int32_t d =
                        (int32_t)sp[(r * 4 + i) * ss + c4 * 4 + j] -
                        pred_cand[i * size + j];
                    cres[k][i * size + j] = d;
                    sad += d < 0 ? -d : d;
                }
            sads[k] = sad;
            if (best_sad < 0 || sad < best_sad) best_sad = sad;
        }
        for (int k = 0; k < kmax; k++) {
            if (sads[k] < 0 || sads[k] > best_sad + (best_sad >> 2))
                continue;
            int m = cand_modes[k];
            tpu_trial_txb(c, 0, ts_y, 0, cres[k], q, 0, sgn_y, 0, &tmp);
            double rate = tmp.rate512 / 512.0 +
                          tpu_sym_cost_bits(ymode_cdf, m);
            if (m >= 1 && m <= 8)
                rate += tpu_sym_cost_bits(mc->angle_delta + (m - 1) * 8, 3);
            if (c->tune_ssim)
                tpu_predict_txb(c, 0, m, 0, r, c4, r, c4, ts_y,
                                pred_cand);
            double cost = tpu_dist_eval(c, ts_y, pred_cand, cres[k],
                                        &tmp) + c->rdmult * rate;
            if (best_mode_cost < 0 || cost < best_mode_cost) {
                best_mode_cost = cost;
                y_mode = m;
                memcpy(s_resid_y, cres[k],
                       sizeof(int32_t) * size * size);
            }
        }
        /* rebuild the winner's prediction once (vs one copy per cand) */
        tpu_predict_txb(c, 0, y_mode, 0, r, c4, r, c4, ts_y, s_pred_y);
    } else {
        tpu_predict_txb(c, 0, y_mode, 0, r, c4, r, c4, ts_y, s_pred_y);
        const uint16_t *sp = c->src[0];
        int ss = c->sstride[0];
        for (int i = 0; i < size; i++)
            for (int j = 0; j < size; j++)
                s_resid_y[i * size + j] =
                    (int32_t)sp[(r * 4 + i) * ss + c4 * 4 + j] -
                    s_pred_y[i * size + j];
    }

    /* angle-delta refinement for a directional winner (spec 5.11.42
     * angle_delta_y; ref enc_mode_config intra angle levels): greedy
     * +/-1 probe then extend in the improving direction. Each step is
     * one predict + DCT trial; the walk is a small share of frame time
     * so this runs at every preset with a mode funnel. */
    s_ad = 0;
    if (y_mode >= 1 && y_mode <= 8 && c->n_cands >= 3) {
        const uint16_t *adcdf = mc->angle_delta + (y_mode - 1) * 8;
        const uint16_t *sp = c->src[0];
        int ss = c->sstride[0];
        tpu_trial_txb(c, 0, ts_y, 0, s_resid_y, q, 0, sgn_y, 0, &tmp);
        double base = tpu_dist_eval(c, ts_y, s_pred_y, s_resid_y, &tmp) +
                      c->rdmult * (tmp.rate512 / 512.0 +
                                   tpu_sym_cost_bits(adcdf, 3));
        int dir = 0;
        for (int step = 1; step <= 3; step++) {
            int tried = 0;
            for (int sg = -1; sg <= 1; sg += 2) {
                if (step > 1 && sg != dir) continue;
                int ad = (step == 1 ? sg : dir * step);
                tpu_predict_txb(c, 0, y_mode, ad, r, c4, r, c4, ts_y,
                                pred_cand);
                for (int i = 0; i < size; i++)
                    for (int j = 0; j < size; j++)
                        resid_cand[i * size + j] =
                            (int32_t)sp[(r * 4 + i) * ss + c4 * 4 + j] -
                            pred_cand[i * size + j];
                tpu_trial_txb(c, 0, ts_y, 0, resid_cand, q, 0, sgn_y, 0,
                              &tmp);
                double cost =
                    tpu_dist_eval(c, ts_y, pred_cand, resid_cand, &tmp) +
                    c->rdmult * (tmp.rate512 / 512.0 +
                                 tpu_sym_cost_bits(adcdf, 3 + ad));
                if (cost < base) {
                    base = cost;
                    s_ad = ad;
                    if (step == 1) dir = sg;
                    memcpy(s_pred_y, pred_cand,
                           sizeof(int32_t) * size * size);
                    memcpy(s_resid_y, resid_cand,
                           sizeof(int32_t) * size * size);
                    tried = 1;
                }
            }
            if (step == 1 && !dir) break;
            if (step > 1 && !tried) break;
        }
    }

    /* filter-intra trial (spec 7.11.6; ref filter_intra_level in
     * enc_mode_config.c): five recursive-filter candidates replace the
     * DC prediction when they win the DCT-trial RD incl. the
     * filter_intra flag + mode symbol rates. Intra frames, <=32. */
    int s_use_fi = 0, s_fi_mode = 0;
    if (c->fi_search && frame_is_intra && y_mode == 0 && size <= 32) {
        const uint16_t *ficdf =
            mc->filter_intra + tpu_sq_bsize(size) * 3;
        const uint16_t *sp3 = c->src[0];
        int ss3 = c->sstride[0];
        tpu_trial_txb(c, 0, ts_y, 0, s_resid_y, q, 0, sgn_y, 0, &tmp);
        double base = tpu_dist_eval(c, ts_y, s_pred_y, s_resid_y, &tmp) +
                      c->rdmult * (tmp.rate512 / 512.0 +
                                   tpu_sym_cost_bits(ficdf, 0));
        for (int fm = 0; fm < 5; fm++) {
            tpu_predict_txb(c, 0, 100 + fm, 0, r, c4, r, c4, ts_y,
                            pred_cand);
            for (int i = 0; i < size; i++)
                for (int j = 0; j < size; j++)
                    resid_cand[i * size + j] =
                        (int32_t)sp3[(r * 4 + i) * ss3 + c4 * 4 + j] -
                        pred_cand[i * size + j];
            tpu_trial_txb(c, 0, ts_y, 0, resid_cand, q, 0, sgn_y, 0,
                          &tmp);
            double cost =
                tpu_dist_eval(c, ts_y, pred_cand, resid_cand, &tmp) +
                c->rdmult * (tmp.rate512 / 512.0 +
                             tpu_sym_cost_bits(ficdf, 1) +
                             tpu_sym_cost_bits(mc->filter_intra_mode, fm));
            if (cost < base) {
                base = cost;
                s_use_fi = 1;
                s_fi_mode = fm;
                memcpy(s_pred_y, pred_cand, sizeof(int32_t) * size * size);
                memcpy(s_resid_y, resid_cand,
                       sizeof(int32_t) * size * size);
            }
        }
    }
    /* tx-type signalling context for filter-intra blocks maps the fi
     * mode to an intra direction (spec read_tx_type; FIMODE_TO_INTRADIR) */
    static const int FI2DIR[5] = {0, 1, 2, 6, 0};
    int txmode = s_use_fi ? FI2DIR[s_fi_mode] : y_mode;

    /* tx-type trial for the winning mode (DCT reused from stage 1 when
     * the mode funnel ran) */
    int set = intra_tx_set_of(ts_y);
    const int *cands = set == 0 ? SET0_CANDS
                       : set == 1 ? SET1_CANDS : SET2_CANDS;
    int ncands = set == 0 ? 1 : set == 1 ? 5 : 3;
    double best_cost = -1.0;
    for (int i = 0; i < ncands; i++) {
        int tt = cands[i];
        tpu_trial_txb(c, 0, ts_y, tt, s_resid_y, q, 0, sgn_y, 0, &tmp);
        double rate = tmp.rate512 / 512.0;
        if (tmp.eob && set > 0)
            rate += tpu_sym_cost_bits(
                mc->intra_ext_tx +
                    ((set * 4 + TX_SQR[ts_y]) * 13 + txmode) * 17,
                txtype_sym(set, tt));
        double cost = (double)tmp.sse + c->psy_rd * tmp.psy +
                      c->rdmult * rate;
        if (best_cost < 0 || cost < best_cost) {
            best_cost = cost;
            s_ty = tmp;
        }
        if (i == 0 && tmp.eob == 0) break;
    }

    /* depth-1 TX split trial (TX_MODE_SELECT, spec 5.11.15): per-sub-TXB
     * prediction from recon with speculative commit + rollback; compare
     * against the full-size winner incl. the tx_size depth symbol and
     * per-txb skip/type rates (ref tx_search.c tx-depth RD). */
    s_split = 0;
    /* eob == 0 gate: a full-size winner that quantizes to nothing
     * leaves the split arm nothing to improve (children of a zero
     * residual also skip) — the probe's 4 x n_types trials are pure
     * waste there (most blocks at speed presets on flat content) */
    if (c->tx_select && frame_is_intra && ts_y >= 1 && ts_y <= 4 &&
        c->n_cands >= 2 && !s_use_fi &&
        (s_ty.eob || (c->max_tx32 && ts_y == 4))) {
        int sub_ts = ts_y - 1;
        int h4q = (size / 2) / 4;
        int cat = ts_y - 1;
        int nsyms = ts_y == 1 ? 2 : 3;
        const uint16_t *dcdf =
            mc->tx_size + (cat * 3 + tx_depth_ctx(c, r, c4, ts_y)) * 4;
        int set0 = intra_tx_set_of(ts_y);
        double tt0 = 0.0;
        if (s_ty.eob && set0 > 0)
            tt0 = tpu_sym_cost_bits(
                mc->intra_ext_tx +
                    ((set0 * 4 + TX_SQR[ts_y]) * 13 + txmode) * 17,
                txtype_sym(set0, s_ty.tt));
        double skip0 = tpu_sym_cost_bits(
            mc->txb_skip + (txs_entropy_ctx_of(ts_y) * 13 + 0) * 3,
            s_ty.eob == 0);
        double cost0 = tpu_dist_eval(c, ts_y, s_pred_y, s_resid_y,
                                     &s_ty) +
                       c->rdmult * (s_ty.rate512 / 512.0 + skip0 + tt0 +
                                    tpu_sym_cost_bits(dcdf, 0));
        /* save state touched by the speculative quadrant walk */
        int w4b = size / 4;
        int aw4b = w4b < c->mi_cols - c4 ? w4b : c->mi_cols - c4;
        int lh4b = w4b < c->mi_rows - r ? w4b : c->mi_rows - r;
        uint8_t sv_ac[16], sv_lc[16], sv_bd[18 * 18];
        memcpy(sv_ac, c->above_coef[0] + c4, aw4b);
        memcpy(sv_lc, c->left_coef[0] + r, lh4b);
        memcpy(sv_bd, c->bdmap[0], sizeof(sv_bd));
        static __thread uint16_t sv_plane[64 * 64];
        int px = c4 * 4, py = r * 4;
        int maxw = c->mi_cols * 4, maxh = c->mi_rows * 4;
        int wx = size < maxw - px ? size : maxw - px;
        int wy = size < maxh - py ? size : maxh - py;
        for (int i = 0; i < wy; i++)
            memcpy(sv_plane + i * size,
                   c->plane[0] + (py + i) * c->ystride + px, wx * 2);

        int sset = intra_tx_set_of(sub_ts);
        const int *scands = sset == 0   ? SET0_CANDS
                            : sset == 1 ? SET1_CANDS
                                        : SET2_CANDS;
        int nsc = sset == 0 ? 1 : sset == 1 ? 5 : 3;
        double cost1 = c->rdmult * tpu_sym_cost_bits(dcdf, 1);
        static __thread int32_t qpred[32 * 32], qresid[32 * 32];
        static __thread TxTrial qt;
        int sub_px = size / 2;
        for (int qi = 0; qi < 4; qi++) {
            int qr = r + (qi >> 1) * h4q, qc = c4 + (qi & 1) * h4q;
            tpu_predict_txb(c, 0, y_mode, s_ad, r, c4, qr, qc, sub_ts,
                            qpred);
            const uint16_t *sp = c->src[0];
            int ss = c->sstride[0];
            for (int i = 0; i < sub_px; i++)
                for (int j = 0; j < sub_px; j++)
                    qresid[i * sub_px + j] =
                        (int32_t)sp[(qr * 4 + i) * ss + qc * 4 + j] -
                        qpred[i * sub_px + j];
            int sctx =
                tpu_txb_skip_ctx(c, 0, qr, qc, sub_ts, size, size);
            int qsgn = tpu_dc_sign_ctx(c, 0, qr, qc, sub_ts);
            double qbest = -1.0;
            for (int ti = 0; ti < nsc; ti++) {
                tpu_trial_txb(c, 0, sub_ts, scands[ti], qresid, q, 0,
                              qsgn, 0, &qt);
                double rate = qt.rate512 / 512.0 +
                              tpu_sym_cost_bits(
                                  mc->txb_skip +
                                      (txs_entropy_ctx_of(sub_ts) * 13 +
                                       sctx) * 3,
                                  qt.eob == 0);
                if (qt.eob && sset > 0)
                    rate += tpu_sym_cost_bits(
                        mc->intra_ext_tx +
                            ((sset * 4 + TX_SQR[sub_ts]) * 13 + txmode) *
                                17,
                        txtype_sym(sset, qt.tt));
                double qcst = (double)qt.sse + c->psy_rd * qt.psy +
                              c->rdmult * rate;
                if (qbest < 0 || qcst < qbest) {
                    qbest = qcst;
                    s_sub_t[qi] = qt;
                }
                if (ti == 0 && qt.eob == 0) break;
            }
            cost1 += qbest;
            /* speculative recon + ctx so the next quadrant predicts
             * from this one (spec per-txb intra prediction) */
            tpu_commit_recon(c, 0, qr, qc, sub_ts, qpred, &s_sub_t[qi]);
            tpu_set_coef_ctx(c, 0, qr, qc, sub_ts,
                             cul_of_trial(&s_sub_t[qi], sub_ts));
        }
        /* rollback: the write/commit phase redoes the walk for real */
        memcpy(c->above_coef[0] + c4, sv_ac, aw4b);
        memcpy(c->left_coef[0] + r, sv_lc, lh4b);
        memcpy(c->bdmap[0], sv_bd, sizeof(sv_bd));
        for (int i = 0; i < wy; i++)
            memcpy(c->plane[0] + (py + i) * c->ystride + px,
                   sv_plane + i * size, wx * 2);
        if (cost1 < cost0) s_split = 1;
        /* PSY max-32-tx-size: never keep a 64-side transform
         * (ref README.md:67-69; enc_handle.c:1947) */
        if (c->max_tx32 && ts_y == 4) s_split = 1;
    }

    /* chroma trial: DC, SMOOTH, same-as-luma */
    static const int UVM[2] = {0, 9};
    int uv_cands[3];
    int nuv = 2;
    for (int i = 0; i < 2; i++) uv_cands[i] = UVM[i];
    if (y_mode != 0 && y_mode != 9) uv_cands[nuv++] = y_mode;
    int cfl_ok = size <= 32;
    int sgn_u = tpu_dc_sign_ctx(c, 1, cr, cc, ts_c);
    int sgn_v = tpu_dc_sign_ctx(c, 2, cr, cc, ts_c);
    int cw = TXW[ts_c], chh = TXH[ts_c];
    double best_uv_cost = -1.0;
    int uv_mode = 0;
    static __thread int32_t resid_u[32 * 32], resid_v[32 * 32];
    static __thread int32_t tpu2[32 * 32], tpv2[32 * 32];
    for (int i = 0; i < nuv; i++) {
        int m = uv_cands[i];
        int tt = 0;
        {
            int uset = intra_tx_set_of(ts_c);
            if (uset > 0) {
                int t = MODE2TXFM[m];
                tt = txtype_sym(uset, t) >= 0 ? t : 0;
            }
        }
        tpu_predict_txb(c, 1, m, 0, r, c4, cr, cc, ts_c, tpu2);
        tpu_predict_txb(c, 2, m, 0, r, c4, cr, cc, ts_c, tpv2);
        const uint16_t *su = c->src[1], *sv = c->src[2];
        int ss = c->sstride[1];
        for (int ii = 0; ii < chh; ii++)
            for (int jj = 0; jj < cw; jj++) {
                int off = (cr * 4 + ii) * ss + cc * 4 + jj;
                resid_u[ii * cw + jj] = (int32_t)su[off] - tpu2[ii * cw + jj];
                resid_v[ii * cw + jj] = (int32_t)sv[off] - tpv2[ii * cw + jj];
            }
        static __thread TxTrial cu2, cv2;
        tpu_trial_txb(c, 1, ts_c, tt, resid_u, q, 1, sgn_u, 0, &cu2);
        tpu_trial_txb(c, 2, ts_c, tt, resid_v, q, 1, sgn_v, 0, &cv2);
        double rate = (cu2.rate512 + cv2.rate512) / 512.0 +
                      tpu_sym_cost_bits(mc->uv_mode +
                                            (cfl_ok * 13 + y_mode) * 15, m);
        double cost = tpu_dist_eval(c, ts_c, tpu2, resid_u, &cu2) +
                      tpu_dist_eval(c, ts_c, tpv2, resid_v, &cv2) +
                      c->rdmult * rate;
        if (best_uv_cost < 0 || cost < best_uv_cost) {
            best_uv_cost = cost;
            uv_mode = m;
            au = cu2;
            av = cv2;
            memcpy(s_pred_u, tpu2, sizeof(int32_t) * cw * chh);
            memcpy(s_pred_v, tpv2, sizeof(int32_t) * cw * chh);
        }
        if (i == 0 && cu2.eob == 0 && cv2.eob == 0)
            break;   /* DC already lossless-at-this-q: modes tie */
    }
    /* CfL candidate (uv_mode 13; spec 7.11.5; ref cfl alpha RD in
     * product_coding_loop.c): least-squares alpha per plane from the
     * RECONSTRUCTED luma AC (twin of ops/intra.cfl_luma_ac / cfl_pred),
     * refined +-1, exact sign/alpha symbol rates. Intra frames, square
     * <=32 blocks at the largest-tx luma choice. */
    int cfl_js = -1, cfl_iu = 0, cfl_iv = 0;
    if (c->cfl_search && cfl_ok && !s_split && frame_is_intra &&
        !c->noise_norm) {
        /* (noise-norm would change the committed luma recon after this
         * trial, desyncing the decoder's CfL prediction) */
        static __thread int32_t recy[64 * 64], rres[64 * 64];
        static __thread int32_t lac[32 * 32];
        static __thread int32_t dcu[32 * 32], dcv[32 * 32];
        static __thread int32_t cpred[32 * 32];
        int hi = (1 << c->bd) - 1;
        if (s_ty.eob) {
            tputx_inv2d(s_ty.dqc, rres, ts_y, s_ty.tt, c->bd);
            for (int i = 0; i < size * size; i++) {
                int v = s_pred_y[i] + rres[i];
                recy[i] = v < 0 ? 0 : v > hi ? hi : v;
            }
        } else {
            memcpy(recy, s_pred_y, sizeof(int32_t) * size * size);
        }
        /* subsampled luma minus average, Q3 (spec 7.11.5.2/.3) */
        long tot = 0;
        for (int i = 0; i < chh; i++)
            for (int j = 0; j < cw; j++) {
                int32_t t2 = (recy[(2 * i) * size + 2 * j] +
                              recy[(2 * i) * size + 2 * j + 1] +
                              recy[(2 * i + 1) * size + 2 * j] +
                              recy[(2 * i + 1) * size + 2 * j + 1]) << 1;
                lac[i * cw + j] = t2;
                tot += t2;
            }
        int n = cw * chh;
        int lg = 0;
        while ((1 << lg) < n) lg++;
        int32_t avg = (int32_t)((tot + (n >> 1)) >> lg);
        long den = 0;
        for (int i = 0; i < n; i++) {
            lac[i] -= avg;
            den += (long)lac[i] * lac[i];
        }
        tpu_predict_txb(c, 1, 0, 0, r, c4, cr, cc, ts_c, dcu);
        tpu_predict_txb(c, 2, 0, 0, r, c4, cr, cc, ts_c, dcv);
        const uint16_t *su2 = c->src[1], *sv2 = c->src[2];
        int ss2 = c->sstride[1];
        double pl_cost[2];
        int pl_alpha[2];
        static __thread TxTrial pl_trial[2];
        static __thread int32_t pl_pred[2][32 * 32];
        for (int pl = 0; pl < 2; pl++) {
            const uint16_t *sp2 = pl ? sv2 : su2;
            int32_t *dc = pl ? dcv : dcu;
            int sgn = pl ? sgn_v : sgn_u;
            long num = 0;
            for (int i = 0; i < chh; i++)
                for (int j = 0; j < cw; j++)
                    num += (long)lac[i * cw + j] *
                           ((int32_t)sp2[(cr * 4 + i) * ss2 + cc * 4 + j] -
                            dc[i * cw + j]);
            int a0 = 0;
            if (den > 0) {
                double af = 64.0 * (double)num / (double)den;
                a0 = (int)(af >= 0 ? af + 0.5 : af - 0.5);
                if (a0 > 16) a0 = 16;
                if (a0 < -16) a0 = -16;
            }
            double bestc = -1.0;
            int besta = 0;
            int cands2[4] = {0, a0, a0 - 1, a0 + 1};
            for (int ci = 0; ci < 4; ci++) {
                int a = cands2[ci];
                if (a < -16 || a > 16) continue;
                int dup2 = 0;
                for (int cj = 0; cj < ci; cj++)
                    if (cands2[cj] == a) dup2 = 1;
                if (dup2) continue;
                for (int i = 0; i < n; i++) {
                    long prod = (long)a * lac[i];
                    int adj = prod >= 0 ? (int)((prod + 32) >> 6)
                                        : -(int)((-prod + 32) >> 6);
                    int v = dc[i] + adj;
                    cpred[i] = v < 0 ? 0 : v > hi ? hi : v;
                }
                for (int i = 0; i < chh; i++)
                    for (int j = 0; j < cw; j++)
                        resid_u[i * cw + j] =
                            (int32_t)sp2[(cr * 4 + i) * ss2 + cc * 4 + j] -
                            cpred[i * cw + j];
                static __thread TxTrial ct;
                tpu_trial_txb(c, pl + 1, ts_c, 0, resid_u, q, 1, sgn, 0,
                              &ct);
                double cost = tpu_dist_eval(c, ts_c, cpred, resid_u, &ct) +
                              c->rdmult * (ct.rate512 / 512.0);
                if (bestc < 0 || cost < bestc) {
                    bestc = cost;
                    besta = a;
                    pl_trial[pl] = ct;
                    memcpy(pl_pred[pl], cpred, sizeof(int32_t) * n);
                }
            }
            pl_cost[pl] = bestc;
            pl_alpha[pl] = besta;
        }
        int au2 = pl_alpha[0], av2 = pl_alpha[1];
        if (au2 || av2) {
            int su3 = au2 == 0 ? 0 : au2 > 0 ? 2 : 1;
            int sv3 = av2 == 0 ? 0 : av2 > 0 ? 2 : 1;
            int js = su3 * 3 + sv3 - 1;
            int iu = au2 ? (au2 > 0 ? au2 : -au2) - 1 : 0;
            int iv = av2 ? (av2 > 0 ? av2 : -av2) - 1 : 0;
            double rate_hdr =
                tpu_sym_cost_bits(mc->uv_mode + (cfl_ok * 13 + y_mode) * 15,
                                  13) +
                tpu_sym_cost_bits(mc->cfl_sign, js);
            if (su3)
                rate_hdr += tpu_sym_cost_bits(
                    mc->cfl_alpha + (js + 1 - 3) * 17, iu);
            if (sv3)
                rate_hdr += tpu_sym_cost_bits(
                    mc->cfl_alpha + (sv3 * 3 + su3 - 3) * 17, iv);
            double cost13 = pl_cost[0] + pl_cost[1] +
                            c->rdmult * rate_hdr;
            if (cost13 < best_uv_cost) {
                best_uv_cost = cost13;
                uv_mode = 13;
                cfl_js = js;
                cfl_iu = iu;
                cfl_iv = iv;
                au = pl_trial[0];
                av = pl_trial[1];
                memcpy(s_pred_u, pl_pred[0], sizeof(int32_t) * n);
                memcpy(s_pred_v, pl_pred[1], sizeof(int32_t) * n);
            }
        }
    }

    s_tu = au;
    s_tv = av;
    out->ydist = s_split ? (s_sub_t[0].sse + s_sub_t[1].sse +
                            s_sub_t[2].sse + s_sub_t[3].sse)
                         : s_ty.sse;
    out->y_mode = y_mode;
    out->uv_mode = uv_mode;
    out->cfl_js = cfl_js;
    out->cfl_iu = cfl_iu;
    out->cfl_iv = cfl_iv;
    out->use_fi = s_use_fi;
    out->fi_mode = s_fi_mode;
    int y_eob = s_split ? (s_sub_t[0].eob | s_sub_t[1].eob |
                           s_sub_t[2].eob | s_sub_t[3].eob)
                        : s_ty.eob;
    out->skip = (y_eob == 0 && s_tu.eob == 0 && s_tv.eob == 0);
    double mode_rate = tpu_sym_cost_bits(ymode_cdf, y_mode);
    if (y_mode >= 1 && y_mode <= 8)
        mode_rate += tpu_sym_cost_bits(mc->angle_delta + (y_mode - 1) * 8,
                                       3 + s_ad);
    if (c->fi_search && y_mode == 0 && size <= 32) {
        mode_rate += tpu_sym_cost_bits(
            mc->filter_intra + tpu_sq_bsize(size) * 3, s_use_fi);
        if (s_use_fi)
            mode_rate += tpu_sym_cost_bits(mc->filter_intra_mode,
                                           s_fi_mode);
    }
    out->cost = best_cost + best_uv_cost + c->rdmult * mode_rate;
    PROF_MARK(6);
}

/* ---- Tune 3 SSIM-weighted distortion (ref full_loop.c:2220-2290,
 * mode_decision.c:5118 svt_spatial_full_distortion_ssim_kernel) -------- */
static const long long SSIM_CC1 = 26634;       /* (64^2*(.01*255)^2 */
static const long long SSIM_CC2 = 239708;      /* (64^2*(.03*255)^2 */
static const long long SSIM_CC1_10 = 428658;   /* (64^2*(.01*1023)^2 */
static const long long SSIM_CC2_10 = 3857925;  /* (64^2*(.03*1023)^2 */

/* one nxn SSIM window over uint16 samples (ref enc_dec_process.c:709
 * similarity + mode_decision.c svt_ssim_8x8_c / svt_ssim_8x8_hbd_c) */
static double ssim_win(const uint16_t *s, int sp, const uint16_t *r,
                       int rp, int n, int bd) {
    long long cnt = n * n;
    long long cc1 = bd == 8 ? SSIM_CC1 : SSIM_CC1_10;
    long long cc2 = bd == 8 ? SSIM_CC2 : SSIM_CC2_10;
    double c1 = (double)((cc1 * cnt * cnt) >> 12);
    double c2 = (double)((cc2 * cnt * cnt) >> 12);
    unsigned ss = 0, sr = 0, sqs = 0, sqr = 0, sxr = 0;
    for (int i = 0; i < n; i++, s += sp, r += rp)
        for (int j = 0; j < n; j++) {
            ss += s[j];
            sr += r[j];
            sqs += (unsigned)s[j] * s[j];
            sqr += (unsigned)r[j] * r[j];
            sxr += (unsigned)s[j] * r[j];
        }
    double nn = (2.0 * ss * sr + c1) *
                (2.0 * cnt * sxr - 2.0 * ss * sr + c2);
    double dd = ((double)ss * ss + (double)sr * sr + c1) *
                ((double)cnt * sqs - (double)ss * ss +
                 (double)cnt * sqr - (double)sr * sr + c2);
    return nn / dd;
}

/* averaged SSIM over 8x8 (or 4x4 for thin blocks) windows (ref
 * mode_decision.c ssim_8x8_blocks / ssim_4x4_blocks) */
static double ssim_block(const uint16_t *s, int sp, const uint16_t *r,
                         int rp, int w, int h, int bd) {
    int n = (w % 8 == 0 && h % 8 == 0) ? 8 : 4;
    int samples = 0;
    double total = 0;
    for (int i = 0; i + n <= h; i += n)
        for (int j = 0; j + n <= w; j += n) {
            double v = ssim_win(s + i * sp + j, sp, r + i * rp + j, rp, n,
                                bd);
            if (v < 0) v = 0;
            if (v > 1) v = 1;
            total += v;
            samples++;
        }
    return samples ? total / samples : 1.0;
}

/* candidate distortion: SSE (+ psy) by default; Tune 3 swaps in the
 * SSIM-weighted spatial distortion of the candidate's reconstruction
 * (the DIST_SSIM arm of md_stage_3, ref full_loop.c:2220). pred+resid
 * reproduce the source; pred+inv(dqc) the reconstruction. */
double tpu_dist_eval(TpuCommit *c, int ts, const int32_t *pred,
                     const int32_t *resid, const TxTrial *t) {
    double d = (double)t->sse + c->psy_rd * t->psy;
    if (!c->tune_ssim) return d;
    int w = TXW[ts], h = TXH[ts];
    static __thread uint16_t sbuf[64 * 64], rbuf[64 * 64];
    static __thread int32_t rres[64 * 64];
    int hi = (1 << c->bd) - 1;
    if (t->eob)
        tputx_inv2d(t->dqc, rres, ts, t->tt, c->bd);
    for (int i = 0; i < w * h; i++) {
        sbuf[i] = (uint16_t)(pred[i] + resid[i]);
        int rv = pred[i] + (t->eob ? rres[i] : 0);
        if (rv < 0) rv = 0;
        if (rv > hi) rv = hi;
        rbuf[i] = (uint16_t)rv;
    }
    double sv = ssim_block(sbuf, w, rbuf, w, w, h, c->bd);
    int m = c->bd == 8 ? 1 : 8;
    double ssim_dist = (1.0 - sv) * (w * h) * 100.0 * 7.0 * m;
    return ssim_dist + c->psy_rd * t->psy;
}

/* rebuild the luma residual of a chosen txb from source - prediction and
 * run PSY noise normalization on the trial's coefficients (the encode
 * pass gate of full_loop.c:1818: luma, eob != 0, non-IDTX) */
static void noise_norm_commit(TpuCommit *c, int u_row, int u_col, int ts,
                              const int32_t *pred, TxTrial *t) {
    static __thread int32_t nn_resid[64 * 64];
    int w = TXW[ts], h = TXH[ts];
    const uint16_t *sy = c->src[0];
    int ss = c->sstride[0];
    int y = u_row * 4, x = u_col * 4;
    for (int i = 0; i < h; i++)
        for (int j = 0; j < w; j++)
            nn_resid[i * w + j] =
                (int32_t)sy[(y + i) * ss + x + j] - pred[i * w + j];
    tpu_noise_norm_txb(c, ts, nn_resid, t->q, t);
}

/* neighbor-context rows updated AFTER the block's txbs (the parser does
 * the same in finish_block; sub-txb predictions of a split block must
 * see the pre-block smooth flags) */
static void intra_update_rows(TpuCommit *c, int r, int c4, int aw4,
                              int lh4, int y_mode, int uv_mode,
                              int skip) {
    memset(c->above_mode + c4, y_mode, aw4);
    memset(c->left_mode + r, y_mode, lh4);
    memset(c->above_skip + c4, skip, aw4);
    memset(c->left_skip + r, skip, lh4);
    int ysm = (y_mode >= 9 && y_mode <= 11);
    int usm = (uv_mode >= 9 && uv_mode <= 11);
    memset(c->above_smooth[0] + c4, ysm, aw4);
    memset(c->left_smooth[0] + r, ysm, lh4);
    memset(c->above_smooth[1] + c4, usm, aw4);
    memset(c->left_smooth[1] + r, usm, lh4);
}

static void intra_write_commit(TpuCommit *c, int r, int c4, int size,
                               const IntraChoice *ch, int frame_is_intra) {
    PROF_BEGIN;
    ModeCdfs *mc = c->mc;
    int ts_y = tpu_sq_tx(size);
    int ts_c = tpu_uv_tx(size);
    int cr = r >> 1, cc = c4 >> 1;
    int w4 = size / 4;
    int y_mode = ch->y_mode, uv_mode = ch->uv_mode, skip = ch->skip;
    /* tx-type context mode: filter-intra maps to an intra direction */
    static const int FI2DIR_W[5] = {0, 1, 2, 6, 0};
    int wmode = ch->use_fi ? FI2DIR_W[ch->fi_mode] : y_mode;
    int cfl_ok = size <= 32;

    if (frame_is_intra) {
        int am = r > 0 ? c->above_mode[c4] : 0;
        int lm = c4 > 0 ? c->left_mode[r] : 0;
        tpuec_symbol(c->ec, y_mode,
                     mc->kf_y + (IMODE_CTX[am] * 5 + IMODE_CTX[lm]) * 14,
                     13, 1);
    } else {
        tpuec_symbol(c->ec, y_mode,
                     c->ic->y_mode + SIZE_GROUP[tpu_sq_bsize(size)] * 14,
                     13, 1);
    }
    if (y_mode >= 1 && y_mode <= 8)
        tpuec_symbol(c->ec, 3 + s_ad, mc->angle_delta + (y_mode - 1) * 8,
                     7, 1);
    tpuec_symbol(c->ec, uv_mode, mc->uv_mode + (cfl_ok * 13 + y_mode) * 15,
                 cfl_ok ? 14 : 13, 1);
    if (uv_mode == 13) {
        /* cfl_alpha_signs + indices (spec 5.11.45; mirror of
         * entropy/tile_writer.write_block's CfL branch) */
        int js = ch->cfl_js;
        tpuec_symbol(c->ec, js, mc->cfl_sign, 8, 1);
        int sign_u = ((js + 1) * 11) >> 5;
        int sign_v = (js + 1) - 3 * sign_u;
        if (sign_u)
            tpuec_symbol(c->ec, ch->cfl_iu,
                         mc->cfl_alpha + (js + 1 - 3) * 17, 16, 1);
        if (sign_v)
            tpuec_symbol(c->ec, ch->cfl_iv,
                         mc->cfl_alpha + (sign_v * 3 + sign_u - 3) * 17,
                         16, 1);
    } else if (uv_mode >= 1 && uv_mode <= 8)
        tpuec_symbol(c->ec, 3, mc->angle_delta + (uv_mode - 1) * 8, 7, 1);

    /* filter_intra_mode_info (spec 5.11.7): flag for every DC block
     * <= 32x32 once the sequence enables the tool */
    if (c->fi_search && y_mode == 0 && size <= 32) {
        tpuec_symbol(c->ec, ch->use_fi,
                     mc->filter_intra + tpu_sq_bsize(size) * 3, 2, 1);
        if (ch->use_fi)
            tpuec_symbol(c->ec, ch->fi_mode, mc->filter_intra_mode, 5, 1);
    }

    int aw4 = w4 < c->mi_cols - c4 ? w4 : c->mi_cols - c4;
    int lh4 = w4 < c->mi_rows - r ? w4 : c->mi_rows - r;

    /* tx_size depth symbol (TX_MODE_SELECT, spec 5.11.15) + the
     * AboveTxWidth/LeftTxHeight context rows */
    int ts_eff = ts_y;
    if (c->tx_select) {
        /* intra blocks code the tx depth symbol in BOTH frame kinds
         * (spec read_tx_size; the split search runs on intra frames
         * only — intra-in-inter blocks always code depth 0) */
        int spl = frame_is_intra ? s_split : 0;
        int cat = ts_y - 1;
        int nsyms = ts_y == 1 ? 2 : 3;
        uint16_t *dcdf =
            mc->tx_size + (cat * 3 + tx_depth_ctx(c, r, c4, ts_y)) * 4;
        tpuec_symbol(c->ec, spl, dcdf, nsyms, 1);
        if (spl) ts_eff = ts_y - 1;
        memset(c->above_txw + c4, TXW[ts_eff], aw4);
        memset(c->left_txh + r, TXH[ts_eff], lh4);
    }
    if (c->lf_txdim[0]) {
        for (int i = 0; i < lh4; i++)
            memset(c->lf_txdim[0] + (r + i) * c->lf_stride[0] + c4,
                   TXW[ts_eff] > 64 ? 64 : TXW[ts_eff], aw4);
        int ch4 = tpu_clamp_h4(c, 1, cr, w4 >> 1 ? w4 >> 1 : 1);
        int cw4c = tpu_clamp_w4(c, 1, cc, w4 >> 1 ? w4 >> 1 : 1);
        for (int i = 0; i < ch4; i++)
            memset(c->lf_txdim[1] + (cr + i) * c->lf_stride[1] + cc,
                   TXW[ts_c], cw4c);
    }
    if (c->skip_map)
        for (int i = 0; i < lh4; i++)
            memset(c->skip_map + (r + i) * c->skip_stride + c4, skip, aw4);
    if (c->grid)
        tpui_grid_set(c->grid, r, c4, w4, w4, tpu_sq_bsize(size), 0, 0, 0,
                      0);

    int do_split = c->tx_select && frame_is_intra && s_split;
    static __thread int32_t wqpred[32 * 32];
    if (skip) {
        memset(c->above_coef[0] + c4, 0, aw4);
        memset(c->left_coef[0] + r, 0, lh4);
        int cw4 = w4 >> 1 ? w4 >> 1 : 1;
        for (int p = 1; p < 3; p++) {
            memset(c->above_coef[p] + cc, 0, tpu_clamp_w4(c, p, cc, cw4));
            memset(c->left_coef[p] + cr, 0, tpu_clamp_h4(c, p, cr, cw4));
        }
        if (do_split) {
            int h4q = (size / 2) / 4;
            for (int qi = 0; qi < 4; qi++) {
                int qr = r + (qi >> 1) * h4q, qc = c4 + (qi & 1) * h4q;
                tpu_predict_txb(c, 0, y_mode, s_ad, r, c4, qr, qc,
                                ts_y - 1, wqpred);
                tpu_commit_recon(c, 0, qr, qc, ts_y - 1, wqpred, NULL);
                c->dist_acc += s_sub_t[qi].sse;
            }
        } else {
            tpu_commit_recon(c, 0, r, c4, ts_y, s_pred_y, NULL);
            c->dist_acc += s_ty.sse;
        }
        tpu_commit_recon(c, 1, cr, cc, ts_c, s_pred_u, NULL);
        tpu_commit_recon(c, 2, cr, cc, ts_c, s_pred_v, NULL);
        c->dist_acc += s_tu.sse + s_tv.sse;
        intra_update_rows(c, r, c4, aw4, lh4, y_mode, uv_mode, skip);
        PROF_MARK(5);
        return;
    }
    if (do_split) {
        int h4q = (size / 2) / 4;
        for (int qi = 0; qi < 4; qi++) {
            int qr = r + (qi >> 1) * h4q, qc = c4 + (qi & 1) * h4q;
            tpu_predict_txb(c, 0, y_mode, s_ad, r, c4, qr, qc, ts_y - 1,
                            wqpred);
            if (c->noise_norm && s_sub_t[qi].eob)
                noise_norm_commit(c, qr, qc, ts_y - 1, wqpred,
                                  &s_sub_t[qi]);
            write_block_txb(c, 0, qr, qc, ts_y - 1, size, size, wmode,
                            0, &s_sub_t[qi]);
            tpu_commit_recon(c, 0, qr, qc, ts_y - 1, wqpred,
                             &s_sub_t[qi]);
            c->dist_acc += s_sub_t[qi].sse;
        }
    } else {
        if (c->noise_norm && s_ty.eob)
            noise_norm_commit(c, r, c4, ts_y, s_pred_y, &s_ty);
        write_block_txb(c, 0, r, c4, ts_y, size, size, wmode, 0, &s_ty);
        tpu_commit_recon(c, 0, r, c4, ts_y, s_pred_y, &s_ty);
        c->dist_acc += s_ty.sse;
    }
    write_block_txb(c, 1, cr, cc, ts_c, size >> 1, size >> 1, y_mode, 0,
                    &s_tu);
    tpu_commit_recon(c, 1, cr, cc, ts_c, s_pred_u, &s_tu);
    write_block_txb(c, 2, cr, cc, ts_c, size >> 1, size >> 1, y_mode, 0,
                    &s_tv);
    tpu_commit_recon(c, 2, cr, cc, ts_c, s_pred_v, &s_tv);
    c->dist_acc += s_tu.sse + s_tv.sse;
    intra_update_rows(c, r, c4, aw4, lh4, y_mode, uv_mode, skip);
    PROF_MARK(5);
}

void tpu_intra_block(TpuCommit *c, int r, int c4, int size,
                     const uint8_t *cand_modes, int q, int frame_is_intra,
                     int *out_skip) {
    IntraChoice ch;
    intra_trial(c, r, c4, size, cand_modes, q, frame_is_intra, &ch);
    *out_skip = ch.skip;
    intra_write_commit(c, r, c4, size, &ch, frame_is_intra);
}

void tpu_intra_trial_only(TpuCommit *c, int r, int c4, int size,
                          const uint8_t *cand_modes, int q,
                          double *cost, int *y_mode, int *uv_mode,
                          int *skip) {
    IntraChoice ch;
    intra_trial(c, r, c4, size, cand_modes, q, 0, &ch);
    *cost = ch.cost;
    *y_mode = ch.y_mode;
    *uv_mode = ch.uv_mode;
    *skip = ch.skip;
}
void tpu_intra_commit_choice(TpuCommit *c, int r, int c4, int size,
                             int y_mode, int uv_mode, int skip) {
    IntraChoice ch;
    memset(&ch, 0, sizeof(ch));
    ch.y_mode = y_mode;
    ch.uv_mode = uv_mode;
    ch.skip = skip;
    ch.cfl_js = -1;
    intra_write_commit(c, r, c4, size, &ch, 0);
}

/* ---- intra partition walk ---------------------------------------------- */
static void encode_block_intra_frame(TpuCommit *c, int r, int c4, int size,
                                     const uint8_t *mode_map, int mode_cols,
                                     int q, int *dq_pending, int *prev_q,
                                     int dq_res_log2) {
    const uint8_t *cand_modes =
        mode_map + (((r * 4) / size) * mode_cols + (c4 * 4) / size) *
                       N_MODE_CANDS;
    IntraChoice ch;
    intra_trial(c, r, c4, size, cand_modes, q, 1, &ch);
    int skip_ctx = c->above_skip[c4] + c->left_skip[r];
    tpuec_symbol(c->ec, ch.skip, c->mc->skip + skip_ctx * 3, 2, 1);
    if (*dq_pending && !(size == 64 && ch.skip)) {
        int delta = (q - *prev_q) >> dq_res_log2;
        tpu_write_delta_q(c, delta < 0 ? -delta : delta, delta < 0);
        *prev_q = q;
        *dq_pending = 0;
    }
    intra_write_commit(c, r, c4, size, &ch, 1);
}

static void walk_partition(TpuCommit *c, int r, int c4, int size,
                           const uint8_t *split64, const uint8_t *split32,
                           const uint8_t *split16, const uint8_t *mode64,
                           const uint8_t *mode32, const uint8_t *mode16,
                           const uint8_t *mode8, int ncols64, int ncols32,
                           int ncols16, int ncols8, int q, int *dq_pending,
                           int *prev_q, int dq_res_log2) {
    if (r >= c->mi_rows || c4 >= c->mi_cols) return;
    int w4 = size / 4;
    int has_rows = r + (w4 >> 1) < c->mi_rows;
    int has_cols = c4 + (w4 >> 1) < c->mi_cols;
    int forced = !(has_rows && has_cols) && size > 8;
    int split = 0;
    if (size > 8) {
        const uint8_t *sm = size == 64 ? split64
                            : size == 32 ? split32 : split16;
        int nc = size == 64 ? ncols64 : size == 32 ? ncols32 : ncols16;
        split = forced || sm[((r * 4) / size) * nc + (c4 * 4) / size];
    }
    IntraChoice pre;
    int have_pre = 0;
    if (!split && size > 8) {
        /* residual-quality partition override: the device split tree
         * scores prediction SAD only, which is blind to residual
         * CODING quality — an isolated sharp feature (glyph/text) has
         * the same SAD at every size, so the tree never splits, and a
         * large transform (TX_64 zero-out, steep large-TX QM bands)
         * destroys it. Trial the block first; when its distortion
         * lands far above the quantization-noise floor (expected
         * ~npx*step^2/12 for residual the TX can represent), the big
         * transform is failing the content — code a SPLIT instead and
         * recurse (the reference's partition RD reaches the same
         * outcome through full nsq cost comparison,
         * ref product_coding_loop.c md_stage partition costs). */
        const uint8_t *mm = size == 64 ? mode64
                            : size == 32 ? mode32 : mode16;
        int nc = size == 64 ? ncols64
                 : size == 32 ? ncols32 : ncols16;
        const uint8_t *cand =
            mm + (((r * 4) / size) * nc + (c4 * 4) / size) * N_MODE_CANDS;
        intra_trial(c, r, c4, size, cand, q, 1, &pre);
        have_pre = 1;
        const int32_t *pq = pq_of(c, q, 0);
        double step = (double)pq[9] / 8.0;   /* AC qstep, pixel units */
        double npx = (double)size * size;
        if ((double)pre.ydist > npx * step * step * 0.5) {
            split = 1;
            have_pre = 0;
        }
    }
    if (split) {
        tpu_write_partition(c, r, c4, size, 3);
        int h4 = w4 >> 1;
        walk_partition(c, r, c4, size / 2, split64, split32, split16,
                       mode64, mode32, mode16, mode8, ncols64, ncols32,
                       ncols16, ncols8, q, dq_pending, prev_q, dq_res_log2);
        walk_partition(c, r, c4 + h4, size / 2, split64, split32, split16,
                       mode64, mode32, mode16, mode8, ncols64, ncols32,
                       ncols16, ncols8, q, dq_pending, prev_q, dq_res_log2);
        walk_partition(c, r + h4, c4, size / 2, split64, split32, split16,
                       mode64, mode32, mode16, mode8, ncols64, ncols32,
                       ncols16, ncols8, q, dq_pending, prev_q, dq_res_log2);
        walk_partition(c, r + h4, c4 + h4, size / 2, split64, split32,
                       split16, mode64, mode32, mode16, mode8, ncols64,
                       ncols32, ncols16, ncols8, q, dq_pending, prev_q,
                       dq_res_log2);
        return;
    }
    tpu_write_partition(c, r, c4, size, 0);
    if (have_pre) {
        /* commit the probe trial (trial state is still live: no other
         * trial ran since) */
        int skip_ctx = c->above_skip[c4] + c->left_skip[r];
        tpuec_symbol(c->ec, pre.skip, c->mc->skip + skip_ctx * 3, 2, 1);
        if (*dq_pending && !(size == 64 && pre.skip)) {
            int delta = (q - *prev_q) >> dq_res_log2;
            tpu_write_delta_q(c, delta < 0 ? -delta : delta, delta < 0);
            *prev_q = q;
            *dq_pending = 0;
        }
        intra_write_commit(c, r, c4, size, &pre, 1);
    } else {
        const uint8_t *mm = size == 64 ? mode64
                            : size == 32 ? mode32
                            : size == 16 ? mode16 : mode8;
        int nc = size == 64 ? ncols64
                 : size == 32 ? ncols32
                 : size == 16 ? ncols16 : ncols8;
        encode_block_intra_frame(c, r, c4, size, mm, nc, q, dq_pending,
                                 prev_q, dq_res_log2);
    }
    tpu_update_part_ctx(c, r, c4, size);
}

int64_t tpuc_encode_intra(TpuCommit *c, TpuEc *ec, ModeCdfs *mc,
                          TxbCdfs *tc, const uint8_t *split64,
                          const uint8_t *split32, const uint8_t *split16,
                          const uint8_t *mode64, const uint8_t *mode32,
                          const uint8_t *mode16, const uint8_t *mode8,
                          const int16_t *sbq, int dq_res_log2, int base_q,
                          int mi_row0, int mi_row1, int mi_col0, int mi_col1,
                          int n_cands) {
    c->n_cands = n_cands > 0 ? n_cands : 1;
    c->ec = ec;
    c->mc = mc;
    c->tc = tc;
    c->dist_acc = 0;
    if (mi_row1 <= 0) mi_row1 = c->mi_rows;
    if (mi_col1 <= 0) mi_col1 = c->mi_cols;
    c->t_mi_row0 = mi_row0;
    c->t_mi_row1 = mi_row1;
    c->t_mi_col0 = mi_col0;
    c->t_mi_col1 = mi_col1;
    int paw4;
    {
        int aw = c->mi_cols * 4;
        paw4 = ((aw + 63) & ~63);
    }
    int ncols64 = paw4 / 64, ncols32 = paw4 / 32, ncols16 = paw4 / 16,
        ncols8 = paw4 / 8;
    int prev_q = base_q;
    int nsb_c = (c->mi_cols + 15) / 16;
    tpu_lr_reset_refs(c);
    for (int sbr = mi_row0; sbr < mi_row1; sbr += 16) {
        for (int sbc = mi_col0; sbc < mi_col1; sbc += 16) {
            tpu_bd_reset_sb(c, sbr, sbc);
            tpu_write_lr_sb(c, sbr, sbc);
            int q = sbq ? sbq[(sbr / 16) * nsb_c + sbc / 16] : base_q;
            c->cur_q = q;
            {
                const int32_t *pq = pq_of(c, q, 0);
                c->rdmult = tpu_lambda_for_q(c, pq, q, base_q);
            }
            int dq_pending = dq_res_log2 >= 0;
            walk_partition(c, sbr, sbc, 64, split64, split32, split16,
                           mode64, mode32, mode16, mode8, ncols64, ncols32,
                           ncols16, ncols8, q, &dq_pending, &prev_q,
                           dq_res_log2);
        }
    }
    return c->dist_acc;
}
