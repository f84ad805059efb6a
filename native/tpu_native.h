/* Shared declarations for the native host backend (.so built from
 * ec_backend.c + txfm_backend.c + commit_backend.c).
 *
 * The native layer implements the serial, context-dependent parts of the
 * encoder (range coding, normative per-txb transforms, and the frame commit
 * walk) that the device search cannot express efficiently; the dense
 * search runs on device (ops/jax_backend.py) and hands decisions to
 * commit_backend.c. Reference counterparts: Source/Lib/Codec/ec_process.c
 * (entropy), coding_loop.c (encode pass), bitstream_unit.c (od_ec).
 */
#ifndef TPU_NATIVE_H
#define TPU_NATIVE_H

#include <stdint.h>

/* ---- range coder (ec_backend.c) ---------------------------------------- */
typedef struct {
    uint32_t low;
    uint16_t rng;
    int32_t cnt;
    uint16_t *precarry;
    int32_t n_precarry;
    int32_t cap_precarry;
} TpuEc;

TpuEc *tpuec_new(void);
void tpuec_free(TpuEc *ec);
void tpuec_symbol(TpuEc *ec, int s, uint16_t *icdf, int nsyms, int adapt);
void tpuec_bool(TpuEc *ec, int val, unsigned f);
void tpuec_literal(TpuEc *ec, int value, int bits);
int tpuec_tell_bits(const TpuEc *ec);
int tpuec_done(TpuEc *ec, uint8_t *out, int cap);
int tpuec_cost_symbol(const uint16_t *icdf, int nsyms, int s);

/* coefficient CDF pointers into Python-owned numpy arrays (uint16). */
typedef struct {
    uint16_t *eob_flag16;    /* [2][2][6]  */
    uint16_t *eob_flag32;    /* [2][2][7]  */
    uint16_t *eob_flag64;    /* [2][2][8]  */
    uint16_t *eob_flag128;   /* [2][2][9]  */
    uint16_t *eob_flag256;   /* [2][2][10] */
    uint16_t *eob_flag512;   /* [2][2][11] */
    uint16_t *eob_flag1024;  /* [2][2][12] */
    uint16_t *eob_extra;     /* [5][2][22][3] */
    uint16_t *coeff_base_eob;/* [5][2][4][4] */
    uint16_t *coeff_base;    /* [5][2][42][5] */
    uint16_t *coeff_br;      /* [4][2][21][5] */
    uint16_t *dc_sign;       /* [2][3][3] */
} TxbCdfs;

int tpuec_encode_txb(TpuEc *ec, TxbCdfs *cdfs, const int32_t *qcoeff,
                     const int16_t *scan, int n, int w, int h, int rw, int rh,
                     int ems, int txs_ctx, int tx_class, int ptype,
                     int sign_ctx);
int tpuec_cost_txb_eob(TxbCdfs *cdfs, const int32_t *qcoeff,
                       const int16_t *scan, int eob, int w, int h,
                       int rw, int rh, int ems, int txs_ctx, int tx_class,
                       int ptype, int sign_ctx);
int tpuec_cost_txb(TxbCdfs *cdfs, const int32_t *qcoeff,
                   const int16_t *scan, int n, int w, int h, int rw, int rh,
                   int ems, int txs_ctx, int tx_class, int ptype,
                   int sign_ctx);

/* ---- transforms / quant (txfm_backend.c) ------------------------------- */
void tputx_fwd2d(const int32_t *residual, int32_t *coeff, int tx_size,
                 int tx_type, int bd);
void tputx_inv2d(const int32_t *coeff, int32_t *resid, int tx_size,
                 int tx_type, int bd);
void tputx_quantize_b(const int32_t *coeff, int32_t *qc, int32_t *dqc,
                      int n, int log_scale, int zbin0, int zbin1, int rnd0,
                      int rnd1, int quant0, int quant1, int qs0, int qs1,
                      int dq0, int dq1);
void tputx_quantize_b_qm(const int32_t *coeff, int32_t *qc, int32_t *dqc,
                         int n, int log_scale, int zbin0, int zbin1,
                         int rnd0, int rnd1, int quant0, int quant1,
                         int qs0, int qs1, int dq0, int dq1,
                         const int32_t *wt, const int32_t *iwt);

/* ---- commit engine (commit_backend.c) ---------------------------------- */

/* mode/partition CDF pointers into FrameContext numpy arrays (uint16). */
typedef struct {
    uint16_t *partition;    /* [20][11] */
    uint16_t *skip;         /* [3][3] */
    uint16_t *kf_y;         /* [5][5][14] */
    uint16_t *angle_delta;  /* [8][8] */
    uint16_t *uv_mode;      /* [2][13][15] */
    uint16_t *intra_ext_tx; /* [3][4][13][17] */
    uint16_t *delta_q;      /* [5] */
    uint16_t *tx_size;      /* [4][3][4] */
    uint16_t *txb_skip;     /* [5][13][3] */
    uint16_t *wiener_restore;     /* [3] */
    uint16_t *sgrproj_restore;    /* [3] */
    uint16_t *switchable_restore; /* [4] */
    uint16_t *cfl_sign;           /* [9] */
    uint16_t *cfl_alpha;          /* [6][17] */
    uint16_t *filter_intra;       /* [22][3] */
    uint16_t *filter_intra_mode;  /* [6] */
} ModeCdfs;

/* inter-frame CDF pointers into FrameContext numpy arrays (uint16). */
typedef struct {
    uint16_t *y_mode;       /* [4][14]   (size-group keyed, inter frames) */
    uint16_t *intra_inter;  /* [4][3] */
    uint16_t *single_ref;   /* [3][6][3] */
    uint16_t *newmv;        /* [6][3] */
    uint16_t *zeromv;       /* [2][3] */
    uint16_t *refmv;        /* [6][3] */
    uint16_t *drl;          /* [3][3] */
    uint16_t *nmv_joints;   /* [5] */
    uint16_t *inter_ext_tx; /* [4][4][17] */
    /* compound prediction syntax */
    uint16_t *comp_inter;           /* [5][3] */
    uint16_t *comp_ref_type;        /* [5][3] */
    uint16_t *comp_ref;             /* [3][3][3] */
    uint16_t *comp_bwdref;          /* [3][2][3] */
    uint16_t *inter_compound_mode;  /* [8][9] */
    uint16_t *skip_mode;            /* [3][3] */
    uint16_t *switchable_interp;    /* [16][4] */
    uint16_t *comp_group_idx;       /* [6][3] */
    uint16_t *compound_type;        /* [22][3] */
    uint16_t *wedge_idx;            /* [22][17] */
    uint16_t *obmc;                 /* [22][3] (motion-mode OBMC flag) */
    uint16_t *motion_mode;          /* [22][4] (SIMPLE/OBMC/WARPED) */
    /* inter-intra (spec 5.11.28) */
    uint16_t *interintra;           /* [4][3]  (size-group keyed) */
    uint16_t *interintra_mode;      /* [4][5] */
    uint16_t *wedge_interintra;     /* [22][3] */
    /* nmv per-component families (comp 0 = row, 1 = col) */
    uint16_t *sign[2];      /* [3] */
    uint16_t *classes[2];   /* [12] */
    uint16_t *class0[2];    /* [3] */
    uint16_t *bits[2];      /* [10][3] */
    uint16_t *class0_fp[2]; /* [2][5] */
    uint16_t *fp[2];        /* [5] */
    uint16_t *class0_hp[2]; /* [3] */
    uint16_t *hp[2];        /* [3] */
    /* inter var-tx (TX_MODE_SELECT; spec 5.11.16 txfm_split) */
    uint16_t *txfm_partition; /* [21][3] */
} InterCdfs;

typedef struct TpuCommit TpuCommit;

TpuCommit *tpuc_new(int width, int height, int bd);
void tpuc_free(TpuCommit *c);
void tpuc_set_src(TpuCommit *c, const uint16_t *y, const uint16_t *u,
                  const uint16_t *v, int ystride, int cstride);
void tpuc_set_qtab(TpuCommit *c, const int32_t *qtab /* [256][3][10] */);
void tpuc_set_qm(TpuCommit *c,
                 const int32_t *wt_y, const int32_t *iwt_y,
                 const int32_t *wt_u, const int32_t *iwt_u,
                 const int32_t *wt_v, const int32_t *iwt_v);
void tpuc_attach_planes(TpuCommit *c, uint16_t *y, uint16_t *u, uint16_t *v,
                        int ystride, int cstride);
uint16_t *tpuc_plane(TpuCommit *c, int plane, int *stride);

/* native phase profiler (SVT_NATIVE_PROF=1): ns accumulators
 * [fwd, quant, rate, inv, predict, commit+ec, trial_total, spare] */
void tpuc_prof_reset(void);
void tpuc_prof_get(long long *out8);
void tpuc_attach_lfmaps(TpuCommit *c, uint8_t *txdim_y, uint8_t *txdim_uv,
                        int ystride, int cstride);
void tpuc_attach_skipmap(TpuCommit *c, uint8_t *skip, int stride);
void tpuc_set_psy_rd(TpuCommit *c, double strength);

/* ---- loop-restoration syntax (lr_syntax.c) ----------------------------- */
/* Arm read_lr emission for the next walk. ftype/usize/ucols/urows are
 * int32[3] per plane; units are per-plane [urows*ucols][10] int16 rows:
 * {type, vtap0..2, htap0..2, ep, xqd0, xqd1}. NULL ftype disables. */
void tpuc_set_lr(TpuCommit *c, const int32_t *ftype, const int32_t *usize,
                 const int16_t *u0, const int16_t *u1, const int16_t *u2,
                 const int32_t *ucols, const int32_t *urows);
void tpu_lr_reset_refs(TpuCommit *c);
void tpu_write_lr_sb(TpuCommit *c, int sbr, int sbc);

/* ---- CDEF (cdef_backend.c) --------------------------------------------- */
void tpue_cdef(uint16_t *py, int ys, uint16_t *pu, uint16_t *pv, int cs,
               const uint16_t *iny, const uint16_t *inu,
               const uint16_t *inv,
               const uint16_t *sy, int sys, const uint16_t *su,
               const uint16_t *sv, int scs, const uint8_t *skip,
               int mi_rows, int mi_cols, int skip_stride, int w, int h,
               int bd, int damping, int y_pri, int y_sec, int uv_pri,
               int uv_sec, int apply, int sample, int fbr0, int fbr1,
               double *sse_out);
void tpue_cdef_unit_sse(const uint16_t *iny, int ys, const uint16_t *inu,
                        const uint16_t *inv, int cs, const uint16_t *sy,
                        int sys, const uint16_t *su, const uint16_t *sv,
                        int scs, const uint8_t *skip, int mi_rows,
                        int mi_cols, int skip_stride, int w, int h, int bd,
                        int damping, const int *ycand, int ky,
                        const int *ccand, int kc, int sample, int fbr0,
                        int fbr1, double *ssey_out, double *ssec_out,
                        uint8_t *has_out);
void tpue_cdef_apply_idx(uint16_t *py, int ys, uint16_t *pu, uint16_t *pv,
                         int cs, const uint16_t *iny, const uint16_t *inu,
                         const uint16_t *inv, const uint8_t *skip,
                         int mi_rows, int mi_cols, int skip_stride, int w,
                         int h, int bd, int damping, const int *ylist,
                         const int *clist, const uint8_t *idx_map,
                         int fbr0, int fbr1);

/* ---- deblocking filter (dlf_backend.c) --------------------------------- */
/* w/h: plane-space DISPLAY dims bounding which mi units filter
 * (spec 7.14.1); 0 = unbounded (mi grid) */
void tpud_apply_plane(uint16_t *img, int stride, const uint8_t *txdim,
                      int map_stride, int rows, int cols, int is_luma,
                      int level_v, int level_h, int sharpness, int bd,
                      int w, int h);
double tpud_try_level(const uint16_t *img, int stride, const uint16_t *src,
                      int sstride, uint16_t *scratch, const uint8_t *txdim,
                      int map_stride, int rows, int cols, int is_luma,
                      int level, int sharpness, int bd, int w, int h);
void tpuc_upload_scan(int tx_size, int tx_type, const int16_t *scan, int n);
void tpuc_upload_dr(const int32_t *dr /* [90] */);

/* Encode one KEY/intra frame tile (single tile) given device decisions.
 * split{64,32,16}: row-major uint8 maps over the block grids (1 = split).
 * mode{64,32,16,8}: best y mode per block (PredMode 0..12).
 * sbq: per-SB qindex (int16, base_q everywhere when delta-q off);
 * dq_res_log2 < 0 disables delta-q syntax. Returns total bits << 3. */
int64_t tpuc_encode_intra(TpuCommit *c, TpuEc *ec, ModeCdfs *mc,
                          TxbCdfs *tc, const uint8_t *split64,
                          const uint8_t *split32, const uint8_t *split16,
                          const uint8_t *mode64, const uint8_t *mode32,
                          const uint8_t *mode16, const uint8_t *mode8,
                          const int16_t *sbq, int dq_res_log2, int base_q,
                          int mi_row0, int mi_row1, int mi_col0, int mi_col1,
                          int n_cands);

/* P-frame walk (inter_backend.c): split maps + intra candidate maps as in
 * tpuc_encode_intra, plus a per-16x16 full-pel MV seed map from the device
 * HME stage. The reference recon is set via tpuc_set_ref. */
void tpuc_set_ref(TpuCommit *c, const uint16_t *y, const uint16_t *u,
                  const uint16_t *v, int ystride, int cstride);
/* LAST-ref TRANSLATION global MV (1/8 px, precision-lowered); the walk
 * uses it as the GLOBALMV candidate and the under-full MV-stack fill. */
void tpuc_set_gm(TpuCommit *c, int mv8_r, int mv8_c);
int64_t tpuc_encode_inter(TpuCommit *c, TpuEc *ec, ModeCdfs *mc,
                          TxbCdfs *tc, InterCdfs *ic,
                          const uint8_t *split64, const uint8_t *split32,
                          const uint8_t *split16, const uint8_t *mode64,
                          const uint8_t *mode32, const uint8_t *mode16,
                          const uint8_t *mode8, const int16_t *mv16,
                          const int16_t *mv16b,
                          int mv16_cols, const int16_t *sbq,
                          int dq_res_log2, int base_q, int mi_row0,
                          int mi_row1, int mi_col0, int mi_col1,
                          int n_cands);
/* Compound (bidirectional) prediction wiring: second reference planes
 * + frame-level skip-mode allowance and RefFrameSignBias. mv16b is the
 * per-16x16 HME seed field against the second reference (or NULL). */
void tpuc_set_ref2(TpuCommit *c, const uint16_t *y, const uint16_t *u,
                   const uint16_t *v, int ystride, int cstride);
void tpuc_set_compound(TpuCommit *c, int skip_mode_present,
                       const uint8_t *sign_bias8, int masked);
/* Normative wedge master masks for bsize 8x8/16x16/32x32 (which =
 * 0/1/2): 16 idx x 2 signs x n*n, from inter/masks.py. */
void tpuc_upload_wedge(int which, const int32_t *masks, int n);
/* TX_MODE_SELECT for the intra walk: per-block depth-1 TX split search
 * + tx_size signalling (frame header must code tx_mode_select = 1). */
void tpuc_set_tx_select(TpuCommit *c, int enable);
void tpuc_set_allow_hp(TpuCommit *c, int enable);
/* Motion-mode search: when enabled the walk trials OBMC_CAUSAL (and
 * WARPED_CAUSAL when allow_warp) on eligible single-ref blocks and
 * writes the motion-mode symbol (frame header must set
 * is_motion_mode_switchable / allow_warped_motion accordingly). */
void tpuc_set_obmc(TpuCommit *c, int enable, int allow_warp);
void tpuc_set_interintra(TpuCommit *c, int enable);
void tpuc_set_cfl(TpuCommit *c, int enable);
void tpuc_set_filter_intra(TpuCommit *c, int enable);
void tpuc_upload_fi(const int32_t *taps /* [5][8][8] */);
void tpuc_upload_ii(int mode, int size_idx, const int32_t *mask, int n);
/* Normative warp constants (spec 7.11.3.5 Warp_Filter [193][8] and
 * 7.11.3.7 Div_Lut [257]), uploaded once from python. */
void tpuc_upload_warp(const int32_t *wf193x8, const int32_t *div_lut257);
/* MFMV (spec 7.9/7.10.2 temporal candidates): attach the projected
 * motion field (mv/off/valid over (n8r, n8c) 8x8 units) + per-ref-id
 * cur-to-ref distances. NULL mv disables. Pointers must stay valid
 * through tpuc_encode_inter. */
void tpuc_set_tpl(TpuCommit *c, const int16_t *mv, const int16_t *off,
                  const uint8_t *valid, int n8r, int n8c,
                  const int32_t *cur_off8, int allow_hp);
/* Export the last encoded frame's per-mi motion info (mi_rows*mi_cols;
 * mv arrays *2) for spec 7.20 motion-field storage. Returns 0 when no
 * grid is live. */
int tpuc_grid_read(TpuCommit *c, int8_t *ref0, int8_t *ref1, int16_t *mv0,
                   int16_t *mv1);

#endif /* TPU_NATIVE_H */
