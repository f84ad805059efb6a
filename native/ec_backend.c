/* Native entropy-coding backend: od_ec range encoder + AV1 transform-block
 * symbol encoding with normative context derivation.
 *
 * Architecture note (SURVEY.md §7): the arithmetic coder is the
 * one inherently serial per-tile component; the reference implements it in
 * C (Source/Lib/Codec/bitstream_unit.c) and so do we. CDF tables live in
 * numpy arrays owned by Python (uint16, C-contiguous); this code adapts them
 * in place so the Python writer and this backend are interchangeable
 * mid-stream.
 *
 * Semantics mirror svt_av1_psy_tpu/entropy/{range_coder,coeff_coder}.py,
 * which are golden-tested bit-exact against the reference encoder.
 */

#include <stdint.h>
#include <stdlib.h>
#include <stdio.h>
#include <string.h>

#define PROB_TOP 32768
#define EC_PROB_SHIFT 6
#define EC_MIN_PROB 4
#define TX_PAD_HOR 4
#define NUM_BASE_LEVELS 2
#define COEFF_BASE_RANGE 12
#define BR_CDF_SIZE 4
#define COEFF_CONTEXT_BITS 6
#define COEFF_CONTEXT_MASK 63

typedef struct {
    uint32_t low;
    uint16_t rng;
    int32_t cnt;
    uint16_t *precarry;
    int32_t n_precarry;
    int32_t cap_precarry;
} TpuEc;

/* ---- core range coder ---------------------------------------------------*/

TpuEc *tpuec_new(void) {
    TpuEc *ec = (TpuEc *)calloc(1, sizeof(TpuEc));
    ec->low = 0;
    ec->rng = 0x8000;
    ec->cnt = -9;
    ec->cap_precarry = 1 << 16;
    ec->precarry = (uint16_t *)malloc(sizeof(uint16_t) * ec->cap_precarry);
    ec->n_precarry = 0;
    return ec;
}

void tpuec_free(TpuEc *ec) {
    if (ec) {
        free(ec->precarry);
        free(ec);
    }
}

static void ec_grow(TpuEc *ec) {
    if (ec->n_precarry + 2 >= ec->cap_precarry) {
        ec->cap_precarry *= 2;
        ec->precarry = (uint16_t *)realloc(
            ec->precarry, sizeof(uint16_t) * ec->cap_precarry);
    }
}

static int ilog(uint32_t v) {
    int n = 0;
    while (v) {
        v >>= 1;
        n++;
    }
    return n;
}

static void ec_normalize(TpuEc *ec, uint32_t low, unsigned rng) {
    int d = 16 - ilog(rng);
    int c = ec->cnt;
    int s = c + d;
    if (s >= 0) {
        unsigned m;
        ec_grow(ec);
        c += 16;
        m = (1u << c) - 1;
        if (s >= 8) {
            ec->precarry[ec->n_precarry++] = (uint16_t)(low >> c);
            low &= m;
            c -= 8;
            m >>= 8;
        }
        ec->precarry[ec->n_precarry++] = (uint16_t)(low >> c);
        s = c + d - 24;
        low &= m;
    }
    ec->low = low << d;
    ec->rng = (uint16_t)(rng << d);
    ec->cnt = s;
}

static void ec_q15(TpuEc *ec, unsigned fl, unsigned fh, int s, int nsyms) {
    uint32_t l = ec->low;
    unsigned r = ec->rng;
    int n = nsyms - 1;
    if (fl < PROB_TOP) {
        unsigned u = ((r >> 8) * (fl >> EC_PROB_SHIFT) >>
                      (7 - EC_PROB_SHIFT)) + EC_MIN_PROB * (n - (s - 1));
        unsigned v = ((r >> 8) * (fh >> EC_PROB_SHIFT) >>
                      (7 - EC_PROB_SHIFT)) + EC_MIN_PROB * (n - s);
        l += r - u;
        r = u - v;
    } else {
        r -= ((r >> 8) * (fh >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) +
             EC_MIN_PROB * (n - s);
    }
    ec_normalize(ec, l, r);
}

static void cdf_update(uint16_t *icdf, int val, int nsymbs) {
    int count = icdf[nsymbs];
    int speed = nsymbs < 2 ? 0 : (nsymbs < 4 ? 1 : 2);
    int rate = 3 + (count > 15) + (count > 31) + speed;
    int tmp = PROB_TOP;
    int i;
    for (i = 0; i < nsymbs - 1; i++) {
        if (i == val) tmp = 0;
        if (tmp < icdf[i])
            icdf[i] -= (uint16_t)((icdf[i] - tmp) >> rate);
        else
            icdf[i] += (uint16_t)((tmp - icdf[i]) >> rate);
    }
    if (count < 32) icdf[nsymbs] = (uint16_t)(count + 1);
}

/* debug EC log (SVT_EC_LOG=<path>): one "s cdf0 cdf1 cdf2" line per
 * coded symbol — diffable against the python tile parser's trace for
 * encoder/decoder context-divergence hunts. Single-tile runs only. */
static FILE *g_eclog;
static int g_eclog_init;

static void eclog_sym(int s, const uint16_t *icdf, int nsyms) {
    if (!g_eclog_init) {
        g_eclog_init = 1;
        const char *p = getenv("SVT_EC_LOG");
        if (p && *p) g_eclog = fopen(p, "w");
    }
    if (g_eclog)
        fprintf(g_eclog, "%d %u %u %u\n", s, icdf[0],
                nsyms > 1 ? icdf[1] : 0, nsyms > 2 ? icdf[2] : 0);
}

void tpuec_symbol(TpuEc *ec, int s, uint16_t *icdf, int nsyms, int adapt) {
    unsigned fl = s == 0 ? PROB_TOP : icdf[s - 1];
    unsigned fh = icdf[s];
    eclog_sym(s, icdf, nsyms);
    ec_q15(ec, fl, fh, s, nsyms);
    if (adapt) cdf_update(icdf, s, nsyms);
}

void tpuec_bool(TpuEc *ec, int val, unsigned f) {
    uint32_t l = ec->low;
    unsigned r = ec->rng;
    unsigned v = ((r >> 8) * (f >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) +
                 EC_MIN_PROB;
    if (val) {
        l += r - v;
        r = v;
    } else {
        r -= v;
    }
    ec_normalize(ec, l, r);
}

void tpuec_literal(TpuEc *ec, int value, int bits) {
    int i;
    for (i = bits - 1; i >= 0; i--) tpuec_bool(ec, (value >> i) & 1, 16384);
}

static void ec_golomb(TpuEc *ec, int value) {
    int x = value + 1;
    int length = ilog((uint32_t)x);
    int i;
    for (i = 0; i < length - 1; i++) tpuec_bool(ec, 0, 16384);
    for (i = length - 1; i >= 0; i--) tpuec_bool(ec, (x >> i) & 1, 16384);
}

int tpuec_tell_bits(const TpuEc *ec) {
    return ec->cnt + 10 + ec->n_precarry * 8;
}

/* Flush; returns number of bytes written to out (cap must be generous). */
int tpuec_done(TpuEc *ec, uint8_t *out, int cap) {
    uint32_t l = ec->low;
    int c = ec->cnt;
    int s = 10;
    uint32_t m = 0x3FFF;
    uint32_t e = ((l + m) & ~m) | (m + 1);
    int n_pre = ec->n_precarry;
    uint16_t *pre;
    int i, carry, total;
    s += c;
    /* worst case few extra entries */
    pre = (uint16_t *)malloc(sizeof(uint16_t) * (n_pre + 8));
    memcpy(pre, ec->precarry, sizeof(uint16_t) * n_pre);
    if (s > 0) {
        uint32_t n = (1u << (c + 16)) - 1;
        do {
            pre[n_pre++] = (uint16_t)((e >> (c + 16)) & 0xFFFF);
            e &= n;
            s -= 8;
            c -= 8;
            n >>= 8;
        } while (s > 0);
    }
    if (n_pre > cap) {
        free(pre);
        return -1;
    }
    carry = 0;
    for (i = n_pre - 1; i >= 0; i--) {
        int v = pre[i] + carry;
        out[i] = (uint8_t)(v & 0xFF);
        carry = v >> 8;
    }
    total = n_pre;
    free(pre);
    return total;
}

/* ---- coefficient txb encoding ------------------------------------------ */

typedef struct {
    /* all pointers into Python-owned numpy arrays (uint16, contiguous) */
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

static int base_ctx_2d_offset(int row, int col, int rw, int rh) {
    if (row == 0 && col == 0) return 0;
    if (rw < rh && row < 2) return 11;
    if (rw > rh && col < 2) return 16;
    if (row + col < 2) return 1;
    if (row + col < 4) return 6;
    return 21;
}

#define C3(x) ((x) > 3 ? 3 : (x))

static int lower_levels_ctx(const uint8_t *lv, int stride, int row, int col,
                            int tx_class, int rw, int rh) {
    const uint8_t *p = lv + row * stride + col;
    int mag, ctx, pos;
    if (tx_class == 0) {
        mag = C3(p[1]) + C3(p[stride]) + C3(p[stride + 1]) + C3(p[2]) +
              C3(p[2 * stride]);
        ctx = (mag + 1) >> 1;
        if (ctx > 4) ctx = 4;
        if (row == 0 && col == 0) return 0;
        return ctx + base_ctx_2d_offset(row, col, rw, rh);
    }
    if (tx_class == 1) {
        mag = C3(p[1]) + C3(p[stride]) + C3(p[2]) + C3(p[3]) + C3(p[4]);
        pos = col;
    } else {
        mag = C3(p[1]) + C3(p[stride]) + C3(p[2 * stride]) +
              C3(p[3 * stride]) + C3(p[4 * stride]);
        pos = row;
    }
    ctx = (mag + 1) >> 1;
    if (ctx > 4) ctx = 4;
    if (pos == 0) return ctx + 26;
    if (pos == 1) return ctx + 31;
    return ctx + 36;
}

static int br_context(const uint8_t *lv, int stride, int row, int col,
                      int tx_class) {
    const uint8_t *p = lv + row * stride + col;
    int mag = p[1] + p[stride];
    if (tx_class == 0) {
        mag += p[stride + 1];
        mag = (mag + 1) >> 1;
        if (mag > 6) mag = 6;
        if (row == 0 && col == 0) return mag;
        if (row < 2 && col < 2) return mag + 7;
    } else if (tx_class == 1) {
        mag += p[2];
        mag = (mag + 1) >> 1;
        if (mag > 6) mag = 6;
        if (row == 0 && col == 0) return mag;
        if (col == 0) return mag + 7;
    } else {
        mag += p[2 * stride];
        mag = (mag + 1) >> 1;
        if (mag > 6) mag = 6;
        if (row == 0 && col == 0) return mag;
        if (row == 0) return mag + 7;
    }
    return mag + 14;
}

static int eob_ctx_of(int scan_idx, int n) {
    if (scan_idx == 0) return 0;
    if (scan_idx <= n / 8) return 1;
    if (scan_idx <= n / 4) return 2;
    return 3;
}

/* Encode one txb's post-skip symbols. Returns packed cul_level byte.
 * qcoeff: int32 compact (h x w) row-major; scan: int16, length n.
 * w, h: compact dims; rw, rh: original tx dims; ems: eob_multi_size;
 * txs_ctx, tx_class, ptype, sign_ctx as derived by caller. */
int tpuec_encode_txb(TpuEc *ec, TxbCdfs *cdfs, const int32_t *qcoeff,
                     const int16_t *scan, int n, int w, int h, int rw, int rh,
                     int ems, int txs_ctx, int tx_class, int ptype,
                     int sign_ctx) {
    static const int eob_syms[7] = {5, 6, 7, 8, 9, 10, 11};
    uint8_t levels_buf[(32 + 4) * (32 + TX_PAD_HOR)];
    int stride = w + TX_PAD_HOR;
    int eob = 0, i, c, eob_pt, extra, nbits, cul = 0, dc;
    uint16_t *eob_cdf_base, *cdf;

    memset(levels_buf, 0, sizeof(uint8_t) * (h + 4) * stride);
    for (i = 0; i < n; i++) {
        int pos = scan[i];
        if (qcoeff[pos]) eob = i + 1;
    }
    for (i = 0; i < h * w; i++) {
        int v = qcoeff[i] < 0 ? -qcoeff[i] : qcoeff[i];
        levels_buf[(i / w) * stride + (i % w)] =
            (uint8_t)(v > 127 ? 127 : v);
    }

    /* eob position token */
    if (eob <= 2)
        eob_pt = eob;
    else
        eob_pt = ilog((uint32_t)(eob - 1)) + 1;
    {
        int group_start = eob_pt == 1 ? 1
                          : (eob_pt == 2 ? 2 : (1 << (eob_pt - 2)) + 1);
        extra = eob - group_start;
        nbits = eob_pt < 3 ? 0 : eob_pt - 2;
    }
    {
        uint16_t *tabs[7];
        tabs[0] = cdfs->eob_flag16;
        tabs[1] = cdfs->eob_flag32;
        tabs[2] = cdfs->eob_flag64;
        tabs[3] = cdfs->eob_flag128;
        tabs[4] = cdfs->eob_flag256;
        tabs[5] = cdfs->eob_flag512;
        tabs[6] = cdfs->eob_flag1024;
        /* layout [ptype][eob_multi_ctx][nsyms+1] */
        int nsy = eob_syms[ems];
        int emc = tx_class == 0 ? 0 : 1;
        eob_cdf_base = tabs[ems] + (ptype * 2 + emc) * (nsy + 1);
        tpuec_symbol(ec, eob_pt - 1, eob_cdf_base, nsy, 1);
    }
    if (nbits > 0) {
        int hi = (extra >> (nbits - 1)) & 1;
        cdf = cdfs->eob_extra + ((txs_ctx * 2 + ptype) * 22 + eob_pt) * 3;
        tpuec_symbol(ec, hi, cdf, 2, 1);
        for (i = 1; i < nbits; i++)
            tpuec_literal(ec, (extra >> (nbits - 1 - i)) & 1, 1);
    }

    for (c = eob - 1; c >= 0; c--) {
        int pos = scan[c];
        int row = pos / w, col = pos % w;
        int v = qcoeff[pos];
        int level = v < 0 ? -v : v;
        if (c == eob - 1) {
            int ctx = eob_ctx_of(c, w * h);
            cdf = cdfs->coeff_base_eob +
                  ((txs_ctx * 2 + ptype) * 4 + ctx) * 4;
            tpuec_symbol(ec, (level > 3 ? 3 : level) - 1, cdf, 3, 1);
        } else {
            int ctx = lower_levels_ctx(levels_buf, stride, row, col,
                                       tx_class, rw, rh);
            cdf = cdfs->coeff_base + ((txs_ctx * 2 + ptype) * 42 + ctx) * 5;
            tpuec_symbol(ec, level > 3 ? 3 : level, cdf, 4, 1);
        }
        if (level > NUM_BASE_LEVELS) {
            int bctx = br_context(levels_buf, stride, row, col, tx_class);
            int txs_br = txs_ctx < 3 ? txs_ctx : 3;
            int base_range = level - 1 - NUM_BASE_LEVELS;
            int idx = 0;
            cdf = cdfs->coeff_br + ((txs_br * 2 + ptype) * 21 + bctx) * 5;
            while (idx < COEFF_BASE_RANGE) {
                int k = base_range - idx;
                if (k > BR_CDF_SIZE - 1) k = BR_CDF_SIZE - 1;
                tpuec_symbol(ec, k, cdf, BR_CDF_SIZE, 1);
                if (k < BR_CDF_SIZE - 1) break;
                idx += BR_CDF_SIZE - 1;
            }
        }
    }

    for (c = 0; c < eob; c++) {
        int pos = scan[c];
        int v = qcoeff[pos];
        int level = v < 0 ? -v : v;
        cul += level;
        if (level) {
            if (c == 0) {
                cdf = cdfs->dc_sign + (ptype * 3 + sign_ctx) * 3;
                tpuec_symbol(ec, v < 0 ? 1 : 0, cdf, 2, 1);
            } else {
                tpuec_bool(ec, v < 0 ? 1 : 0, 16384);
            }
            if (level > COEFF_BASE_RANGE + NUM_BASE_LEVELS)
                ec_golomb(ec, level - COEFF_BASE_RANGE - 1 - NUM_BASE_LEVELS);
        }
    }

    if (cul > COEFF_CONTEXT_MASK) cul = COEFF_CONTEXT_MASK;
    dc = qcoeff[scan[0]];
    if (dc < 0)
        cul |= 1 << COEFF_CONTEXT_BITS;
    else if (dc > 0)
        cul += 2 << COEFF_CONTEXT_BITS;
    return cul;
}

/* ---- rate estimation (exact CDF bit costs) ------------------------------
 * Costs in 1/512-bit units (AV1_PROB_COST_SHIFT = 9), computed from the
 * LIVE adaptive CDFs so encoder RD tracks the actual coding state.
 * Mirrors the reference's av1_cost_symbol (ref md_rate_estimation.c). */

#define PROB_COST_SHIFT 9

static int prob_cost_tab[257]; /* -log2(p/32768) << 9 for p = i<<7 */
static int prob_cost_init_done = 0;

static void prob_cost_init(void) {
    int i;
    if (prob_cost_init_done) return;
    for (i = 1; i <= 256; i++) {
        /* p = i/256; cost = -log2(p) in 1/512 bits */
        double p = (double)i / 256.0;
        prob_cost_tab[i] = (int)(0.5 - 512.0 * 1.4426950408889634 *
                                 __builtin_log(p));
    }
    prob_cost_tab[0] = prob_cost_tab[1] + 512 * 8;
    prob_cost_init_done = 1;
}

/* cost of probability mass `fr` (15-bit, 1..32768) */
static int cost_prob15(unsigned fr) {
    /* normalize to 8-bit index with shift compensation */
    int shift = 0;
    if (fr == 0) fr = 1;
    while (fr < 16384) { fr <<= 1; shift++; }
    /* fr in [16384, 32768]; index = fr >> 7 in [128, 256] */
    return prob_cost_tab[fr >> 7] + 512 * shift;
}

int tpuec_cost_symbol(const uint16_t *icdf, int nsyms, int s) {
    unsigned fl = s == 0 ? PROB_TOP : icdf[s - 1];
    unsigned fh = icdf[s];
    (void)nsyms;
    prob_cost_init();
    return cost_prob15(fl - fh);
}

static int cost_bool_half(void) { return 512; }

/* Rate of one txb's post-skip symbols with the eob ALREADY known (the
 * trial path computes it once via the inverse scan): fills the levels
 * neighborhood only for the eob-prefix scan positions and zeroes only
 * the touched rows — the per-trial cost becomes O(eob + rows-touched)
 * instead of O(n) gather scans (the reference's SIMD cost kernels get
 * the same effect from the eob-bounded loops in av1_cost_coeffs_txb,
 * ref md_rate_estimation.c). */
int tpuec_cost_txb_eob(TxbCdfs *cdfs, const int32_t *qcoeff,
                       const int16_t *scan, int eob, int w, int h,
                       int rw, int rh, int ems, int txs_ctx, int tx_class,
                       int ptype, int sign_ctx) {
    static const int eob_syms[7] = {5, 6, 7, 8, 9, 10, 11};
    uint8_t levels_buf[(32 + 4) * (32 + TX_PAD_HOR)];
    int stride = w + TX_PAD_HOR;
    int i, c, eob_pt, extra, nbits, cost = 0;
    uint16_t *cdf;

    if (eob == 0) return 0;
    prob_cost_init();
    {
        /* zero exactly the rows the ctx reads can touch (row+4 max),
         * then scatter the eob-prefix levels */
        int max_row = 0;
        for (c = 0; c < eob; c++) {
            int r = scan[c] / w;
            if (r > max_row) max_row = r;
        }
        int zrows = max_row + 5;
        if (zrows > h + 4) zrows = h + 4;
        memset(levels_buf, 0, sizeof(uint8_t) * zrows * stride);
        for (c = 0; c < eob; c++) {
            int pos = scan[c];
            int v = qcoeff[pos] < 0 ? -qcoeff[pos] : qcoeff[pos];
            levels_buf[(pos / w) * stride + (pos % w)] =
                (uint8_t)(v > 127 ? 127 : v);
        }
    }

    if (eob <= 2)
        eob_pt = eob;
    else
        eob_pt = ilog((uint32_t)(eob - 1)) + 1;
    {
        int group_start = eob_pt == 1 ? 1
                          : (eob_pt == 2 ? 2 : (1 << (eob_pt - 2)) + 1);
        extra = eob - group_start;
        nbits = eob_pt < 3 ? 0 : eob_pt - 2;
    }
    {
        uint16_t *tabs[7];
        tabs[0] = cdfs->eob_flag16;
        tabs[1] = cdfs->eob_flag32;
        tabs[2] = cdfs->eob_flag64;
        tabs[3] = cdfs->eob_flag128;
        tabs[4] = cdfs->eob_flag256;
        tabs[5] = cdfs->eob_flag512;
        tabs[6] = cdfs->eob_flag1024;
        int nsy = eob_syms[ems];
        int emc = tx_class == 0 ? 0 : 1;
        cdf = tabs[ems] + (ptype * 2 + emc) * (nsy + 1);
        cost += tpuec_cost_symbol(cdf, nsy, eob_pt - 1);
    }
    if (nbits > 0) {
        int hi = (extra >> (nbits - 1)) & 1;
        cdf = cdfs->eob_extra + ((txs_ctx * 2 + ptype) * 22 + eob_pt) * 3;
        cost += tpuec_cost_symbol(cdf, 2, hi);
        cost += (nbits - 1) * cost_bool_half();
    }

    for (c = eob - 1; c >= 0; c--) {
        int pos = scan[c];
        int row = pos / w, col = pos % w;
        int v = qcoeff[pos];
        int level = v < 0 ? -v : v;
        if (c == eob - 1) {
            int ctx = eob_ctx_of(c, w * h);
            cdf = cdfs->coeff_base_eob +
                  ((txs_ctx * 2 + ptype) * 4 + ctx) * 4;
            cost += tpuec_cost_symbol(cdf, 3, (level > 3 ? 3 : level) - 1);
        } else {
            int ctx = lower_levels_ctx(levels_buf, stride, row, col,
                                       tx_class, rw, rh);
            cdf = cdfs->coeff_base + ((txs_ctx * 2 + ptype) * 42 + ctx) * 5;
            cost += tpuec_cost_symbol(cdf, 4, level > 3 ? 3 : level);
        }
        if (level > NUM_BASE_LEVELS) {
            int bctx = br_context(levels_buf, stride, row, col, tx_class);
            int txs_br = txs_ctx < 3 ? txs_ctx : 3;
            int base_range = level - 1 - NUM_BASE_LEVELS;
            int idx = 0;
            cdf = cdfs->coeff_br + ((txs_br * 2 + ptype) * 21 + bctx) * 5;
            while (idx < COEFF_BASE_RANGE) {
                int k = base_range - idx;
                if (k > BR_CDF_SIZE - 1) k = BR_CDF_SIZE - 1;
                cost += tpuec_cost_symbol(cdf, BR_CDF_SIZE, k);
                if (k < BR_CDF_SIZE - 1) break;
                idx += BR_CDF_SIZE - 1;
            }
        }
    }

    for (c = 0; c < eob; c++) {
        int pos = scan[c];
        int v = qcoeff[pos];
        int level = v < 0 ? -v : v;
        if (level) {
            if (c == 0) {
                cdf = cdfs->dc_sign + (ptype * 3 + sign_ctx) * 3;
                cost += tpuec_cost_symbol(cdf, 2, v < 0 ? 1 : 0);
            } else {
                cost += cost_bool_half();
            }
            if (level > COEFF_BASE_RANGE + NUM_BASE_LEVELS) {
                int rem = level - COEFF_BASE_RANGE - 1 - NUM_BASE_LEVELS;
                int length = 0, x = rem + 1;
                while (x) { length++; x >>= 1; }
                cost += (2 * length - 1) * cost_bool_half();
            }
        }
    }
    return cost;
}

/* compatibility entry (Python slow path): derives eob with the scan
 * walk, then defers to the eob-bounded implementation */
int tpuec_cost_txb(TxbCdfs *cdfs, const int32_t *qcoeff,
                   const int16_t *scan, int n, int w, int h, int rw, int rh,
                   int ems, int txs_ctx, int tx_class, int ptype,
                   int sign_ctx) {
    int eob = 0, i;
    for (i = 0; i < n; i++)
        if (qcoeff[scan[i]]) eob = i + 1;
    return tpuec_cost_txb_eob(cdfs, qcoeff, scan, eob, w, h, rw, rh, ems,
                              txs_ctx, tx_class, ptype, sign_ctx);
}
