/* The plan layer's intra descriptor table, built on the host from the
 * syntax walk's flat CU / TU records (cabac/native_walk.py).
 *
 * One row [D] int32 per intra unit of a picture, in parse order: the
 * unit's geometry, its mode class and angular parameters, and the
 * reference-sample fill geometry that the device intra scan reads
 * (ops/intra_device.py, the descriptor row layout).  This is the C twin
 * of ops/intra_device.py::build_intra_descriptors_py, row for row and
 * bit for bit, with the same first rejection reason in the same parse
 * order; tests/test_torch_plan_native.py holds the two together.
 *
 * What the Python twin spends its time on is availability: ~30 calls of
 * recon_np.sample_available a row, each through several Python frames.
 * Here availability is one function over the picture's CU maps and a TU
 * order map kept in parse order (the rule of getCURestricted: picture
 * bounds, the CTU grid and WPP, same slice and tile, decode order, the
 * TU order inside the CU).
 *
 * The caller passes the record columns it reads as index tables (the
 * record layout is the walk's, named in Python), the record widths, the
 * picture's parameters and the mode tables.  Where the inputs hold
 * something the Python twin would fail on (an index outside a map or a
 * table, a TU without blocks), the builder returns PLAN_UNMODELLED and
 * the caller runs the twin, which then fails the same way.
 *
 * Plain C, no Python headers: built with the host compiler into
 * build/kernels/ and loaded with ctypes (ops/cuda/_build.py).  Reentrant:
 * all state lives in the call.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define D 33

#define PLAN_REJECT (-1)
#define PLAN_UNMODELLED (-2)

/* rejection reasons, in the order of ops/plan_host.REASONS */
enum { R_IBC, R_CIIP_SIZE, R_ISP, R_MRL, R_BDPCM, R_BLOCK_SIZE,
       R_FILL_CORNER_CASE, R_CHROMA_MODE };

/* CU record columns read, in the order of ops/plan_host.CU_COLS */
enum { C_X, C_Y, C_W, C_H, C_CX, C_CY, C_CW, C_CH, C_HAS_LUMA,
       C_HAS_CHROMA, C_TREE_TYPE, C_PRED_MODE, C_DIR0, C_DIR1, C_BDPCM,
       C_BDPCM_C, C_MIP, C_MIP_T, C_MRL, C_ISP, C_CIIP, C_SLICE, C_TILE,
       C_NCOLS };

/* TU record columns read, in the order of ops/plan_host.TU_COLS */
enum { T_CU, T_BX0, T_BY0, T_BW0, T_BH0, T_BX1, T_BY1, T_BW1, T_BH1,
       T_BX2, T_BY2, T_BW2, T_BH2, T_CBF0, T_CBF1, T_CBF2, T_JOINT,
       T_NCOLS };

/* picture parameters, in the order of ops/plan_host.PARAMS */
enum { P_N_CUS, P_N_TUS, P_CU_WIDTH, P_TU_WIDTH, P_W, P_H, P_CW, P_CH,
       P_SUB_W, P_SUB_H, P_NUM_COMP, P_CHROMA_FORMAT, P_CTU_LOG2,
       P_CTU_SIZE, P_WPP, P_CHROMA_SCALE, P_MAP_W, P_MAP_H, P_MAPC_W,
       P_MAPC_H, P_N_ANG, P_N_THRESH, P_N_C422, P_MAX_ROWS, P_NPARAMS };

/* prediction modes, tree types and intra mode indices
 * (frame/structure.py) */
enum { MODE_INTER = 0, MODE_INTRA = 1 };
enum { TREE_C = 2 };
enum { PLANAR_IDX = 0, DC_IDX = 1, HOR_IDX = 18, DIA_IDX = 34,
       VER_IDX = 50, VDIA_IDX = 66, NUM_LUMA_MODE = 67, LM_CHROMA_IDX = 67,
       MDLM_L_IDX = 68, MDLM_T_IDX = 69, DM_CHROMA_IDX = 70 };

typedef struct {
    int c[C_NCOLS];
} Cu;

typedef struct {
    int t[T_NCOLS];
} Tu;

typedef struct {
    const Cu *cus;
    int n_cus;
    const int32_t *cu_map;      /* [map_h, map_w] CU index per luma 4x4 */
    const int32_t *cu_map_c;    /* [mapc_h, mapc_w] per chroma 2x2 */
    int32_t *order;             /* [map_h, map_w] TU parse order, -1 */
    int map_w, map_h, mapc_w, mapc_h;
    int W[2], H[2];             /* luma and chroma plane sizes */
    int sub_w, sub_h, num_comp, ctu_log2, ctu_size, wpp;
    int bad;                    /* an input the twin would fail on */
} Pic;

static int bitlen(int v)
{
    int n = 0;
    while (v > 0) {
        n++;
        v >>= 1;
    }
    return n;
}

static int imin(int a, int b) { return a < b ? a : b; }
static int iabs(int a) { return a < 0 ? -a : a; }

/* CodingStructure.cu_at(x, y, 0): CU index or -1 */
static int cu_at_luma(Pic *p, int x, int y)
{
    if (x < 0 || y < 0 || x >= p->W[0] || y >= p->H[0])
        return -1;
    if ((y >> 2) >= p->map_h || (x >> 2) >= p->map_w) {
        p->bad = 1;
        return -1;
    }
    int idx = p->cu_map[(size_t)(y >> 2) * p->map_w + (x >> 2)];
    if (idx >= p->n_cus)
        p->bad = 1;
    return idx >= 0 && idx < p->n_cus ? idx : -1;
}

/* CodingStructure.cu_at(x, y, 1) */
static int cu_at_chroma(Pic *p, int x, int y)
{
    if (p->num_comp < 2 || x < 0 || y < 0 || x >= p->W[1] || y >= p->H[1])
        return -1;
    if ((y >> 1) >= p->mapc_h || (x >> 1) >= p->mapc_w) {
        p->bad = 1;
        return -1;
    }
    int idx = p->cu_map_c[(size_t)(y >> 1) * p->mapc_w + (x >> 1)];
    if (idx >= p->n_cus)
        p->bad = 1;
    return idx >= 0 && idx < p->n_cus ? idx : -1;
}

/* CodingStructure.cu_at_restricted(x, y, cur, 0) */
static int cu_at_restricted(Pic *p, int x, int y, int cur)
{
    int idx = cu_at_luma(p, x, y);
    if (idx < 0)
        return -1;
    const int *a = p->cus[idx].c, *b = p->cus[cur].c;
    if (a[C_SLICE] != b[C_SLICE] || a[C_TILE] != b[C_TILE])
        return -1;
    int sh = p->ctu_log2;
    int xdiff = (x >> sh) - (b[C_X] >> sh);
    int ydiff = (y >> sh) - (b[C_Y] >> sh);
    if (ydiff == 0 && xdiff == 0) {
        if (idx > cur)
            return -1;
    } else if (ydiff > 0 || (ydiff == 0 && xdiff > 0)
               || xdiff > (p->wpp ? 0 : 1)) {
        return -1;
    }
    return idx;
}

/* recon_np.sample_available: is the reference sample (px, py) of
 * component comp decoded before TU `order` of CU `ci`? */
static int avail(Pic *p, int px, int py, int comp, int ci, int order)
{
    if (px < 0 || py < 0)
        return 0;
    int sx = comp ? p->sub_w : 1, sy = comp ? p->sub_h : 1;
    int pi = comp ? 1 : 0;
    if (px >= p->W[pi] || py >= p->H[pi])
        return 0;
    const int *cu = p->cus[ci].c;
    int shx = p->ctu_log2 - (sx - 1), shy = p->ctu_log2 - (sy - 1);
    int cux = comp ? cu[C_CX] : cu[C_X], cuy = comp ? cu[C_CY] : cu[C_Y];
    int xdiff = (px >> shx) - (cux >> shx);
    int ydiff = (py >> shy) - (cuy >> shy);
    if (ydiff > 0 || (ydiff == 0 && xdiff > 0))
        return 0;
    if (xdiff > (p->wpp ? 0 : 1))
        return 0;
    int lx = px * sx, ly = py * sy;
    int ci2 = comp ? cu_at_chroma(p, px, py) : cu_at_luma(p, lx, ly);
    if (ci2 < 0)
        return 0;
    const int *cu2 = p->cus[ci2].c;
    if (cu2[C_SLICE] != cu[C_SLICE] || cu2[C_TILE] != cu[C_TILE])
        return 0;
    if (ci2 > ci)
        return 0;
    if (ci2 == ci) {
        if ((ly >> 2) >= p->map_h || (lx >> 2) >= p->map_w) {
            p->bad = 1;
            return 0;
        }
        int o = p->order[(size_t)(ly >> 2) * p->map_w + (lx >> 2)];
        if (o < 0 || o >= order)
            return 0;
    }
    return 1;
}

/* ops/intra_device._fill_params: the 12 fill ints of one unit and its
 * avail0 flag; returns 1 for the corner-only layout (a rejection) */
static int fill_params(Pic *p, int comp, int ci, int order, int x, int y,
                       int w, int h, int32_t *f, int32_t *avail0)
{
    int pi = comp ? 1 : 0;
    int wp = p->W[pi], hp = p->H[pi];
    int sx = comp ? p->sub_w : 1, sy = comp ? p->sub_h : 1;
    int unit_w = 4 / sx, unit_h = 4 / sy;
    int total_above = (2 * w + unit_w - 1) / unit_w;
    int total_left = (2 * h + unit_h - 1) / unit_h;
    int n_topleft = avail(p, x - 1, y - 1, comp, ci, order);
    int n_above = 0, n_left = 0;
    for (int u = 0; u < total_above; u++) {
        if (!avail(p, x + u * unit_w, y - 1, comp, ci, order))
            break;
        n_above++;
    }
    for (int u = 0; u < total_left; u++) {
        if (!avail(p, x - 1, y + u * unit_h, comp, ci, order))
            break;
        n_left++;
    }
    memset(f, 0, 12 * sizeof(int32_t));
    *avail0 = 0;
    if (n_topleft + n_above + n_left == 0) {
        *avail0 = 1;
        return 0;
    }
    if (n_topleft + n_above + n_left == total_above + total_left + 1) {
        int32_t v[12] = {y - 1, y - 1, 0, x - 1, x - 1,
                         imin(x - 1 + 2 * w, wp - 1),
                         x - 1, x - 1, 0, y - 1, y - 1,
                         imin(y + 2 * h - 1, hp - 1)};
        memcpy(f, v, sizeof(v));
        return 0;
    }
    if (n_left > 0) {
        int n_l = imin(imin(n_left * unit_h, 2 * h), hp - y);
        int lylo = n_topleft ? y - 1 : y;
        int lyhi = y + n_l - 1;
        int txhi = x - 1;
        if (n_above > 0)
            txhi = x + imin(imin(n_above * unit_w, 2 * w), wp - x) - 1;
        int ty_a = y, ty_b = y, ty_k = 0;
        if (n_topleft) {
            ty_a = ty_b = y - 1;
        } else if (n_above > 0) {
            ty_b = y - 1;
            ty_k = 1;
        }
        int32_t v[12] = {ty_a, ty_b, ty_k, x - 1, x - 1, txhi,
                         x - 1, x - 1, 0, y - 1, lylo, lyhi};
        memcpy(f, v, sizeof(v));
        return 0;
    }
    if (n_above == 0)
        return 1;
    int n_a = imin(imin(n_above * unit_w, 2 * w), wp - x);
    int32_t v[12] = {y - 1, y - 1, 0, x - 1, x, x + n_a - 1,
                     x, x, 0, 0, y - 1, y - 1};
    memcpy(f, v, sizeof(v));
    return 0;
}

/* lmcs_fields of build_intra_descriptors_py: the VPDU geometry of the
 * LMCS chroma residual scale (calculateChromaAdjVpduNei), rows 29-32 */
static void lmcs_fields(Pic *p, int chroma_scale, const Tu *tu, int comp,
                        int32_t *r)
{
    const int *t = tu->t;
    r[0] = r[1] = r[2] = r[3] = 0;
    if (!chroma_scale || (comp != 1 && comp != 2))
        return;
    if (t[T_BW1] == 0)
        return;
    if (t[T_BW1] * t[T_BH1] <= 4
        || !(t[T_CBF1] || t[T_CBF2] || t[T_JOINT]))
        return;
    if (!(t[T_CBF0 + comp] || t[T_JOINT]))
        return;
    int lx, ly;
    if (t[T_BW0] != 0) {
        lx = t[T_BX0];
        ly = t[T_BY0];
    } else {
        lx = t[T_BX1] * p->sub_w;
        ly = t[T_BY1] * p->sub_h;
    }
    int vmask = p->ctu_size == 128 ? 63 : p->ctu_size - 1;
    int tl = cu_at_luma(p, lx & ~vmask, ly & ~vmask);
    if (tl < 0) {
        p->bad = 1;     /* the twin reads a missing CU's position */
        return;
    }
    int x_pos = p->cus[tl].c[C_X], y_pos = p->cus[tl].c[C_Y];
    int above = cu_at_restricted(p, x_pos, y_pos - 1, tl);
    int left = cu_at_restricted(p, x_pos - 1, y_pos, tl);
    r[0] = 1 | (left >= 0 ? 2 : 0) | (above >= 0 ? 4 : 0);
    r[1] = x_pos;
    r[2] = y_pos;
}

static void put_head(int32_t *d, int comp, int x, int y, int w, int h,
                     int mode_class, int filtered, int cbf, int avail0)
{
    d[0] = comp; d[1] = x; d[2] = y; d[3] = w; d[4] = h;
    d[5] = bitlen(w) - 1; d[6] = bitlen(h) - 1;
    d[7] = mode_class; d[8] = filtered; d[9] = cbf; d[10] = avail0;
}

/* build the rows of one picture into out [max_rows, D]; returns the row
 * count, PLAN_REJECT with status[0] the reason, or PLAN_UNMODELLED.
 * status[1]: whether any CU of the picture is not intra. */
int plan_intra_rows(const int32_t *params, int n_params,
                    const int32_t *cu_cols, const int32_t *tu_cols,
                    const int32_t *cu_rec, const int32_t *tu_rec,
                    const int32_t *cu_map, const int32_t *cu_map_c,
                    const int32_t *ang, const int32_t *inv_ang,
                    const int32_t *thresh, const int32_t *c422,
                    int32_t *out, int32_t *status)
{
    if (n_params != P_NPARAMS)
        return PLAN_UNMODELLED;
    const int n_cus = params[P_N_CUS], n_tus = params[P_N_TUS];
    const int cu_width = params[P_CU_WIDTH], tu_width = params[P_TU_WIDTH];
    const int max_rows = params[P_MAX_ROWS];
    const int n_ang = params[P_N_ANG], n_thresh = params[P_N_THRESH];
    const int n_c422 = params[P_N_C422];
    const int fmt = params[P_CHROMA_FORMAT];
    const int chroma_scale = params[P_CHROMA_SCALE];
    for (int k = 0; k < C_NCOLS; k++)
        if (cu_cols[k] < 0 || cu_cols[k] >= cu_width)
            return PLAN_UNMODELLED;
    for (int k = 0; k < T_NCOLS; k++)
        if (tu_cols[k] < 0 || tu_cols[k] >= tu_width)
            return PLAN_UNMODELLED;
    if (n_cus < 0 || n_tus < 0)
        return PLAN_UNMODELLED;

    Pic p;
    memset(&p, 0, sizeof(p));
    Cu *cus = malloc(sizeof(Cu) * (size_t)(n_cus > 0 ? n_cus : 1));
    Tu *tus = malloc(sizeof(Tu) * (size_t)(n_tus > 0 ? n_tus : 1));
    size_t n_map = (size_t)params[P_MAP_W] * (size_t)params[P_MAP_H];
    int32_t *order = malloc(sizeof(int32_t) * (n_map > 0 ? n_map : 1));
    unsigned char *seen_ciip = calloc((size_t)(n_cus > 0 ? n_cus : 1), 1);
    int ret = 0, inter = 0;
    if (!cus || !tus || !order || !seen_ciip) {
        ret = PLAN_UNMODELLED;
        goto done;
    }
    for (int i = 0; i < n_cus; i++) {
        const int32_t *r = cu_rec + (size_t)i * cu_width;
        for (int k = 0; k < C_NCOLS; k++)
            cus[i].c[k] = r[cu_cols[k]];
        if (cus[i].c[C_PRED_MODE] != MODE_INTRA)
            inter = 1;
    }
    for (int i = 0; i < n_tus; i++) {
        const int32_t *r = tu_rec + (size_t)i * tu_width;
        for (int k = 0; k < T_NCOLS; k++)
            tus[i].t[k] = r[tu_cols[k]];
    }
    for (size_t k = 0; k < n_map; k++)
        order[k] = -1;
    p.cus = cus;
    p.n_cus = n_cus;
    p.cu_map = cu_map;
    p.cu_map_c = cu_map_c;
    p.order = order;
    p.map_w = params[P_MAP_W];
    p.map_h = params[P_MAP_H];
    p.mapc_w = params[P_MAPC_W];
    p.mapc_h = params[P_MAPC_H];
    p.W[0] = params[P_W];
    p.H[0] = params[P_H];
    p.W[1] = params[P_CW];
    p.H[1] = params[P_CH];
    p.sub_w = params[P_SUB_W];
    p.sub_h = params[P_SUB_H];
    p.num_comp = params[P_NUM_COMP];
    p.ctu_log2 = params[P_CTU_LOG2];
    p.ctu_size = params[P_CTU_SIZE];
    p.wpp = params[P_WPP];

    int n = 0;
    int32_t fill[12], avail0;
    for (int i = 0; i < n_tus && ret == 0; i++) {
        const Tu *tu = &tus[i];
        const int *t = tu->t;
        const int ci = t[T_CU];
        if (ci < 0 || ci >= n_cus) {
            ret = PLAN_UNMODELLED;
            break;
        }
        const int *cu = cus[ci].c;
        const int is_intra = cu[C_PRED_MODE] == MODE_INTRA;
        if (!is_intra) {
            if (cu[C_PRED_MODE] != MODE_INTER) {
                status[0] = R_IBC;
                ret = PLAN_REJECT;
                break;
            }
            if (cu[C_CIIP] && !seen_ciip[ci]) {
                /* CIIP: a planar blend unit per component at this CU's
                 * parse position, weighted by its neighbours' modes */
                seen_ciip[ci] = 1;
                if (cu[C_W] > 64 || cu[C_H] > 64) {
                    status[0] = R_CIIP_SIZE;
                    ret = PLAN_REJECT;
                    break;
                }
                int lnb = cu_at_restricted(&p, cu[C_X] - 1,
                                           cu[C_Y] + cu[C_H] - 1, ci);
                int anb = cu_at_restricted(&p, cu[C_X] + cu[C_W] - 1,
                                           cu[C_Y] - 1, ci);
                int n0 = lnb >= 0
                    && cus[lnb].c[C_PRED_MODE] == MODE_INTRA && lnb < ci;
                int n1 = anb >= 0
                    && cus[anb].c[C_PRED_MODE] == MODE_INTRA && anb < ci;
                int w_intra = 3 - !n0 - !n1, w_merge = 3 - n0 - n1;
                int ncomp = (p.num_comp > 1 && cu[C_CW] > 2)
                    ? p.num_comp : 1;
                for (int comp = 0; comp < ncomp; comp++) {
                    int x = comp ? cu[C_CX] : cu[C_X];
                    int y = comp ? cu[C_CY] : cu[C_Y];
                    int w = comp ? cu[C_CW] : cu[C_W];
                    int h = comp ? cu[C_CH] : cu[C_H];
                    if (fill_params(&p, comp, ci, i, x, y, w, h, fill,
                                    &avail0)) {
                        status[0] = R_FILL_CORNER_CASE;
                        ret = PLAN_REJECT;
                        break;
                    }
                    if (n >= max_rows) {
                        ret = PLAN_UNMODELLED;
                        break;
                    }
                    int32_t *d = out + (size_t)n++ * D;
                    memset(d, 0, D * sizeof(int32_t));
                    put_head(d, comp, x, y, w, h, 5,
                             comp == 0 && w * h > 32, 1, avail0);
                    memcpy(d + 11, fill, sizeof(fill));
                    d[24] = w_intra;
                    d[25] = w_merge;
                    d[27] = w >= 4 && h >= 4;
                    d[28] = 1;
                }
                if (ret != 0)
                    break;
            }
        } else {
            if (cu[C_ISP]) {
                status[0] = R_ISP;
                ret = PLAN_REJECT;
                break;
            }
            if (cu[C_MRL]) {
                status[0] = R_MRL;
                ret = PLAN_REJECT;
                break;
            }
            if (cu[C_BDPCM] || cu[C_BDPCM_C]) {
                status[0] = R_BDPCM;
                ret = PLAN_REJECT;
                break;
            }
        }
        int comps[3], n_comps = 0;
        if (t[T_BW0] != 0 && cu[C_HAS_LUMA])
            comps[n_comps++] = 0;
        if (t[T_BW1] != 0 && cu[C_HAS_CHROMA] && p.num_comp > 1) {
            comps[n_comps++] = 1;
            comps[n_comps++] = 2;
        }
        for (int k = 0; k < n_comps; k++) {
            const int comp = comps[k];
            const int x = t[T_BX0 + 4 * comp], y = t[T_BY0 + 4 * comp];
            const int w = t[T_BW0 + 4 * comp], h = t[T_BH0 + 4 * comp];
            if (w == 0) {       /* the twin unpacks a missing block */
                ret = PLAN_UNMODELLED;
                break;
            }
            const int cbf = t[T_CBF0 + comp] || (comp && t[T_JOINT]);
            if (!is_intra)
                continue;
            if (w > 64 || h > 64 || w < 1 || h < 1) {
                status[0] = R_BLOCK_SIZE;
                ret = PLAN_REJECT;
                break;
            }
            if (fill_params(&p, comp, ci, i, x, y, w, h, fill, &avail0)) {
                status[0] = R_FILL_CORNER_CASE;
                ret = PLAN_REJECT;
                break;
            }
            if (n >= max_rows) {
                ret = PLAN_UNMODELLED;
                break;
            }
            const int l2w = bitlen(w) - 1, l2h = bitlen(h) - 1;
            int32_t *d = out + (size_t)n * D;
            memset(d, 0, D * sizeof(int32_t));
            memcpy(d + 11, fill, sizeof(fill));
            d[28] = 1;
            if (comp == 0 && cu[C_MIP]) {
                put_head(d, comp, x, y, w, h, 3, 0, cbf, avail0);
                d[24] = cu[C_DIR0];
                d[25] = cu[C_MIP_T] ? 1 : 0;
                d[26] = (w == 4 && h == 4) ? 0
                    : (w == 4 || h == 4 || (w == 8 && h == 8)) ? 1 : 2;
                n++;
                continue;
            }
            /* final_mode */
            int mode;
            if (comp == 0) {
                mode = cu[C_DIR0];
            } else {
                mode = cu[C_DIR1];
                if (mode == DM_CHROMA_IDX) {
                    /* co_located_luma_mode_of */
                    int src = ci;
                    if (cu[C_TREE_TYPE] == TREE_C || !cu[C_HAS_LUMA])
                        src = cu_at_luma(
                            &p, (cu[C_CX] + (cu[C_CW] >> 1)) * p.sub_w,
                            (cu[C_CY] + (cu[C_CH] >> 1)) * p.sub_h);
                    mode = (src < 0 || cus[src].c[C_MIP])
                        ? PLANAR_IDX : cus[src].c[C_DIR0];
                }
                if (fmt == 2 && mode < NUM_LUMA_MODE) {
                    if (mode < 0 || mode >= n_c422) {
                        ret = PLAN_UNMODELLED;
                        break;
                    }
                    mode = c422[mode];
                }
            }
            if (mode >= NUM_LUMA_MODE) {
                /* CCLM: the template availability geometry */
                if (!(LM_CHROMA_IDX <= mode && mode <= MDLM_T_IDX)) {
                    status[0] = R_CHROMA_MODE;
                    ret = PLAN_REJECT;
                    break;
                }
                const int unit = 2;
                const int tu_w_units = w / unit, tu_h_units = h / unit;
                const int cu_above = avail(&p, cu[C_CX], cu[C_CY] - 1,
                                           comp, ci, i);
                const int cu_left = avail(&p, cu[C_CX] - 1, cu[C_CY],
                                          comp, ci, i);
                const int above_flag = cu_above || y > cu[C_CY];
                const int left_flag = cu_left || x > cu[C_CX];
                int above_avail = 0, left_avail = 0;
                int actual_top = 0, actual_left = 0;
                if (mode == MDLM_T_IDX) {
                    int avai = 0;
                    if (above_flag) {
                        avai = tu_w_units;
                        int units = imin((2 * w) / unit - tu_w_units,
                                         h / unit);
                        for (int u = 0; u < units; u++) {
                            if (!avail(&p, x + w + u * unit, y - 1, comp,
                                       ci, i))
                                break;
                            avai++;
                        }
                    }
                    above_avail = avai >= tu_w_units;
                    actual_top = unit * avai;
                } else if (mode == MDLM_L_IDX) {
                    int avai = 0;
                    if (left_flag) {
                        avai = tu_h_units;
                        int units = imin((2 * h) / unit - tu_h_units,
                                         w / unit);
                        for (int u = 0; u < units; u++) {
                            if (!avail(&p, x - 1, y + h + u * unit, comp,
                                       ci, i))
                                break;
                            avai++;
                        }
                    }
                    left_avail = avai >= tu_h_units;
                    actual_left = unit * avai;
                } else {
                    above_avail = above_flag;
                    left_avail = left_flag;
                    actual_top = above_avail ? w : 0;
                    actual_left = left_avail ? h : 0;
                }
                put_head(d, comp, x, y, w, h, 4, 0, cbf, avail0);
                d[23] = left_flag ? 1 : 0;
                d[24] = actual_top;
                d[25] = actual_left;
                d[26] = (above_avail ? 1 : 0) | (left_avail ? 2 : 0);
                d[27] = above_flag ? 1 : 0;
                lmcs_fields(&p, chroma_scale, tu, comp, d + 29);
                n++;
                continue;
            }
            /* planar, DC, angular (wide_angle, the filter thresholds) */
            int mode_class, filtered = 0, is_ver = 0, angle = 0, inv = 0;
            int kind = 0;
            if (mode == PLANAR_IDX) {
                mode_class = 0;
                if (comp == 0 && w * h > 32)
                    filtered = 1;
            } else if (mode == DC_IDX) {
                mode_class = 1;
            } else {
                mode_class = 2;
                int pm = mode;
                if (DC_IDX < pm && pm <= VDIA_IDX) {
                    static const int shift[6] = {0, 6, 10, 12, 14, 15};
                    int delta = iabs(l2w - l2h);
                    if (delta > 5) {
                        ret = PLAN_UNMODELLED;
                        break;
                    }
                    if (w > h && pm < 2 + shift[delta])
                        pm += VDIA_IDX - 1;
                    else if (h > w && pm > VDIA_IDX - shift[delta])
                        pm -= VDIA_IDX - 1;
                }
                is_ver = pm >= DIA_IDX;
                int ang_mode = is_ver ? pm - VER_IDX : -(pm - HOR_IDX);
                int a = iabs(ang_mode);
                int log2_size = (l2w + l2h) >> 1;
                if (a >= n_ang || log2_size < 0 || log2_size >= n_thresh) {
                    ret = PLAN_UNMODELLED;
                    break;
                }
                int abs_ang = ang[a];
                inv = inv_ang[a];
                angle = ang_mode >= 0 ? abs_ang : -abs_ang;
                int diff = imin(iabs(pm - HOR_IDX), iabs(pm - VER_IDX));
                int thresh_ok = diff > thresh[log2_size];
                if ((abs_ang & 0x1F) == 0) {
                    kind = 0;
                    if (comp == 0 && thresh_ok)
                        filtered = 1;
                } else if (comp != 0) {
                    kind = 3;
                } else {
                    kind = thresh_ok ? 2 : 1;
                }
            }
            put_head(d, comp, x, y, w, h, mode_class, filtered, cbf, avail0);
            d[23] = is_ver;
            d[24] = angle;
            d[25] = inv;
            d[26] = kind;
            d[27] = w >= 4 && h >= 4;
            lmcs_fields(&p, chroma_scale, tu, comp, d + 29);
            n++;
        }
        if (ret != 0)
            break;
        /* mark the TU decoded (luma-granularity order map) */
        int mx, my, mw, mh;
        if (t[T_BW0] != 0) {
            mx = t[T_BX0]; my = t[T_BY0]; mw = t[T_BW0]; mh = t[T_BH0];
        } else if (t[T_BW1] != 0) {
            mx = t[T_BX1] * p.sub_w; my = t[T_BY1] * p.sub_h;
            mw = t[T_BW1] * p.sub_w; mh = t[T_BH1] * p.sub_h;
        } else {
            ret = PLAN_UNMODELLED;
            break;
        }
        if (mx < 0 || my < 0) {
            ret = PLAN_UNMODELLED;
            break;
        }
        int r1 = imin((my + mh) >> 2, p.map_h);
        int c1 = imin((mx + mw) >> 2, p.map_w);
        for (int r = my >> 2; r < r1; r++)
            for (int c = mx >> 2; c < c1; c++)
                order[(size_t)r * p.map_w + c] = i;
        if (p.bad)
            ret = PLAN_UNMODELLED;
    }
    /* the twin fails where an index fell outside its maps, whatever
     * the builder met after it */
    if (p.bad)
        ret = PLAN_UNMODELLED;
    else if (ret == 0)
        ret = n;
    status[1] = inter;
done:
    free(cus);
    free(tus);
    free(order);
    free(seen_ciip);
    return ret;
}
