"""Fast-path loop-restoration search: separable Wiener solve + per-unit RDO.

The one-pass commit walk emits ``read_lr`` syntax before the frame's own
recon exists, so the fast path searches params on frame N's post-CDEF
recon and signals them on frame N+1 (the same cross-frame cache pattern
the fast path uses for CDEF strengths and DLF levels; noise statistics
are stationary across neighboring frames). Application stays normative
(ops/restoration.apply_lr_frame, dav1d bit-exact).

Reference counterparts (behavioral, no code shared):
 - restoration_pick.c:1471 restoration_seg_search (per-unit search)
 - pick_wiener: stats + wiener_decompose_sep_sym separable solve
Our solve uses the symmetric-tap basis directly: the 7-tap normative
filter has 3 free taps per direction (center = 128 - 2*sum), so each
direction is a 3x3 normal-equation solve on shift-difference basis
signals, alternated once h -> v.
"""

from __future__ import annotations

import numpy as np

# {min, max} per free tap (spec wiener_taps_min/max; tile coding uses
# the same ranges in entropy/tile_writer._WIENER_TAP_SPEC2)
_TAP_MIN = (-5, -23, -17)
_TAP_MAX = (10, 8, 46)

# estimated syntax cost (bits) of a unit: type flag + subexp taps near
# their refs (frame-constant taps converge after the first unit)
_BITS_WIENER = 14.0
_BITS_NONE = 1.0


def _shift2(a: np.ndarray, d: int, axis: int) -> np.ndarray:
    """a shifted by +d and -d along axis, edge-replicated, summed."""
    p = np.take(a, np.clip(np.arange(a.shape[axis]) + d, 0,
                           a.shape[axis] - 1), axis=axis)
    m = np.take(a, np.clip(np.arange(a.shape[axis]) - d, 0,
                           a.shape[axis] - 1), axis=axis)
    return p + m


def _solve_dir_taps(dgd: np.ndarray, src: np.ndarray, axis: int,
                    chroma: bool):
    """Integer taps (t0, t1, t2) minimizing ||128*(src-dgd) - sum t_j
    b_j||^2 over the interior, where b_j = dgd(+-d_j) - 2*dgd for
    d = (3, 2, 1); chroma forces t0 = 0 (7-tap kernels would cross the
    unit border budget the spec gives chroma)."""
    r = (src.astype(np.float64) - dgd) * 128.0
    ds = (3, 2, 1)
    first = 1 if chroma else 0
    basis = [_shift2(dgd, d, axis) - 2.0 * dgd for d in ds[first:]]
    # interior crop: stay 3 px off every edge
    sl = (slice(3, -3), slice(3, -3))
    B = np.stack([b[sl].ravel() for b in basis])
    rv = r[sl].ravel()
    G = B @ B.T
    cvec = B @ rv
    try:
        sol = np.linalg.solve(G + np.eye(len(B)) * 1e-3, cvec)
    except np.linalg.LinAlgError:
        sol = np.zeros(len(B))
    taps = [0, 0, 0]
    for i, v in enumerate(sol):
        j = i + first
        taps[j] = int(np.clip(round(v), _TAP_MIN[j], _TAP_MAX[j]))
    return tuple(taps)


def _filt_dir(dgd: np.ndarray, taps, axis: int) -> np.ndarray:
    """Apply the symmetric 7-tap (float, edge-replicate) along axis."""
    out = dgd * 128.0
    for j, d in enumerate((3, 2, 1)):
        if taps[j]:
            out += taps[j] * (_shift2(dgd, d, axis) - 2.0 * dgd)
    return out / 128.0


def solve_wiener_plane(dgd: np.ndarray, src: np.ndarray, chroma: bool):
    """Frame-level separable Wiener taps for one plane.

    Returns ((v0,v1,v2), (h0,h1,h2), filtered_float_plane)."""
    d = dgd.astype(np.float64)
    htaps = _solve_dir_taps(d, src, axis=1, chroma=chroma)
    dh = _filt_dir(d, htaps, axis=1)
    vtaps = _solve_dir_taps(dh, src, axis=0, chroma=chroma)
    filt = _filt_dir(dh, vtaps, axis=0)
    return vtaps, htaps, filt


def _unit_grid(pw: int, ph: int, usize: int, stripe_off: int):
    """Unit extents. Columns tile plainly; unit ROWS are stripe-aligned,
    shifted up by 8>>subY px (libaom RESTORATION_UNIT_OFFSET) — row r
    spans [r*usize - off, (r+1)*usize - off), last row to the bottom."""
    ucols = max((pw + (usize >> 1)) // usize, 1)
    urows = max((ph + (usize >> 1)) // usize, 1)
    xs = [min(uc * usize, pw) for uc in range(ucols)] + [pw]
    ys = [max(ur * usize - stripe_off, 0) for ur in range(urows)] + [ph]
    ys = [min(v, ph) for v in ys]
    return urows, ucols, ys, xs


def _unit_sums(err2: np.ndarray, ys, xs) -> np.ndarray:
    c = np.cumsum(np.cumsum(err2, 0), 1)
    c = np.pad(c, ((1, 0), (1, 0)))
    ys = np.asarray(ys)
    xs = np.asarray(xs)
    return (c[ys[1:, None], xs[None, 1:]] - c[ys[:-1, None], xs[None, 1:]]
            - c[ys[1:, None], xs[None, :-1]]
            + c[ys[:-1, None], xs[None, :-1]])


class LrDecision:
    """Searched params for the NEXT frame's lr signalling."""

    __slots__ = ("lr_type", "unit_size", "units", "flat", "ucols", "urows",
                 "est_gain")

    def __init__(self, lr_type, unit_size, units, flat, ucols, urows,
                 est_gain):
        self.lr_type = lr_type      # per-plane enum 0/1 (NONE/WIENER)
        self.unit_size = unit_size
        self.units = units          # apply_lr_frame format
        self.flat = flat            # per-plane int16 (n,10) for C
        self.ucols = ucols
        self.urows = urows
        self.est_gain = est_gain    # predicted SSE reduction (>= 0)


class DeviceLrSearch:
    """Device-resident Wiener LR search (the rest_process.c search moved
    onto the device): per-plane tap solve + filtered-SSE evaluation run
    as ONE jitted program per frame, packed into a single f32 transfer.

    The numpy path (search_lr_frame below) does the same math in float64
    on the host; the dispatch/finish split lets the device search for
    frame N+1's signalling ride under host work. The Gram products are
    pinned to full f32 precision (a GPU would otherwise take TF32). Tap
    rounding may still differ from the float64 path by ±1 occasionally,
    and a unit's on/off choice may flip where its two SSEs nearly tie —
    the decision feeds normative signalling either way (application
    stays spec-exact)."""

    def __init__(self, dims, bd: int = 8, unit_size=(64, 32, 32)):
        self.dims = [tuple(d) for d in dims]
        self.bd = bd
        self.unit_size = tuple(unit_size)
        self.grids = []
        for plane in range(3):
            pw, ph = self.dims[plane]
            usize = unit_size[plane]
            self.grids.append(_unit_grid(pw, ph, usize,
                                         8 >> (1 if plane else 0)))
        self._fn = self._build()

    def _build(self):
        import jax
        import jax.numpy as jnp

        bd = self.bd
        hi = float((1 << bd) - 1)

        def shift2(a, d, axis):
            n = a.shape[axis]
            ip = jnp.clip(jnp.arange(n) + d, 0, n - 1)
            im = jnp.clip(jnp.arange(n) - d, 0, n - 1)
            return jnp.take(a, ip, axis) + jnp.take(a, im, axis)

        def solve_dir(dgd, src, axis, chroma):
            r = (src - dgd) * 128.0
            first = 1 if chroma else 0
            basis = [shift2(dgd, d, axis) - 2.0 * dgd
                     for d in (3, 2, 1)[first:]]
            sl = (slice(3, -3), slice(3, -3))
            B = jnp.stack([b[sl].reshape(-1) for b in basis])
            rv = r[sl].reshape(-1)
            hp = jax.lax.Precision.HIGHEST
            G = jnp.matmul(B, B.T, precision=hp)
            c = jnp.matmul(B, rv, precision=hp)
            k = B.shape[0]
            sol = jnp.linalg.solve(G + jnp.eye(k) * 1e-3, c)
            taps = jnp.zeros(3)
            taps = taps.at[first:].set(sol)
            lo = jnp.asarray(_TAP_MIN, jnp.float32)
            hu = jnp.asarray(_TAP_MAX, jnp.float32)
            taps = jnp.clip(jnp.round(taps), lo, hu)
            if chroma:
                taps = taps.at[0].set(0.0)
            return taps

        def filt_dir(dgd, taps, axis):
            out = dgd * 128.0
            for j, d in enumerate((3, 2, 1)):
                out = out + taps[j] * (shift2(dgd, d, axis) - 2.0 * dgd)
            return out / 128.0

        def bands(a, ys, xs):
            rows = jnp.stack([a[y0:y1].sum(axis=0)
                              for y0, y1 in zip(ys[:-1], ys[1:])])
            return jnp.stack([rows[:, x0:x1].sum(axis=1)
                              for x0, x1 in zip(xs[:-1], xs[1:])],
                             axis=1).astype(jnp.float32)

        def unit_sums(err2, ys, xs):
            # exact int32 sums over the static unit bands, in 16-bit
            # halves so no partial sum overflows up to 12 bits: every
            # backend gets the same SSEs (the whole-plane f32 prefix sum
            # this replaces was off by up to 3.3e-4 of a unit's SSE on a
            # 1080p luma plane, above the 1e-4 tie margin)
            return (bands(err2 >> 16, ys, xs) * 65536.0
                    + bands(err2 & 0xFFFF, ys, xs))

        grids = self.grids

        def program(*planes6):
            outs = []
            for plane in range(3):
                dgd_i = planes6[plane].astype(jnp.int32)
                src_i = planes6[3 + plane].astype(jnp.int32)
                dgd = dgd_i.astype(jnp.float32)
                src = src_i.astype(jnp.float32)
                chroma = plane > 0
                ht = solve_dir(dgd, src, 1, chroma)
                dh = filt_dir(dgd, ht, 1)
                vt = solve_dir(dh, src, 0, chroma)
                F = filt_dir(dh, vt, 0)
                Fq = jnp.clip(jnp.round(F), 0.0, hi)
                _, _, ys, xs = grids[plane]
                sse_n = unit_sums((dgd_i - src_i) ** 2, ys, xs)
                sse_w = unit_sums((Fq.astype(jnp.int32) - src_i) ** 2,
                                  ys, xs)
                outs.append(jnp.concatenate(
                    [vt, ht, sse_n.reshape(-1), sse_w.reshape(-1)]))
            return jnp.concatenate(outs)

        return jax.jit(program)

    def dispatch(self, src_planes, recon_planes):
        """Launch the search asynchronously; returns a token for finish().
        Planes are sliced to exact dims on host (static device shapes)."""
        import jax.numpy as jnp
        args = []
        for plane in range(3):
            pw, ph = self.dims[plane]
            args.append(jnp.asarray(
                np.ascontiguousarray(recon_planes[plane][:ph, :pw])))
        for plane in range(3):
            pw, ph = self.dims[plane]
            args.append(jnp.asarray(
                np.ascontiguousarray(src_planes[plane][:ph, :pw])))
        out = self._fn(*args)
        try:
            out.copy_to_host_async()
        except (AttributeError, NotImplementedError):
            pass
        return out

    def finish(self, token, rdmult: float):
        """Fetch + apply the per-unit RDO -> LrDecision (or None)."""
        buf = np.asarray(token)
        off = 0
        lr_type = [0, 0, 0]
        units = [{}, {}, {}]
        flat = [None, None, None]
        ucols_all = [0, 0, 0]
        urows_all = [0, 0, 0]
        total_gain = 0.0
        for plane in range(3):
            urows, ucols, _, _ = self.grids[plane]
            n = urows * ucols
            vt = tuple(int(v) for v in buf[off:off + 3])
            ht = tuple(int(v) for v in buf[off + 3:off + 6])
            sse_n = buf[off + 6:off + 6 + n].reshape(urows, ucols)
            sse_w = buf[off + 6 + n:off + 6 + 2 * n].reshape(urows, ucols)
            off += 6 + 2 * n
            pw, ph = self.dims[plane]
            if pw < 16 or ph < 16 or (not any(vt) and not any(ht)):
                continue
            take = (sse_w + rdmult * _BITS_WIENER) < \
                   (sse_n + rdmult * _BITS_NONE)
            if not take.any():
                continue
            lr_type[plane] = 1
            fa = np.zeros((n, 10), np.int16)
            for ur in range(urows):
                for uc in range(ucols):
                    if take[ur, uc]:
                        units[plane][(ur, uc)] = {
                            "type": 1, "vfilter": vt, "hfilter": ht}
                        fa[ur * ucols + uc, 0] = 1
                        fa[ur * ucols + uc, 1:4] = vt
                        fa[ur * ucols + uc, 4:7] = ht
                    else:
                        units[plane][(ur, uc)] = {"type": 0}
            flat[plane] = fa
            ucols_all[plane] = ucols
            urows_all[plane] = urows
            total_gain += float((sse_n - sse_w)[take].sum())
        if not any(lr_type):
            return None
        return LrDecision(tuple(lr_type), self.unit_size, units, flat,
                          ucols_all, urows_all, total_gain)


def search_lr_frame(src_planes, recon_planes, dims, rdmult: float,
                    bd: int = 8, unit_size=(64, 32, 32)):
    """Search Wiener LR over all three planes.

    src_planes/recon_planes: (possibly padded) uint16 planes; dims:
    [(w, h)]*3 actual plane dims. Returns an LrDecision, or None when no
    unit helps anywhere."""
    lr_type = [0, 0, 0]
    units = [{}, {}, {}]
    flat = [None, None, None]
    ucols_all = [0, 0, 0]
    urows_all = [0, 0, 0]
    total_gain = 0.0
    for plane in range(3):
        pw, ph = dims[plane]
        if pw < 16 or ph < 16:
            continue
        S = np.asarray(src_planes[plane])[:ph, :pw].astype(np.float64)
        R = np.asarray(recon_planes[plane])[:ph, :pw].astype(np.float64)
        vt, ht, F = solve_wiener_plane(R, S, chroma=plane > 0)
        if not any(vt) and not any(ht):
            continue
        usize = unit_size[plane]
        urows, ucols, ys, xs = _unit_grid(pw, ph, usize,
                                          8 >> (1 if plane else 0))
        sse_none = _unit_sums((R - S) ** 2, ys, xs)
        sse_w = _unit_sums((np.clip(np.rint(F), 0, (1 << bd) - 1) - S) ** 2,
                           ys, xs)
        take = (sse_w + rdmult * _BITS_WIENER) < \
               (sse_none + rdmult * _BITS_NONE)
        if not take.any():
            continue
        lr_type[plane] = 1
        fa = np.zeros((urows * ucols, 10), np.int16)
        for ur in range(urows):
            for uc in range(ucols):
                if take[ur, uc]:
                    units[plane][(ur, uc)] = {
                        "type": 1, "vfilter": vt, "hfilter": ht}
                    fa[ur * ucols + uc, 0] = 1
                    fa[ur * ucols + uc, 1:4] = vt
                    fa[ur * ucols + uc, 4:7] = ht
                else:
                    units[plane][(ur, uc)] = {"type": 0}
        flat[plane] = fa
        ucols_all[plane] = ucols
        urows_all[plane] = urows
        total_gain += float((sse_none - sse_w)[take].sum())
    if not any(lr_type):
        return None
    return LrDecision(tuple(lr_type), tuple(unit_size), units, flat,
                      ucols_all, urows_all, total_gain)
