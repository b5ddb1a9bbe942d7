"""Grid-to-grid resampling — the gdalwarp / rasterio.reproject replacement.

The reference shells out to gdalwarp for the ortho -> S2-anchored-UTM warp
(EMIT_data/emit_proj.py:876-940, ``-r cubic``) and uses rasterio
``reproject`` for grid transfers (demo notebook cell 73: nearest /
bilinear / average; Spectral_matching cell 3: bilinear).

Device design: the projection math runs on the host in float64 (CRS
series lose ~100 m in f32) producing a *fractional source pixel index
field* — f32 is ample for indices — and the device does the purely local
part: a vectorized gather + separable convolution over the source image,
with nodata-aware weight renormalisation.

Resampling kernels:
- nearest: round + gather;
- bilinear: 2x2 gather, nodata-excluded weight renormalisation;
- cubic: 4x4 separable cubic convolution, a = -0.5 (GDAL's default
  Catmull-Rom-style kernel), nodata-aware renormalisation. (GDAL instead
  discards a destination pixel when source weight coverage is too low;
  renormalisation is documented as the intentional deviation.)
- average: exact integer-factor block mean excluding nodata (the 6x
  S2 -> EMIT grid transfer, demo cell 73 / cell 81 phase 2), falling back
  to an area-weighted gather for non-integer ratios.

Execution strategies: the two-pass scanline decomposition
(``orthowarp_two_pass`` / ``warp_two_pass`` — banded-weight matmuls,
default; its banded backend contracts each destination tile against one
source window), the fused tap-loop gathers (``orthowarp_taploop`` —
bit-exact 2D tensor-product kernel), and plain per-tap gathers
(``warp_interpolate``) for small problems.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.constants import NO_DATA_VALUE
from ..core.crs import transform as crs_transform
from ..core.grid import Grid


# ---------------------------------------------------------------------------
# Host: coordinate fields (float64 projection -> float32 index fields)
# ---------------------------------------------------------------------------

def source_index_field(src_grid: Grid, dst_grid: Grid
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(rows, cols) float32 arrays of shape dst.shape: fractional source
    pixel indices (pixel centres at integers) of each destination pixel
    centre."""
    xs, ys = dst_grid.pixel_center_coords()
    X, Y = np.meshgrid(xs, ys)
    sx, sy = crs_transform(dst_grid.crs, src_grid.crs, X, Y)
    cols, rows = src_grid.colrow_of(sx, sy)
    return rows.astype(np.float32), cols.astype(np.float32)


def separable_index_axes(src_grid: Grid, dst_grid: Grid
                         ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """When src and dst share a CRS the mapping is separable: returns
    (rows (Hd,), cols (Wd,)) or None when reprojection is required."""
    if src_grid.crs != dst_grid.crs:
        return None
    xs, ys = dst_grid.pixel_center_coords()
    cols, _ = src_grid.colrow_of(xs, src_grid.y0)
    _, rows = src_grid.colrow_of(src_grid.x0, ys)
    return rows.astype(np.float32), cols.astype(np.float32)


def scanline_cstar(rows: np.ndarray, cols: np.ndarray,
                   src_h: int) -> np.ndarray:
    """Pass-1 column-index field for the two-pass (Catmull-Smith) warp.

    rows/cols (Hd, Wd) are the dst->src fractional index fields. For each
    destination column j, its preimage in source space is the smooth curve
    (rows[:, j], cols[:, j]); cstar[m, j] is the fractional source COLUMN
    where that curve crosses source ROW m — i.e. the horizontal resampling
    position pass 1 must evaluate on each source scanline. Computed by
    monotone interpolation of cols over rows per destination column
    (projection curves are smooth; inversion error is far below 1e-3 px).
    Outside the curve's row span the end values are held (those scanlines
    only feed edge taps, which the validity channel renormalises away).
    """
    rows = np.asarray(rows, dtype=np.float64)
    cols = np.asarray(cols, dtype=np.float64)
    hd, wd = rows.shape
    m = np.arange(src_h, dtype=np.float64)
    cstar = np.empty((src_h, wd), dtype=np.float64)
    # np.interp silently returns garbage for unsorted xp — reject
    # non-monotone preimage curves loudly (direct callers like the
    # ortho pipeline have no other monotonicity gate)
    diffs = np.diff(rows, axis=0)
    if hd >= 2 and not (np.all(diffs >= -1e-9, axis=0)
                        | np.all(diffs <= 1e-9, axis=0)).all():
        raise ValueError(
            "scanline_cstar: dst->src row field is not monotone along "
            "destination columns; the two-pass scanline warp cannot "
            "represent this geometry — use the taploop warp kernel")
    for j in range(wd):
        rj, cj = rows[:, j], cols[:, j]
        if hd >= 2 and rj[0] > rj[-1]:
            rj, cj = rj[::-1], cj[::-1]
        cstar[:, j] = np.interp(m, rj, cj)
    return cstar.astype(np.float32)


# ---------------------------------------------------------------------------
# Device kernels
# ---------------------------------------------------------------------------

def _gather2d(img: jax.Array, ri: jax.Array, ci: jax.Array) -> jax.Array:
    """img (H, W, B); ri/ci int32 arrays (...,) -> (..., B). Indices must
    be pre-clipped."""
    h, w, b = img.shape
    flat = img.reshape(-1, b)
    idx = ri * w + ci
    return jnp.take(flat, idx.reshape(-1), axis=0).reshape(idx.shape + (b,))


@partial(jax.jit, static_argnames=("fill",))
def warp_nearest(img: jax.Array, rows: jax.Array, cols: jax.Array,
                 nodata: Optional[float] = None,
                 fill: float = NO_DATA_VALUE) -> jax.Array:
    h, w, _ = img.shape
    ri = jnp.rint(rows).astype(jnp.int32)
    ci = jnp.rint(cols).astype(jnp.int32)
    inside = (ri >= 0) & (ri < h) & (ci >= 0) & (ci < w)
    out = _gather2d(img, jnp.clip(ri, 0, h - 1), jnp.clip(ci, 0, w - 1))
    bad = ~inside[..., None]
    if nodata is not None:
        # non-finite sources are invalid too (package-wide nodata
        # contract, same as warp_interpolate / block_average)
        bad = bad | (out == nodata) | ~jnp.isfinite(out)
    return jnp.where(bad, jnp.asarray(fill, out.dtype), out)


#: matmul precisions of the warps by name: "highest" keeps float32
#: products; "default" lets the GPU round them to TF32 (quick-look only)
_PRECISIONS = {"highest": jax.lax.Precision.HIGHEST,
               "default": jax.lax.Precision.DEFAULT}


def cubic_kernel_weight(x, a: float = -0.5, xp=jnp):
    """GDAL's cubic-convolution kernel (a = -0.5, Catmull-Rom-style)
    at signed pixel distance ``x``. THE single definition — the gather
    kernel, the separable weight matrices, and the two-pass banded
    profiles must stay numerically identical, so they all call this
    (``xp``: jnp when traced, np for host-side weight matrices)."""
    ax = xp.abs(x)
    w1 = (a + 2.0) * ax ** 3 - (a + 3.0) * ax ** 2 + 1.0
    w2 = a * ax ** 3 - 5.0 * a * ax ** 2 + 8.0 * a * ax - 4.0 * a
    return xp.where(ax <= 1.0, w1, xp.where(ax < 2.0, w2, 0.0))


def _cubic_weights(t: jax.Array, a: float = -0.5):
    """Cubic convolution weights for offsets (-1, 0, 1, 2) relative to the
    floor sample; t in [0, 1)."""
    k = lambda x: cubic_kernel_weight(x, a=a, xp=jnp)
    return [k(t + 1.0), k(t), k(1.0 - t), k(2.0 - t)]


@partial(jax.jit, static_argnames=("method", "fill"))
def warp_interpolate(img: jax.Array, rows: jax.Array, cols: jax.Array,
                     nodata: Optional[float] = None,
                     method: str = "bilinear",
                     fill: float = NO_DATA_VALUE) -> jax.Array:
    """Bilinear / cubic warp with nodata-excluded weight renormalisation.
    img (H, W, B), rows/cols (...,) fractional indices -> (..., B)."""
    h, w, b = img.shape
    r0 = jnp.floor(rows)
    c0 = jnp.floor(cols)
    tr = rows - r0
    tc = cols - c0
    r0i = r0.astype(jnp.int32)
    c0i = c0.astype(jnp.int32)

    if method == "bilinear":
        offsets = (0, 1)
        wr = [1.0 - tr, tr]
        wc = [1.0 - tc, tc]
    elif method == "cubic":
        offsets = (-1, 0, 1, 2)
        wr = _cubic_weights(tr)
        wc = _cubic_weights(tc)
    else:
        raise ValueError(f"Unknown method {method!r}")

    acc = jnp.zeros(rows.shape + (b,), dtype=jnp.float32)
    wacc = jnp.zeros(rows.shape + (1,), dtype=jnp.float32)
    for i, dr in enumerate(offsets):
        ri = r0i + dr
        rin = (ri >= 0) & (ri < h)
        ric = jnp.clip(ri, 0, h - 1)
        for j, dc in enumerate(offsets):
            ci = c0i + dc
            cin = (ci >= 0) & (ci < w)
            cic = jnp.clip(ci, 0, w - 1)
            v = _gather2d(img, ric, cic)
            wgt = (wr[i] * wc[j])[..., None]
            ok = (rin & cin)[..., None]
            if nodata is not None:
                ok = ok & (v != nodata) & jnp.isfinite(v)
            wgt = jnp.where(ok, wgt, 0.0)
            acc = acc + jnp.where(ok, v, 0.0) * wgt
            wacc = wacc + wgt

    # renormalise where some contributors were masked; empty -> fill.
    # eps guards cubic's signed weights summing to ~0.
    good = jnp.abs(wacc) > 1e-6
    out = jnp.where(good, acc / jnp.where(good, wacc, 1.0),
                    jnp.asarray(fill, jnp.float32))
    # destination centre outside source => fill (matches gdalwarp)
    centre_in = ((rows >= -0.5) & (rows <= h - 0.5)
                 & (cols >= -0.5) & (cols <= w - 0.5))[..., None]
    return jnp.where(centre_in, out, jnp.asarray(fill, jnp.float32))


@partial(jax.jit, static_argnames=("factor", "fill"))
def block_average(img: jax.Array, factor: int,
                  nodata: Optional[float] = None,
                  fill: float = NO_DATA_VALUE) -> jax.Array:
    """Exact integer-factor block mean over (H, W, B), excluding nodata —
    GDAL 'average' semantics for aligned grids (demo cell 73)."""
    h, w, b = img.shape
    hh, ww = h // factor, w // factor
    img = img[:hh * factor, :ww * factor, :]
    blocks = img.reshape(hh, factor, ww, factor, b)
    if nodata is not None:
        ok = (blocks != nodata) & jnp.isfinite(blocks)
    else:
        ok = jnp.isfinite(blocks)
    s = jnp.sum(jnp.where(ok, blocks, 0.0), axis=(1, 3))
    n = jnp.sum(ok, axis=(1, 3))
    return jnp.where(n > 0, s / jnp.maximum(n, 1),
                     jnp.asarray(fill, jnp.float32))


# ---------------------------------------------------------------------------
# Separable resampling as matmuls (same-CRS grid transfers)
# ---------------------------------------------------------------------------

def separable_weight_matrix(idx_1d: np.ndarray, src_size: int,
                            method: str = "bilinear",
                            scale: Optional[float] = None) -> np.ndarray:
    """(Dst, Src) float32 interpolation-weight matrix for one axis:
    row d holds the filter taps of fractional source index idx_1d[d]
    (2 taps bilinear, 4 taps cubic a=-0.5; 'average' holds box-overlap
    weights over ``scale`` source pixels — GDAL-average semantics for a
    downsample, demo cell 73). Out-of-range taps are dropped, so
    fully-outside rows are all-zero (detected downstream via the
    weight-sum channel). Turning interpolation into a dense matmul
    replaces the row-gather path with a matrix product."""
    idx = np.asarray(idx_1d, dtype=np.float64)
    dst = idx.shape[0]
    W = np.zeros((dst, src_size), dtype=np.float32)
    i0 = np.floor(idx).astype(np.int64)
    t = idx - i0
    if method == "average":
        # dst pixel d spans [idx[d]-s/2, idx[d]+s/2) in source index
        # coords; weight of src pixel j (spanning [j-0.5, j+0.5)) is the
        # overlap length, normalised by the covered mass downstream.
        if scale is None:
            if dst < 2:
                raise ValueError("average needs scale for a 1-row axis")
            scale = float(np.median(np.diff(idx)))
        s = abs(float(scale))
        lo = idx - s / 2.0
        hi = idx + s / 2.0
        j0 = np.floor(lo + 0.5).astype(np.int64)
        rows_d = np.arange(dst)
        centre_in = (idx >= -0.5) & (idx <= src_size - 0.5)
        for k in range(int(np.ceil(s)) + 1):
            j = j0 + k
            w = np.clip(np.minimum(hi, j + 0.5) - np.maximum(lo, j - 0.5),
                        0.0, 1.0) / s
            ok = (j >= 0) & (j < src_size) & centre_in & (w > 0)
            W[rows_d[ok], j[ok]] = w[ok].astype(np.float32)
        return W
    if method == "bilinear":
        taps = [(0, 1.0 - t), (1, t)]
    elif method == "cubic":
        k = lambda x: cubic_kernel_weight(x, xp=np)
        taps = [(-1, k(t + 1.0)), (0, k(t)), (1, k(1.0 - t)),
                (2, k(2.0 - t))]
    else:
        raise ValueError(f"Unknown method {method!r}")
    rows_d = np.arange(dst)
    centre_in = (idx >= -0.5) & (idx <= src_size - 0.5)
    for off, w in taps:
        cols_s = i0 + off
        ok = (cols_s >= 0) & (cols_s < src_size) & centre_in
        W[rows_d[ok], cols_s[ok]] = w[ok].astype(np.float32)
    return W


@partial(jax.jit, static_argnames=("fill", "fast"))
def separable_resample_matmul(img: jax.Array, Wr: jax.Array, Wc: jax.Array,
                              nodata: Optional[float] = None,
                              fill: float = NO_DATA_VALUE,
                              fast: bool = True,
                              valid_mask: Optional[jax.Array] = None
                              ) -> jax.Array:
    """img (Hs, Ws, B) resampled to (Hd, Wd, B) with row/col weight
    matrices Wr (Hd, Hs), Wc (Wd, Ws). Nodata-excluded renormalisation
    identical in semantics to ``warp_interpolate``: masked sources
    contribute zero and the weight mass is re-normalised per pixel.
    ``valid_mask`` (Hs, Ws) marks validity shared by all bands — one
    1-band weight-mass matmul instead of a per-band one, and it also
    excludes NaN sources (which a scalar ``nodata`` compare cannot)."""
    precision = (jax.lax.Precision.DEFAULT if fast
                 else jax.lax.Precision.HIGHEST)
    def mm(arr):
        # (Hd, Hs) @ (Hs, Ws, B) @ (Ws, Wd)^T -> (Hd, Wd, B)
        t1 = jnp.einsum("dh,hwb->dwb", Wr, arr, precision=precision)
        return jnp.einsum("ew,dwb->deb", Wc, t1, precision=precision)

    if valid_mask is not None:
        ok = valid_mask[..., None]
        if nodata is not None:
            # both given: the shared mask AND the per-band sentinel
            # screen apply (den becomes per-band again)
            ok = ok & (img != nodata) & jnp.isfinite(img)
            den = mm(ok.astype(jnp.float32))
        else:
            den = mm(valid_mask.astype(jnp.float32)[..., None])
        num = mm(jnp.where(ok, img, 0.0))
    elif nodata is not None:
        ok = (img != nodata) & jnp.isfinite(img)
        num = mm(jnp.where(ok, img, 0.0))
        den = mm(ok.astype(jnp.float32))
    else:
        num = mm(img)
        # without a nodata mask the weight mass is separable: a rank-1
        # outer product instead of a second full-size matmul
        den = jnp.outer(jnp.sum(Wr, axis=1), jnp.sum(Wc, axis=1))[..., None]
    good = jnp.abs(den) > 1e-6
    return jnp.where(good, num / jnp.where(good, den, 1.0),
                     jnp.asarray(fill, jnp.float32))


# ---------------------------------------------------------------------------
# Separable resampling, integer-aligned fast paths (elementwise, no
# weight matrices)
# ---------------------------------------------------------------------------
#
# The dense (Dst, Src) weight matrices above are >97 % structural zeros
# for the production grid transfers: the S2-anchored contract
# (core/grid.s2_anchored_target_grid, reference _compute_te
# emit_proj.py:354-382) makes the 10 m <-> 60 m transfers EXACT
# integer-ratio aligned operations. For those, the average downsample is
# a pad + reshape + block-sum and the bilinear upsample is a
# phase-cycled lerp of shifted slices — a few GB of elementwise traffic
# instead of ~1.8 TFLOP of dense matrix products plus ~220 MB of
# resident weight matrices. ``separable_fast_spec`` detects the structure
# host-side and returns a small hashable spec; ``separable_resample_fast``
# reproduces ``separable_resample_matmul``'s nodata/renormalisation
# semantics exactly (dropped out-of-range taps == zero padding; fill
# where the centre leaves the source or the covered mass vanishes).

def separable_fast_spec(idx_1d: np.ndarray, src_size: int,
                        method: str = "bilinear",
                        scale: Optional[float] = None,
                        tol: float = 2e-3):
    """Detect integer-aligned structure in a separable index field.

    Returns a hashable spec tuple or None (caller falls back to the
    weight-matrix path).

    - ``average`` with uniform integer step f and block-aligned spans:
      ``("avg", f, j0, dst, src, cin_lo, cin_hi)`` — dst cell d covers
      source pixels ``[j0 + f*d, j0 + f*(d+1))`` with equal weights.
    - ``bilinear`` with uniform step 1/f (integer f >= 1):
      ``("bilin", f, (r0 per phase...), (t per phase...), dst, src,
      cin_lo, cin_hi)`` — out[k*f + p] lerps source ``r0[p]+k`` and
      ``r0[p]+k+1`` with constant fraction ``t[p]``.

    ``cin_lo:cin_hi`` is the destination index range whose centres lie
    inside the source extent (outside -> fill, matching the all-zero
    rows the matrix builder emits).
    """
    idx = np.asarray(idx_1d, dtype=np.float64)
    dst = idx.shape[0]
    if dst == 0:
        return None
    cin = (idx >= -0.5) & (idx <= src_size - 0.5)
    if cin.any():
        cin_lo = int(np.argmax(cin))
        cin_hi = int(dst - np.argmax(cin[::-1]))
        if not cin[cin_lo:cin_hi].all():  # non-contiguous: bail
            return None
    else:
        cin_lo = cin_hi = 0
    if method == "average":
        if dst >= 2:
            d = np.diff(idx)
            f = d[0]
            if not np.allclose(d, f, rtol=0, atol=tol):
                return None
        else:
            f = float(scale) if scale is not None else None
            if f is None:
                return None
        fi = int(round(f))
        if fi < 1 or abs(f - fi) > tol:
            return None
        if scale is not None and abs(abs(float(scale)) - fi) > tol:
            return None
        # block alignment: lo + 0.5 = idx - f/2 + 0.5 must be integer
        j0f = idx[0] - fi / 2.0 + 0.5
        j0 = int(round(j0f))
        if abs(j0f - j0) > tol:
            return None
        return ("avg", fi, j0, dst, int(src_size), cin_lo, cin_hi)
    if method == "bilinear":
        if dst >= 2:
            d = np.diff(idx)
            s = d[0]
            if s <= 0 or not np.allclose(d, s, rtol=0, atol=tol):
                return None
            f = int(round(1.0 / s))
            if f < 1 or abs(s - 1.0 / f) > tol / max(dst, 1):
                return None
        else:
            f = 1
        r0s, ts = [], []
        for p in range(min(f, dst)):
            ph = idx[p::f]
            r0 = np.floor(ph).astype(np.int64)
            t = ph - r0
            if not (np.all(np.diff(r0) == 1)
                    and np.allclose(t, t[0], rtol=0, atol=tol)):
                return None
            r0s.append(int(r0[0]))
            ts.append(float(np.median(t)))
        if len(r0s) < f:  # dst shorter than one period
            base = r0s[0] if r0s else 0
            while len(r0s) < f:
                r0s.append(base)
                ts.append(0.0)
        return ("bilin", f, tuple(r0s), tuple(ts), dst, int(src_size),
                cin_lo, cin_hi)
    return None


def _fast_pass(arr: jax.Array, spec, axis: int) -> jax.Array:
    """One fast separable pass along ``axis`` (0 or 1) of (H, W, B).

    Returns the raw weighted sums (average: block-sum / f; bilinear:
    two-tap lerp). Out-of-range taps contribute zero (matching dropped
    matrix taps); centre-in masking is applied by the caller."""
    kind, f = spec[0], spec[1]
    size = arr.shape[axis]
    if kind == "avg":
        _, _, j0, dst, _src, _lo, _hi = spec
        lo_pad = max(0, -j0)
        hi_pad = max(0, j0 + f * dst - size)
        pw = [(0, 0), (0, 0), (0, 0)]
        pw[axis] = (lo_pad, hi_pad)
        a = jnp.pad(arr, pw) if (lo_pad or hi_pad) else arr
        start = j0 + lo_pad
        if axis == 0:
            a = jax.lax.slice_in_dim(a, start, start + f * dst, axis=0)
            a = a.reshape(dst, f, a.shape[1], a.shape[2])
            return jnp.sum(a, axis=1) * jnp.float32(1.0 / f)
        a = jax.lax.slice_in_dim(a, start, start + f * dst, axis=1)
        a = a.reshape(a.shape[0], dst, f, a.shape[2])
        return jnp.sum(a, axis=2) * jnp.float32(1.0 / f)
    # bilinear
    _, _, r0s, ts, dst, _src, _lo, _hi = spec
    n_full = (dst + f - 1) // f
    lo_pad = max(0, -min(r0s))
    hi_pad = max(0, max(r0s) + n_full + 1 - size)
    pw = [(0, 0), (0, 0), (0, 0)]
    pw[axis] = (lo_pad, hi_pad)
    a = jnp.pad(arr, pw) if (lo_pad or hi_pad) else arr
    phases = []
    for p in range(f):
        s0 = r0s[p] + lo_pad
        seg0 = jax.lax.slice_in_dim(a, s0, s0 + n_full, axis=axis)
        seg1 = jax.lax.slice_in_dim(a, s0 + 1, s0 + 1 + n_full, axis=axis)
        t = jnp.float32(ts[p])
        phases.append(seg0 * (1.0 - t) + seg1 * t)
    out = jnp.stack(phases, axis=axis + 1)  # (..., n_full, f, ...)
    if axis == 0:
        out = out.reshape(n_full * f, out.shape[2], out.shape[3])
        return out[:dst]
    out = out.reshape(out.shape[0], n_full * f, out.shape[3])
    return out[:, :dst]


def _fast_pass_2d(arr: jax.Array, spec, axis: int) -> jax.Array:
    """2-D (H, W) variant of :func:`_fast_pass` — same pad/reshape
    block-sum (average) and phase-cycled slice lerps (bilinear), but
    with no trailing channel axis. Run under ``jax.vmap`` over a
    LEADING channel axis for channel-major (C, H, W) pipelines: every
    elementwise op then has the W axis minor instead of a 3-wide
    channel axis."""
    kind, f = spec[0], spec[1]
    size = arr.shape[axis]
    if kind == "avg":
        _, _, j0, dst, _src, _lo, _hi = spec
        lo_pad = max(0, -j0)
        hi_pad = max(0, j0 + f * dst - size)
        pw = [(0, 0), (0, 0)]
        pw[axis] = (lo_pad, hi_pad)
        a = jnp.pad(arr, pw) if (lo_pad or hi_pad) else arr
        start = j0 + lo_pad
        a = jax.lax.slice_in_dim(a, start, start + f * dst, axis=axis)
        if axis == 0:
            a = a.reshape(dst, f, a.shape[1])
            return jnp.sum(a, axis=1) * jnp.float32(1.0 / f)
        a = a.reshape(a.shape[0], dst, f)
        return jnp.sum(a, axis=2) * jnp.float32(1.0 / f)
    _, _, r0s, ts, dst, _src, _lo, _hi = spec
    n_full = (dst + f - 1) // f
    lo_pad = max(0, -min(r0s))
    hi_pad = max(0, max(r0s) + n_full + 1 - size)
    pw = [(0, 0), (0, 0)]
    pw[axis] = (lo_pad, hi_pad)
    a = jnp.pad(arr, pw) if (lo_pad or hi_pad) else arr
    phases = []
    for p in range(f):
        s0 = r0s[p] + lo_pad
        seg0 = jax.lax.slice_in_dim(a, s0, s0 + n_full, axis=axis)
        seg1 = jax.lax.slice_in_dim(a, s0 + 1, s0 + 1 + n_full,
                                    axis=axis)
        t = jnp.float32(ts[p])
        phases.append(seg0 * (1.0 - t) + seg1 * t)
    out = jnp.stack(phases, axis=axis + 1)
    if axis == 0:
        out = out.reshape(n_full * f, out.shape[2])
        return out[:dst]
    out = out.reshape(out.shape[0], n_full * f)
    return out[:, :dst]


@partial(jax.jit, static_argnames=("spec_r", "spec_c", "fill"))
def separable_resample_fast_cmajor(img_chw: jax.Array, spec_r, spec_c,
                                   nodata: Optional[float] = None,
                                   fill: float = NO_DATA_VALUE,
                                   valid_mask: Optional[jax.Array] = None
                                   ) -> jax.Array:
    """Channel-major (C, H, W) twin of :func:`separable_resample_fast`
    (same nodata-excluded renormalisation; NaN/other fill): channels
    ride a vmapped leading axis and W stays minor, instead of the
    3-wide channel axis being minor in every elementwise op of the
    upsample epilogue. Not the default (``up_layout="cminor"``); the
    A/B on the GPU is open."""
    img_chw = img_chw.astype(jnp.float32)
    two = lambda x: _fast_pass_2d(_fast_pass_2d(x, spec_r, 0),
                                  spec_c, 1)
    if valid_mask is not None:
        ok = valid_mask[None]
        if nodata is not None:
            ok = ok & (img_chw != nodata) & jnp.isfinite(img_chw)
            den = jax.vmap(two)(ok.astype(jnp.float32))
        else:
            den = two(valid_mask.astype(jnp.float32))[None]
        num = jax.vmap(two)(jnp.where(ok, img_chw, 0.0))
    elif nodata is not None:
        ok = (img_chw != nodata) & jnp.isfinite(img_chw)
        num = jax.vmap(two)(jnp.where(ok, img_chw, 0.0))
        den = jax.vmap(two)(ok.astype(jnp.float32))
    else:
        num = jax.vmap(two)(img_chw)
        den = two(jnp.ones(img_chw.shape[1:], jnp.float32))[None]
    good = jnp.abs(den) > 1e-6
    r_in = ((jnp.arange(num.shape[1]) >= spec_r[-2])
            & (jnp.arange(num.shape[1]) < spec_r[-1]))
    c_in = ((jnp.arange(num.shape[2]) >= spec_c[-2])
            & (jnp.arange(num.shape[2]) < spec_c[-1]))
    good = good & r_in[None, :, None] & c_in[None, None, :]
    return jnp.where(good, num / jnp.where(good, den, 1.0),
                     jnp.asarray(fill, jnp.float32))


@partial(jax.jit, static_argnames=("spec_r", "spec_c", "fill"))
def separable_resample_fast(img: jax.Array, spec_r, spec_c,
                            nodata: Optional[float] = None,
                            fill: float = NO_DATA_VALUE,
                            valid_mask: Optional[jax.Array] = None
                            ) -> jax.Array:
    """Integer-aligned equivalent of ``separable_resample_matmul``:
    identical nodata-excluded renormalisation, computed as pad/reshape
    block sums (average) and phase-cycled slice lerps (bilinear).
    Exact in f32 (the matmul path's DEFAULT precision may round its
    products to TF32 on the GPU)."""
    img = img.astype(jnp.float32)

    def passes(arr):
        return _fast_pass(_fast_pass(arr, spec_r, 0), spec_c, 1)

    if valid_mask is not None:
        ok = valid_mask[..., None]
        if nodata is not None:
            ok = ok & (img != nodata) & jnp.isfinite(img)
            den = passes(ok.astype(jnp.float32))
        else:
            den = passes(valid_mask.astype(jnp.float32)[..., None])
        num = passes(jnp.where(ok, img, 0.0))
    elif nodata is not None:
        ok = (img != nodata) & jnp.isfinite(img)
        num = passes(jnp.where(ok, img, 0.0))
        den = passes(ok.astype(jnp.float32))
    else:
        num = passes(img)
        den = passes(jnp.ones(img.shape[:2] + (1,), jnp.float32))
    good = jnp.abs(den) > 1e-6
    r_in = ((jnp.arange(num.shape[0]) >= spec_r[-2])
            & (jnp.arange(num.shape[0]) < spec_r[-1]))
    c_in = ((jnp.arange(num.shape[1]) >= spec_c[-2])
            & (jnp.arange(num.shape[1]) < spec_c[-1]))
    good = good & r_in[:, None, None] & c_in[None, :, None]
    return jnp.where(good, num / jnp.where(good, den, 1.0),
                     jnp.asarray(fill, jnp.float32))


# ---------------------------------------------------------------------------
# High-level API
# ---------------------------------------------------------------------------

def _integer_factor(src_grid: Grid, dst_grid: Grid) -> Optional[int]:
    if src_grid.crs != dst_grid.crs:
        return None
    fx = dst_grid.dx / src_grid.dx
    fy = dst_grid.dy / src_grid.dy
    if abs(fx - round(fx)) > 1e-9 or abs(fy - round(fy)) > 1e-9:
        return None
    if round(fx) != round(fy) or round(fx) < 1:
        return None
    f = int(round(fx))
    # grids must be aligned: dst origin on src pixel boundary
    ox = (dst_grid.x0 - src_grid.x0) / src_grid.dx
    oy = (src_grid.y0 - dst_grid.y0) / src_grid.dy
    if abs(ox - round(ox)) > 1e-6 or abs(oy - round(oy)) > 1e-6:
        return None
    return f


@partial(jax.jit, static_argnames=("method", "fill"))
def warp_interpolate_taploop(img: jax.Array, rows: jax.Array,
                             cols: jax.Array,
                             nodata: Optional[float] = None,
                             method: str = "cubic",
                             fill: float = NO_DATA_VALUE) -> jax.Array:
    """Memory-bounded variant of ``warp_interpolate`` for deep cubes: a
    sequential ``fori_loop`` over the filter taps (16 for cubic, 4 for
    bilinear). Each iteration gathers the *full-width* spectral rows
    (285 x 4 B = 1.1 KB contiguous per row — a wide, efficient gather,
    unlike narrow band-chunk rows) and accumulates; only one tap
    temporary is live at a time, so peak HBM stays ~3 cubes instead of
    ~16."""
    h, w, b = img.shape
    r0 = jnp.floor(rows)
    c0 = jnp.floor(cols)
    tr = rows - r0
    tc = cols - c0
    r0i = r0.astype(jnp.int32)
    c0i = c0.astype(jnp.int32)

    if method == "bilinear":
        offsets = (0, 1)
        wr = jnp.stack([1.0 - tr, tr])                  # (T, ...)
        wc = jnp.stack([1.0 - tc, tc])
    elif method == "cubic":
        offsets = (-1, 0, 1, 2)
        wr = jnp.stack(_cubic_weights(tr))
        wc = jnp.stack(_cubic_weights(tc))
    else:
        raise ValueError(f"Unknown method {method!r}")
    n_t = len(offsets)
    off = jnp.asarray(offsets, dtype=jnp.int32)

    def body(i, carry):
        acc, wacc = carry
        ti = i // n_t
        tj = i % n_t
        ri = r0i + off[ti]
        ci = c0i + off[tj]
        rin = (ri >= 0) & (ri < h)
        cin = (ci >= 0) & (ci < w)
        v = _gather2d(img, jnp.clip(ri, 0, h - 1), jnp.clip(ci, 0, w - 1))
        wgt = (wr[ti] * wc[tj])[..., None]
        ok = (rin & cin)[..., None]
        if nodata is not None:
            ok = ok & (v != nodata) & jnp.isfinite(v)
        wgt = jnp.where(ok, wgt, 0.0)
        return ((acc + jnp.where(ok, v, 0.0) * wgt).astype(jnp.float32),
                (wacc + wgt).astype(jnp.float32))

    acc = jnp.zeros(rows.shape + (b,), dtype=jnp.float32)
    # per-band weight mass: nodata masking is per band element
    wacc = jnp.zeros(rows.shape + (b,), dtype=jnp.float32)
    acc, wacc = jax.lax.fori_loop(0, n_t * n_t, body, (acc, wacc))

    good = jnp.abs(wacc) > 1e-6
    out = jnp.where(good, acc / jnp.where(good, wacc, 1.0),
                    jnp.asarray(fill, jnp.float32))
    centre_in = ((rows >= -0.5) & (rows <= h - 0.5)
                 & (cols >= -0.5) & (cols <= w - 0.5))[..., None]
    return jnp.where(centre_in, out, jnp.asarray(fill, jnp.float32))


@partial(jax.jit, static_argnames=("method", "fill", "row_chunks"))
def orthowarp_taploop(raw: jax.Array, glt_flat_idx: jax.Array,
                      glt_valid: jax.Array, rows: jax.Array,
                      cols: jax.Array, method: str = "cubic",
                      fill: float = NO_DATA_VALUE,
                      row_chunks: int = 4) -> jax.Array:
    """Fused GLT-orthorectification + resampling warp.

    The reference materialises the GLT-gathered geographic cube and then
    gdalwarps it (emit_proj.py:982 + :876-940). Because the GLT step is a
    nearest gather, the composition ``warp(ortho)[d] = sum_taps w *
    ortho[tap] = sum_taps w * raw[glt[tap]]`` is exact — so each filter
    tap gathers *through* the GLT straight from the raw swath cube. The
    multi-GB ortho intermediate never exists, and validity is the
    per-pixel GLT mask (no per-band nodata testing).

    Peak-HBM control: the sequential loop runs over (tap x row-block)
    pairs; each iteration gathers only a 1/row_chunks slab of the
    destination, so the live temporary is the accumulator plus one slab.

    raw (h, w, B); glt_flat_idx (Ho, Wo) int32 0-based flat raw indices;
    glt_valid (Ho, Wo) bool; rows/cols fractional *ortho-grid* indices of
    the destination pixels. Bit-identical to glt_gather + warp_interpolate
    wherever the ortho fill value never leaks through (the fill is
    excluded by masking rather than by value).
    """
    b = raw.shape[-1]
    raw_flat = raw.reshape(-1, b)
    ho, wo = glt_flat_idx.shape
    glt_flat = glt_flat_idx.reshape(-1)
    valid_flat = glt_valid.reshape(-1)

    hd, wd = rows.shape
    chunk = -(-hd // row_chunks)
    pad_rows = chunk * row_chunks - hd
    if pad_rows:
        # padded rows sit far outside the source => fill at the end
        rows = jnp.concatenate(
            [rows, jnp.full((pad_rows, wd), -1e6, rows.dtype)], axis=0)
        cols = jnp.concatenate(
            [cols, jnp.full((pad_rows, wd), -1e6, cols.dtype)], axis=0)
    hp = hd + pad_rows

    r0 = jnp.floor(rows)
    c0 = jnp.floor(cols)
    tr = rows - r0
    tc = cols - c0
    r0i = r0.astype(jnp.int32)
    c0i = c0.astype(jnp.int32)

    if method == "bilinear":
        offsets = (0, 1)
        wr = jnp.stack([1.0 - tr, tr])
        wc = jnp.stack([1.0 - tc, tc])
    elif method == "cubic":
        offsets = (-1, 0, 1, 2)
        wr = jnp.stack(_cubic_weights(tr))
        wc = jnp.stack(_cubic_weights(tc))
    else:
        raise ValueError(f"Unknown method {method!r}")
    n_t = len(offsets)
    off = jnp.asarray(offsets, dtype=jnp.int32)
    n_iter = n_t * n_t * row_chunks

    def body(i, carry):
        acc, wacc = carry
        tap = i // row_chunks
        blk = i % row_chunks
        ti = tap // n_t
        tj = tap % n_t
        rstart = blk * chunk
        ri = jax.lax.dynamic_slice(r0i, (rstart, 0), (chunk, wd)) + off[ti]
        ci = jax.lax.dynamic_slice(c0i, (rstart, 0), (chunk, wd)) + off[tj]
        wgt_slab = (jax.lax.dynamic_slice(wr, (ti, rstart, 0),
                                          (1, chunk, wd))[0]
                    * jax.lax.dynamic_slice(wc, (tj, rstart, 0),
                                            (1, chunk, wd))[0])
        rin = (ri >= 0) & (ri < ho)
        cin = (ci >= 0) & (ci < wo)
        oidx = (jnp.clip(ri, 0, ho - 1) * wo
                + jnp.clip(ci, 0, wo - 1)).reshape(-1)
        raw_idx = jnp.take(glt_flat, oidx)
        ok = (jnp.take(valid_flat, oidx).reshape(ri.shape) & rin & cin)
        v = jnp.take(raw_flat, raw_idx, axis=0).reshape(ri.shape + (b,))
        wgt = jnp.where(ok, wgt_slab, 0.0)[..., None]
        acc = jax.lax.dynamic_update_slice(
            acc,
            (jax.lax.dynamic_slice(acc, (rstart, 0, 0), (chunk, wd, b))
             + v * wgt).astype(jnp.float32),
            (rstart, 0, 0))
        wacc = jax.lax.dynamic_update_slice(
            wacc,
            (jax.lax.dynamic_slice(wacc, (rstart, 0, 0), (chunk, wd, 1))
             + wgt).astype(jnp.float32),
            (rstart, 0, 0))
        return acc, wacc

    # derive the zero initialisers from the coordinate field so they
    # carry its sharding (under shard_map the loop carry must vary over
    # the same mesh axes as the body output)
    zero_plane = (rows * 0.0).astype(jnp.float32)[..., None]
    acc = jnp.broadcast_to(zero_plane, (hp, wd, b)) + 0.0
    wacc = zero_plane + 0.0
    acc, wacc = jax.lax.fori_loop(0, n_iter, body, (acc, wacc))

    good = jnp.abs(wacc) > 1e-6
    out = jnp.where(good, acc / jnp.where(good, wacc, 1.0),
                    jnp.asarray(fill, jnp.float32))
    centre_in = ((rows >= -0.5) & (rows <= ho - 0.5)
                 & (cols >= -0.5) & (cols <= wo - 0.5))[..., None]
    out = jnp.where(centre_in, out, jnp.asarray(fill, jnp.float32))
    return out[:hd]


def _kernel_profile(dist: jax.Array, method: str) -> jax.Array:
    """Resampling weight of a source sample at signed pixel distance
    ``dist`` from the sampling position. Evaluating this over an iota
    yields the banded interpolation matrix whose rows are exactly the
    per-tap weights of ``warp_interpolate`` (cubic a = -0.5)."""
    if method == "bilinear":
        return jnp.maximum(0.0, 1.0 - jnp.abs(dist))
    if method != "cubic":
        raise ValueError(f"Unknown method {method!r}")
    return cubic_kernel_weight(dist, xp=jnp)


@partial(jax.jit,
         static_argnames=("method", "fill", "block_rows_src",
                          "block_rows_dst", "precision", "banded_group"))
def orthowarp_two_pass(raw: jax.Array, glt_flat_idx: jax.Array,
                       glt_valid: jax.Array, rows: jax.Array,
                       cols: jax.Array, cstar: jax.Array,
                       method: str = "cubic",
                       fill: float = NO_DATA_VALUE,
                       block_rows_src: int = 64,
                       block_rows_dst: int = 64,
                       precision: str = "highest",
                       banded_group: Optional[int] = None) -> jax.Array:
    """Two-pass (Catmull-Smith scanline) fused GLT + warp as matmuls.

    ``orthowarp_taploop`` is gather-transaction-bound: 16 cubic taps x one
    HBM row transaction per destination pixel. This variant replaces the
    per-pixel 2D gathers with two banded-matrix multiplies: pass 1
    resamples every source scanline horizontally at the destination
    columns' preimage positions (``cstar`` from :func:`scanline_cstar`);
    pass 2 resamples vertically at the ``rows`` field. The banded weight
    matrices are built on the fly by evaluating the interpolation kernel
    at (index - iota) distances, and a validity channel is carried through
    both contractions so a single final division reproduces the taploop's
    joint nodata renormalisation.

    Exactness: identical sampling *positions* (the pass-1 curve inversion
    is exact where the preimage curves are monotone), but the effective 2D
    kernel is the scanline-sheared tensor product rather than the axis-
    aligned one, so values differ from ``orthowarp_taploop`` by
    O(shear^2) — sub-1e-3 reflectance for EMIT-scale meridian convergence
    (see tests). Use the taploop for bit parity with gdalwarp semantics;
    use this for speed (dense matmuls instead of per-tap gathers).

    ``banded_group``: None contracts every destination sample against
    the full source axis (:func:`_two_pass_core`); a group (the second
    value :func:`select_warp_backend` returns, after its host feasibility
    check) contracts each destination tile against one 384-sample source
    window (:func:`banded_two_pass` — the same taps, ~4x fewer
    multiply-adds at granule geometry). ``block_rows_src`` source rows
    (pass 1) and ``block_rows_dst`` destination rows (dense pass 2) or
    columns (banded pass 2) are contracted per loop step in either form.

    ``precision``: "highest" (default: full float32 products — on the
    GPU, lower precisions may run as TF32, whose ~1e-3 relative error is
    above the 1e-4 step of the u16 reflectance product) or "default"
    (quick-look only).
    """
    b = raw.shape[-1]
    raw_flat = raw.reshape(-1, b)
    ho, wo = glt_flat_idx.shape
    prec = _PRECISIONS[precision]

    # GLT materialisation (1 gather) + validity channel
    v = jnp.take(raw_flat, glt_flat_idx.reshape(-1),
                 axis=0).reshape(ho, wo, b)
    valid = glt_valid.astype(jnp.float32)[..., None]
    src_ext = jnp.concatenate([v * valid, valid], axis=-1)

    if banded_group is not None:
        out_ext = banded_two_pass(src_ext, rows, cstar, method, precision,
                                  banded_group, block_rows_src=block_rows_src,
                                  block_rows_dst=block_rows_dst)
    else:
        out_ext = _two_pass_core(src_ext, rows, cstar, method,
                                 block_rows_src, block_rows_dst, prec)
    den = out_ext[..., -1:]
    good = jnp.abs(den) > 1e-6
    res = jnp.where(good, out_ext[..., :b] / jnp.where(good, den, 1.0),
                    jnp.asarray(fill, jnp.float32))
    centre_in = ((rows >= -0.5) & (rows <= ho - 0.5)
                 & (cols >= -0.5) & (cols <= wo - 0.5))[..., None]
    return jnp.where(centre_in, res, jnp.asarray(fill, jnp.float32))


def _two_pass_pass1(src_ext: jax.Array, cstar: jax.Array, wd: int,
                    method: str, block_rows_src: int, prec) -> jax.Array:
    """Horizontal pass: resample every source scanline at the ``cstar``
    positions. src_ext (Ho, Wo, C) -> h in pass-2 layout (Wd, Ho, C).
    (Building h directly transposed keeps one multi-GB intermediate.)"""
    ho, wo, be = src_ext.shape
    mb = block_rows_src
    n1 = -(-ho // mb)
    src_p = jnp.pad(src_ext, ((0, n1 * mb - ho), (0, 0), (0, 0)))
    cstar_p = jnp.pad(cstar.astype(jnp.float32),
                      ((0, n1 * mb - ho), (0, 0)),
                      constant_values=-1e6)
    iota_c = jnp.arange(wo, dtype=jnp.float32)

    def body1(i, h):
        m0 = i * mb
        slab = jax.lax.dynamic_slice(src_p, (m0, 0, 0), (mb, wo, be))
        cs = jax.lax.dynamic_slice(cstar_p, (m0, 0), (mb, wd))
        W1 = _kernel_profile(cs[:, :, None] - iota_c[None, None, :], method)
        hblk = jnp.einsum("mjc,mcb->jmb", W1, slab, precision=prec)
        return jax.lax.dynamic_update_slice(h, hblk, (0, m0, 0))

    # derive the zero carry from the inputs so it inherits their varying
    # manual axes under shard_map (a plain jnp.zeros would be unsharded)
    zero = (cstar[0, 0] * 0.0 + src_ext[0, 0, 0] * 0.0).astype(jnp.float32)
    h_t = jnp.zeros((wd, n1 * mb, be), jnp.float32) + zero
    return jax.lax.fori_loop(0, n1, body1, h_t)[:, :ho]


def _two_pass_pass2(h_t: jax.Array, rows: jax.Array, method: str,
                    block_rows_dst: int, prec,
                    m_valid: Optional[jax.Array] = None) -> jax.Array:
    """Vertical pass: resample the scanline intermediate h_t (Wd, M, C)
    at the ``rows`` field (fractional indices into h_t's M axis).
    ``m_valid`` (M,) optionally zeroes scanlines that must not contribute
    (e.g. halo rows replicated past the global image edge)."""
    wd, m_rows, be = h_t.shape
    hd = rows.shape[0]
    rb = block_rows_dst
    n2 = -(-hd // rb)
    rows_p = jnp.pad(rows, ((0, n2 * rb - hd), (0, 0)),
                     constant_values=-1e6)
    iota_m = jnp.arange(m_rows, dtype=jnp.float32)

    def body2(i, out):
        r0 = i * rb
        rs = jax.lax.dynamic_slice(rows_p, (r0, 0), (rb, wd))
        V = _kernel_profile(rs[:, :, None] - iota_m[None, None, :], method)
        if m_valid is not None:
            V = V * m_valid[None, None, :]
        oblk = jnp.einsum("rjm,jmb->rjb", V, h_t, precision=prec)
        return jax.lax.dynamic_update_slice(out, oblk, (r0, 0, 0))

    zero = (rows[0, 0] * 0.0 + h_t[0, 0, 0] * 0.0).astype(jnp.float32)
    out_ext = jnp.zeros((n2 * rb, wd, be), jnp.float32) + zero
    return jax.lax.fori_loop(0, n2, body2, out_ext)[:hd]


def _two_pass_core(src_ext: jax.Array, rows: jax.Array, cstar: jax.Array,
                   method: str, block_rows_src: int, block_rows_dst: int,
                   prec) -> jax.Array:
    """Shared scanline machinery: horizontal pass over source scanlines
    at the ``cstar`` positions, then vertical pass at the ``rows`` field.
    src_ext (Ho, Wo, C) already carries whatever validity channels the
    caller wants renormalised; returns (Hd, Wd, C)."""
    wd = rows.shape[1]
    h_t = _two_pass_pass1(src_ext, cstar, wd, method, block_rows_src, prec)
    return _two_pass_pass2(h_t, rows, method, block_rows_dst, prec)


# ---------------------------------------------------------------------------
# Banded two-pass warp: each destination tile contracts one source window
# ---------------------------------------------------------------------------
#
# The dense passes above multiply banded weight matrices whose support is
# ~4 taps wide against the FULL source axis (~1500 samples at granule
# scale). The banded form gathers, for each tile of BANDED_DTILE
# destination samples shared by ``group`` scanlines (pass 1) or columns
# (pass 2), one window of BANDED_NBLK x BANDED_WBLK source samples that
# starts on a BANDED_WBLK boundary; builds that tile's (BANDED_DTILE,
# window) weights elementwise; and contracts all tiles of a row (column)
# block with one batched dot_general. Pass 2 consumes pass 1's
# (scanline, column, channel) layout directly, so no full-size transpose
# of the intermediate is needed. The 128-sample tile and block sizes
# were inherited from the (8, 128) tiling of the accelerator this warp
# was first written for, and are untuned on the GPU.

BANDED_WBLK = 128      # window start granularity (source samples)
BANDED_NBLK = 3        # window = 3 blocks = 384 samples
BANDED_DTILE = 128     # destination samples per tile
#: window-sharing group sizes tried by :func:`select_banded_group`,
#: largest first: a larger group gathers longer contiguous runs of the
#: pass-1 intermediate in pass 2
BANDED_GROUP_CANDIDATES = (32, 16, 8, 4)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def banded_spans_ok(pos: np.ndarray, group: int = 8,
                    nblk: int = BANDED_NBLK,
                    dtile: int = BANDED_DTILE) -> bool:
    """HOST feasibility check for :func:`banded_two_pass`: every
    (``group`` leading rows x ``dtile`` destination samples) block of the
    position field ``pos`` (R, D) must span at most the window minus one
    block of start-rounding slack minus the cubic support (251 samples
    at the default 3 x 128 window). True for near-1:1 scanline warps
    (the EMIT ortho->UTM case); False for strong down/upsampling, where
    the dense path applies. Blocks whose span exceeds the window would
    lose taps and come out as nodata, not garbage."""
    pos = np.asarray(pos, dtype=np.float64)
    if pos.ndim == 1:
        pos = pos[None, :]
    r, d = pos.shape
    g = max(1, int(group))
    max_span = nblk * BANDED_WBLK - BANDED_WBLK - 5
    r_pad, d_pad = _round_up(r, g), _round_up(d, dtile)
    padded = np.full((r_pad, d_pad), np.nan)
    padded[:r, :d] = pos
    t = padded.reshape(r_pad // g, g, d_pad // dtile, dtile)
    with np.errstate(invalid="ignore"):
        span = np.nanmax(t, (1, 3)) - np.nanmin(t, (1, 3))
    return bool(np.nanmax(np.nan_to_num(span)) <= float(max_span))


def select_banded_group(cstar: np.ndarray, rows_t: np.ndarray,
                        candidates=BANDED_GROUP_CANDIDATES
                        ) -> Optional[int]:
    """HOST-side choice of the largest window-sharing group at which
    both passes are feasible (:func:`banded_spans_ok`): ``cstar`` is the
    pass-1 (Ho, Wd) position field, ``rows_t`` the pass-2 (Wd, Hd)
    transposed row field. None when no candidate fits (strong
    down/upsampling or sharply curved scanlines)."""
    for g in candidates:
        if banded_spans_ok(cstar, group=g) and banded_spans_ok(rows_t,
                                                               group=g):
            return int(g)
    return None


def select_warp_backend(cstar: np.ndarray, rows: np.ndarray,
                        backend: str = "auto"
                        ) -> Tuple[str, Optional[int]]:
    """The one choice of two-pass warp backend, from the warp geometry
    alone: returns ``(backend, banded_group)``, and ``banded_group`` is
    what :func:`orthowarp_two_pass` takes (None: dense). This is the one
    place a backend name is read. "auto" takes the banded path wherever
    it is feasible and the dense path otherwise; "banded" raises on
    infeasible geometry instead of silently losing taps; "dense" is
    always possible."""
    if backend == "dense":
        return "dense", None
    if backend not in ("auto", "banded"):
        raise ValueError(f"Unknown warp backend {backend!r} "
                         "(expected 'auto', 'banded' or 'dense')")
    group = select_banded_group(np.asarray(cstar), np.asarray(rows).T)
    if group is not None:
        return "banded", group
    if backend == "banded":
        raise ValueError(
            "banded warp infeasible for this geometry (a destination "
            "tile's source span exceeds the 384-sample window); use the "
            "dense backend")
    return "dense", None


def _banded_starts(pos: jax.Array, group: int, nblk: int, dtile: int,
                   s_pad: int) -> jax.Array:
    """(R, D) positions -> (R / group, D / dtile) int32 first source
    sample of each block's window: the lowest cubic tap rounded down to a
    BANDED_WBLK boundary, clipped so the window stays inside the padded
    source axis."""
    r, d = pos.shape
    lo = pos.reshape(r // group, group, d // dtile, dtile).min((1, 3))
    blk = jnp.clip(jnp.floor((lo - 2.5) / BANDED_WBLK), 0,
                   s_pad // BANDED_WBLK - nblk).astype(jnp.int32)
    return blk * BANDED_WBLK


def _banded_pass1(src: jax.Array, pos: jax.Array, method: str, prec,
                  group: int, nblk: int, dtile: int,
                  block_rows: int) -> jax.Array:
    """Horizontal pass: out[n, d, c] = sum_s k(pos[n, d] - s) src[n, s, c]
    over each block's window only. src (N, S, C), pos (N, D) ->
    (N_pad, D_pad, C); padded rows and columns carry out-of-range
    positions, so their outputs are exactly zero."""
    n, s, c = src.shape
    d = pos.shape[1]
    win = nblk * BANDED_WBLK
    s_pad = _round_up(max(s, win), BANDED_WBLK)
    d_pad = _round_up(d, dtile)
    rb = group * max(1, block_rows // group)
    n_pad = _round_up(n, rb)
    src = jnp.pad(src, ((0, n_pad - n), (0, s_pad - s), (0, 0)))
    pos = jnp.pad(pos.astype(jnp.float32), ((0, n_pad - n), (0, d_pad - d)),
                  constant_values=1e6)
    starts = _banded_starts(pos, group, nblk, dtile, s_pad)
    ng, nt = rb // group, d_pad // dtile
    iota = jnp.arange(win, dtype=jnp.float32)

    def body(i, h):
        r0 = i * rb
        blk = jax.lax.dynamic_slice(src, (r0, 0, 0), (rb, s_pad, c))
        blk = blk.reshape(ng, group, s_pad, c)
        st = jax.lax.dynamic_slice(starts, (i * ng, 0), (ng, nt))
        wins = jax.vmap(lambda rows_g, st_g: jax.vmap(
            lambda s0: jax.lax.dynamic_slice(rows_g, (0, s0, 0),
                                             (group, win, c)))(st_g))(
            blk, st)                                # (ng, nt, group, win, C)
        ps = jax.lax.dynamic_slice(pos, (r0, 0), (rb, d_pad))
        ps = ps.reshape(ng, group, nt, dtile)
        offs = st.astype(jnp.float32)[:, None, :, None, None] + iota
        wts = _kernel_profile(ps[..., None] - offs, method)
        out = jax.lax.dot_general(                  # (ng, group, nt, dtile, C)
            wts, wins, (((4,), (3,)), ((0, 1, 2), (0, 2, 1))),
            precision=prec, preferred_element_type=jnp.float32)
        return jax.lax.dynamic_update_slice(
            h, out.reshape(rb, d_pad, c), (r0, 0, 0))

    zero = (pos[0, 0] * 0.0 + src[0, 0, 0] * 0.0).astype(jnp.float32)
    h0 = jnp.zeros((n_pad, d_pad, c), jnp.float32) + zero
    return jax.lax.fori_loop(0, n_pad // rb, body, h0)


def _banded_pass2(h: jax.Array, pos_t: jax.Array, method: str, prec,
                  group: int, nblk: int, dtile: int,
                  block_cols: int) -> jax.Array:
    """Vertical pass over pass 1's layout: h (S, M, C) with S the
    contraction (scanline) axis, pos_t (M', D) the per-column fractional
    scanline positions (M' <= M) -> out (D_pad, M_pad, C)."""
    s, m, c = h.shape
    d = pos_t.shape[1]
    win = nblk * BANDED_WBLK
    s_pad = _round_up(max(s, win), BANDED_WBLK)
    d_pad = _round_up(d, dtile)
    cb = group * max(1, block_cols // group)
    m_pad = _round_up(m, cb)
    h = jnp.pad(h, ((0, s_pad - s), (0, m_pad - m), (0, 0)))
    pos_t = jnp.pad(pos_t.astype(jnp.float32),
                    ((0, m_pad - pos_t.shape[0]), (0, d_pad - d)),
                    constant_values=1e6)
    starts = _banded_starts(pos_t, group, nblk, dtile, s_pad)
    ng, nt = cb // group, d_pad // dtile
    iota = jnp.arange(win, dtype=jnp.float32)

    def body(i, out):
        m0 = i * cb
        hb = jax.lax.dynamic_slice(h, (0, m0, 0), (s_pad, cb, c))
        st = jax.lax.dynamic_slice(starts, (i * ng, 0), (ng, nt))
        wins = jax.vmap(lambda g, st_g: jax.vmap(
            lambda s0: jax.lax.dynamic_slice(hb, (s0, g * group, 0),
                                             (win, group, c)))(st_g))(
            jnp.arange(ng), st)                     # (ng, nt, win, group, C)
        ps = jax.lax.dynamic_slice(pos_t, (m0, 0), (cb, d_pad))
        ps = ps.reshape(ng, group, nt, dtile)
        offs = st.astype(jnp.float32)[:, None, :, None, None] + iota
        wts = _kernel_profile(ps[..., None] - offs, method)
        o = jax.lax.dot_general(                    # (ng, group, nt, dtile, C)
            wts, wins, (((4,), (2,)), ((0, 1, 2), (0, 3, 1))),
            precision=prec, preferred_element_type=jnp.float32)
        o = jnp.transpose(o, (2, 3, 0, 1, 4)).reshape(d_pad, cb, c)
        return jax.lax.dynamic_update_slice(out, o, (0, m0, 0))

    zero = (pos_t[0, 0] * 0.0 + h[0, 0, 0] * 0.0).astype(jnp.float32)
    out0 = jnp.zeros((d_pad, m_pad, c), jnp.float32) + zero
    return jax.lax.fori_loop(0, m_pad // cb, body, out0)


def banded_two_pass(src_ext: jax.Array, rows: jax.Array,
                    cstar: jax.Array, method: str, precision: str,
                    group: int, nblk: int = BANDED_NBLK,
                    dtile: int = BANDED_DTILE, block_rows_src: int = 64,
                    block_rows_dst: int = 64) -> jax.Array:
    """Both scanline passes in banded form: the sampling positions and
    taps of :func:`_two_pass_core`, but each destination tile contracts
    one ``nblk`` x 128-sample source window instead of the full axis.
    src_ext (Ho, Wo, C), rows (Hd, Wd), cstar (Ho, Wd) -> (Hd, Wd, C).

    Feasibility must be checked on the host with :func:`banded_spans_ok`
    at the same ``group``/``nblk``/``dtile`` (or through
    :func:`select_warp_backend`). ``group`` scanlines in pass 1 and
    columns in pass 2 share one window per tile; it changes which
    samples are gathered together, never the taps. Each loop step of
    pass 1 (pass 2) contracts ``block_rows_src`` scanlines
    (``block_rows_dst`` columns), rounded down to a multiple of
    ``group`` (at least one group), in one batched dot_general; a block
    as large as the axis makes each pass a single dot_general.
    ``precision``: a name of ``_PRECISIONS``."""
    prec = _PRECISIONS[precision]
    hd, wd = rows.shape
    h = _banded_pass1(src_ext, cstar, method, prec, group, nblk, dtile,
                      block_rows_src)
    out = _banded_pass2(h, jnp.transpose(rows), method, prec, group, nblk,
                        dtile, block_rows_dst)
    return out[:hd, :wd]


@partial(jax.jit,
         static_argnames=("method", "fill", "has_nodata",
                          "block_rows_src", "block_rows_dst", "precision"))
def warp_two_pass(img: jax.Array, rows: jax.Array, cols: jax.Array,
                  cstar: jax.Array, nodata: Optional[float] = None,
                  method: str = "cubic", fill: float = NO_DATA_VALUE,
                  has_nodata: Optional[bool] = None,
                  block_rows_src: int = 64, block_rows_dst: int = 64,
                  precision: str = "highest") -> jax.Array:
    """Generic two-pass scanline warp (no GLT): the matmul counterpart of
    ``warp_interpolate`` for large reprojections. Per-band nodata is
    renormalised by carrying one validity channel per band through both
    contractions (doubling the contraction width). Requires ``rows`` to
    be monotone along axis 0 per destination column (checked by
    :func:`resample_to_grid` before routing here). ``precision`` as in
    :func:`orthowarp_two_pass`."""
    h, w, b = img.shape
    if has_nodata is None:
        has_nodata = nodata is not None
    if has_nodata:
        validf = ((img != nodata)
                  & jnp.isfinite(img)).astype(jnp.float32)
        src_ext = jnp.concatenate(
            [jnp.where(validf > 0, img, 0.0).astype(jnp.float32), validf],
            axis=-1)
        nv = b
    else:
        src_ext = jnp.concatenate(
            [img.astype(jnp.float32),
             jnp.ones(img.shape[:2] + (1,), jnp.float32)], axis=-1)
        nv = 1
    prec = _PRECISIONS[precision]
    out_ext = _two_pass_core(src_ext, rows, cstar, method,
                             block_rows_src, block_rows_dst, prec)
    num = out_ext[..., :b]
    den = out_ext[..., b:]  # (Hd, Wd, nv) — per band or shared
    good = jnp.abs(den) > 1e-6
    res = jnp.where(good, num / jnp.where(good, den, 1.0),
                    jnp.asarray(fill, jnp.float32))
    centre_in = ((rows >= -0.5) & (rows <= h - 0.5)
                 & (cols >= -0.5) & (cols <= w - 0.5))[..., None]
    return jnp.where(centre_in, res, jnp.asarray(fill, jnp.float32))


@partial(jax.jit, static_argnames=("method", "fill", "band_chunk"))
def warp_interpolate_chunked(img: jax.Array, rows: jax.Array,
                             cols: jax.Array,
                             nodata: Optional[float] = None,
                             method: str = "bilinear",
                             fill: float = NO_DATA_VALUE,
                             band_chunk: int = 32) -> jax.Array:
    """Band-chunked interpolation for deep cubes inside a single jitted
    graph: the 4x4 cubic gathers of a (Hd, Wd, 285) warp would otherwise
    keep ~16 full-cube temporaries live (tens of GB at granule scale);
    chunking the spectral axis bounds peak HBM to the chunk size."""
    b = img.shape[-1]
    if b <= band_chunk:
        return warp_interpolate(img, rows, cols, nodata=nodata,
                                method=method, fill=fill)
    # a real sequential loop (fori_loop + dynamic slices): an unrolled
    # python loop lets XLA's scheduler run all chunks concurrently,
    # which brings back the full-cube temporaries
    pad = (-b) % band_chunk
    if pad:
        img = jnp.concatenate(
            [img, jnp.zeros(img.shape[:-1] + (pad,), img.dtype)], axis=-1)
    bp = b + pad
    n_chunks = bp // band_chunk
    out_shape = rows.shape + (bp,)

    def body(i, out):
        b0 = i * band_chunk
        chunk = jax.lax.dynamic_slice_in_dim(img, b0, band_chunk, axis=-1)
        warped = warp_interpolate(chunk, rows, cols, nodata=nodata,
                                  method=method, fill=fill)
        return jax.lax.dynamic_update_slice_in_dim(out, warped, b0, axis=-1)

    out = jnp.full(out_shape, jnp.asarray(fill, jnp.float32))
    out = jax.lax.fori_loop(0, n_chunks, body, out)
    return out[..., :b]


@partial(jax.jit, static_argnames=())
def _broadcast_axes(rows_1d: jax.Array, cols_1d: jax.Array):
    r = jnp.broadcast_to(rows_1d[:, None], (rows_1d.shape[0],
                                            cols_1d.shape[0]))
    c = jnp.broadcast_to(cols_1d[None, :], (rows_1d.shape[0],
                                            cols_1d.shape[0]))
    return r, c


def resample_to_grid(
    data: np.ndarray,
    src_grid: Grid,
    dst_grid: Grid,
    *,
    method: str = "bilinear",
    nodata: Optional[float] = None,
    fill: float = NO_DATA_VALUE,
    band_chunk: Optional[int] = None,
    kernel: str = "auto",
) -> np.ndarray:
    """Resample (H, W, B) or (H, W) data from src_grid onto dst_grid.
    Returns float32 (Hd, Wd, B) (band axis preserved).

    Fast paths: same-CRS grids use separable 1-D index axes (no
    projection math at all); aligned integer-ratio 'average' is an exact
    block reduction. ``band_chunk`` bounds device memory for very deep
    cubes (the interpolation gathers hold (Hd, Wd, B) accumulators).
    ``kernel``: "auto" routes large monotone cross-CRS transfers through
    the two-pass scanline-matmul warp, "two_pass" forces it, "gather"
    keeps the per-tap gather kernel."""
    arr = jnp.asarray(data, dtype=jnp.float32)
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[..., None]

    if method == "average":
        f = _integer_factor(src_grid, dst_grid)
        if f is not None:
            ox = int(round((dst_grid.x0 - src_grid.x0) / src_grid.dx))
            oy = int(round((src_grid.y0 - dst_grid.y0) / src_grid.dy))
            # the exact block reduction needs the dst window fully
            # inside the source; otherwise a negative/overflowing slice
            # would silently misplace or truncate the output
            if (0 <= oy and oy + dst_grid.height * f <= arr.shape[0]
                    and 0 <= ox and ox + dst_grid.width * f <= arr.shape[1]):
                sub = arr[oy:oy + dst_grid.height * f,
                          ox:ox + dst_grid.width * f, :]
                out = block_average(sub, f, nodata=nodata, fill=fill)
                out = np.asarray(out)
                return out[..., 0] if squeeze else out
        sep_avg = separable_index_axes(src_grid, dst_grid)
        if sep_avg is not None:
            # same-CRS non-integer / non-contained case: area-weighted
            # separable matmul (the documented GDAL 'average' semantics)
            Wr = jnp.asarray(separable_weight_matrix(
                sep_avg[0], src_grid.height, "average",
                scale=dst_grid.dy / src_grid.dy))
            Wc = jnp.asarray(separable_weight_matrix(
                sep_avg[1], src_grid.width, "average",
                scale=dst_grid.dx / src_grid.dx))
            out = separable_resample_matmul(arr, Wr, Wc, nodata=nodata,
                                            fill=fill, fast=False)
            out = np.asarray(out)
            return out[..., 0] if squeeze else out
        method_eff = "bilinear"  # cross-CRS average: bilinear transfer
    else:
        method_eff = method

    sep = separable_index_axes(src_grid, dst_grid)
    if sep is not None and method_eff in ("bilinear", "cubic"):
        # same-CRS transfers run as two matmuls (identical weights
        # and nodata renormalisation; see separable_resample_matmul)
        Wr = jnp.asarray(separable_weight_matrix(
            sep[0], src_grid.height, method_eff))
        Wc = jnp.asarray(separable_weight_matrix(
            sep[1], src_grid.width, method_eff))
        out = separable_resample_matmul(arr, Wr, Wc, nodata=nodata,
                                        fill=fill, fast=False)
        out = np.asarray(out)
        return out[..., 0] if squeeze else out
    if sep is not None:
        rows, cols = _broadcast_axes(jnp.asarray(sep[0]),
                                     jnp.asarray(sep[1]))
    else:
        rows_np, cols_np = source_index_field(src_grid, dst_grid)
        rows, cols = jnp.asarray(rows_np), jnp.asarray(cols_np)
        # large cross-CRS reprojects route to the scanline-matmul warp
        # when the row field is monotone per column (any smooth
        # projective transfer away from a pole); small ones keep the
        # gather kernel (compile cost dominates there)
        diffs = np.diff(rows_np, axis=0)
        monotone = (rows_np.shape[0] < 2
                    or bool(np.all(diffs > 0) or np.all(diffs < 0)))
        big = rows_np.size >= (256 * 256)
        if (method_eff in ("bilinear", "cubic") and monotone
                and (kernel == "two_pass" or (kernel == "auto" and big))):
            cstar = scanline_cstar(rows_np, cols_np, src_grid.height)
            out = warp_two_pass(arr, rows, cols, jnp.asarray(cstar),
                                nodata=nodata, method=method_eff,
                                fill=fill)
            out = np.asarray(out)
            return out[..., 0] if squeeze else out

    def run(block):
        if method_eff == "nearest":
            return warp_nearest(block, rows, cols, nodata=nodata, fill=fill)
        return warp_interpolate(block, rows, cols, nodata=nodata,
                                method=method_eff, fill=fill)

    nb = arr.shape[-1]
    if band_chunk is None or band_chunk >= nb:
        out = run(arr)
    else:
        parts = [run(arr[..., b0:b0 + band_chunk])
                 for b0 in range(0, nb, band_chunk)]
        out = jnp.concatenate(parts, axis=-1)

    out = np.asarray(out)
    return out[..., 0] if squeeze else out


def reproject_stack_to_grid(src_stack: np.ndarray, src_grid: Grid,
                            dst_grid: Grid, resampling: str = "bilinear",
                            nodata: Optional[float] = None) -> np.ndarray:
    """(C, H, W) -> (C, H2, W2) float32 — API parity with the reference's
    notebook helper (demo cell 73)."""
    hwb = np.moveaxis(np.asarray(src_stack), 0, -1)
    out = resample_to_grid(hwb, src_grid, dst_grid, method=resampling,
                           nodata=nodata, fill=np.nan if nodata is None
                           else nodata)
    return np.moveaxis(out, -1, 0)
