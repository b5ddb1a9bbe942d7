"""Masked reductions: percentiles, min/max, stretches, quantization.

Device-side replacements for the reference's host reductions:
- percentile stretches (s2_emit/color.py:6-34),
- strided robust min/max for OBS scaling (EMIT_data/emit_proj.py:459-492),
- uint16 quantization with nodata sentinel (tiles_helpers/utils.py:362-373,
  gdal_translate -scale at emit_proj.py:248-276).

Masked percentiles use the NaN-sort approach (exact, matching
np.percentile linear interpolation on the valid subset). For
multi-device use, `histogram_percentile` provides a deterministic
fixed-shape alternative that reduces with psum-friendly histograms.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp


@jax.jit
def masked_percentile(x: jax.Array, mask: jax.Array,
                      qs: jax.Array) -> jax.Array:
    """Percentiles of x[mask] (linear interpolation, matching
    np.percentile). x, mask same shape; qs (Q,) in [0, 100]."""
    xf = jnp.where(mask, x, jnp.nan).ravel()
    return jnp.nanpercentile(xf, qs)


# ---------------------------------------------------------------------------
# Sort-free exact percentiles (bit-space binary search)
# ---------------------------------------------------------------------------
#
# These helpers compute the same order statistics as a sort with a
# 32-step binary search over the monotonic integer encoding of f32 —
# per step one fused compare+count pass over the data, no sort, no
# scatter, code size independent of the array shape. The recovered
# order statistics equal sorting's, and the linear interpolation
# matches np.percentile. (Sort vs bit search has not been measured on
# the GPU.)


def _f32_order_keys(x: jax.Array) -> jax.Array:
    """Monotonic uint32 encoding of f32 totally ordered like the values
    (-inf < ... < -0.0 < +0.0 < ... < +inf); NaN payload keys are
    excluded by callers via the validity mask."""
    u = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
    neg = (u & jnp.uint32(0x80000000)) != 0
    return jnp.where(neg, ~u, u | jnp.uint32(0x80000000))


def _f32_from_order_keys(k: jax.Array) -> jax.Array:
    pos = (k & jnp.uint32(0x80000000)) != 0
    u = jnp.where(pos, k & jnp.uint32(0x7FFFFFFF), ~k)
    return jax.lax.bitcast_convert_type(u, jnp.float32)


def _bitsearch_kth_keys(keys: jax.Array, valid: jax.Array,
                        ks: jax.Array) -> jax.Array:
    """k-th smallest key (0-indexed) among keys[valid], for a batch of
    ranks. keys (N, C) uint32, valid (N, C) bool, ks (C, ...) int32
    (per-channel rank sets). Returns (C, ...) uint32.

    Finds max{v : count(keys_c < v) <= k} per rank by building v from
    the MSB down — 32 sequential fused compare+count passes over the
    data (no sort). Ranks must satisfy 0 <= k < n_c (guarded by
    callers)."""
    n, c = keys.shape
    kshape = ks.shape  # (C, ...)
    flat_ks = ks.reshape(c, -1)                       # (C, S)

    def step(v, bit):
        cand = v | (jnp.uint32(1) << bit)             # (C, S)
        below = (keys[:, :, None] < cand[None]) & valid[:, :, None]
        cnt = jnp.sum(below, axis=0, dtype=jnp.int32)  # (C, S)
        return jnp.where(cnt <= flat_ks, cand, v), None

    v0 = jnp.zeros_like(flat_ks, dtype=jnp.uint32)
    bits = jnp.arange(31, -1, -1, dtype=jnp.uint32)
    v, _ = jax.lax.scan(step, v0, bits)
    return v.reshape(kshape)


@jax.jit
def masked_percentile_channels(img: jax.Array, mask: jax.Array,
                               qs: jax.Array) -> jax.Array:
    """Per-channel masked percentiles of an (H, W, C) image in ONE
    fused search: returns (C, Q), matching ``masked_percentile`` per
    channel (np.percentile linear interpolation; valid NaNs excluded
    like nanpercentile) without a sort."""
    h, w, c = img.shape
    flat = img.reshape(-1, c)
    valid = (jnp.broadcast_to(mask.reshape(-1, 1), flat.shape)
             & ~jnp.isnan(flat))
    keys = _f32_order_keys(flat)
    nn = jnp.sum(valid, axis=0, dtype=jnp.int32)      # (C,)
    pos = (qs.astype(jnp.float32) / 100.0)[None, :] * (
        jnp.maximum(nn - 1, 0).astype(jnp.float32)[:, None])  # (C, Q)
    nm1 = jnp.maximum(nn - 1, 0)[:, None]
    j = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, nm1)
    jp = jnp.clip(jnp.ceil(pos).astype(jnp.int32), 0, nm1)
    hw = pos - jnp.floor(pos)                         # high weight
    kk = jnp.stack([j, jp], axis=-1)                  # (C, Q, 2)
    key_stats = _bitsearch_kth_keys(keys, valid, kk)
    vals = _f32_from_order_keys(key_stats)            # (C, Q, 2)
    # exact jnp.nanpercentile "linear" combine: lo*(1-w) + hi*w
    out = vals[..., 0] * (1.0 - hw) + vals[..., 1] * hw
    return jnp.where(nn[:, None] > 0, out, jnp.nan)


@jax.jit
def masked_percentile_bitsearch(x: jax.Array, mask: jax.Array,
                                qs: jax.Array) -> jax.Array:
    """Sort-free exact drop-in for :func:`masked_percentile`
    (single array -> (Q,))."""
    return masked_percentile_channels(
        x.reshape(-1, 1, 1), mask.reshape(-1, 1, 1), qs)[0]


@jax.jit
def masked_minmax(x: jax.Array, mask: jax.Array) -> Tuple[jax.Array, jax.Array]:
    big = jnp.asarray(jnp.inf, dtype=x.dtype)
    lo = jnp.min(jnp.where(mask, x, big))
    hi = jnp.max(jnp.where(mask, x, -big))
    return lo, hi


@partial(jax.jit, static_argnames=("stride", "pmin", "pmax"))
def strided_band_minmax(cube_hwb: jax.Array, nodata: float,
                        stride: int = 64, pmin: float = 1.0,
                        pmax: float = 99.0) -> Tuple[jax.Array, jax.Array]:
    """Per-band robust (p1, p99) range on a strided sample, the OBS
    scaling estimator (emit_proj.py:459-492). Returns (lo, hi) each (B,)."""
    sample = cube_hwb[::stride, ::stride, :]
    b = sample.shape[-1]
    flat = sample.reshape(-1, b)
    valid = jnp.isfinite(flat) & (flat != nodata)
    xf = jnp.where(valid, flat, jnp.nan)
    lo = jnp.nanpercentile(xf, pmin, axis=0)
    hi = jnp.nanpercentile(xf, pmax, axis=0)
    return lo, hi


@partial(jax.jit, static_argnames=("nbins", "iters"))
def histogram_percentile(x: jax.Array, mask: jax.Array, qs: jax.Array,
                         nbins: int = 2048, iters: int = 2) -> jax.Array:
    """Deterministic percentile via iterative histogram refinement —
    fixed shapes, psum-compatible, ~(range/nbins**iters) accuracy. Each
    requested percentile refines its own bracket independently (vmap)."""
    valid = mask.ravel()
    xf = x.ravel()
    n = jnp.sum(valid)
    glo = jnp.min(jnp.where(valid, xf, jnp.inf))
    ghi = jnp.max(jnp.where(valid, xf, -jnp.inf))
    weights = valid.astype(jnp.float32)

    def one_q(q):
        target = q / 100.0 * n

        def refine(carry, _):
            lo, hi = carry
            width = jnp.maximum(hi - lo, 1e-30)
            idx = jnp.clip(((xf - lo) / width * nbins).astype(jnp.int32),
                           0, nbins - 1)
            inside = (xf >= lo) & (xf <= hi)
            hist = jnp.zeros((nbins,), dtype=jnp.float32).at[idx].add(
                jnp.where(inside, weights, 0.0))
            below = jnp.sum(jnp.where(xf < lo, weights, 0.0))
            cdf = below + jnp.cumsum(hist)
            b = jnp.clip(jnp.searchsorted(cdf, target), 0, nbins - 1)
            return (lo + b / nbins * width,
                    lo + (b + 1) / nbins * width), None

        (lo, hi), _ = jax.lax.scan(refine, (glo, ghi), None, length=iters)
        return (lo + hi) / 2.0

    return jax.vmap(one_q)(qs.astype(jnp.float32))


@partial(jax.jit, static_argnames=("edges", "iters"))
def bracket_percentile(x: jax.Array, mask: jax.Array, qs: jax.Array,
                       edges: int = 128, iters: int = 3) -> jax.Array:
    """Scatter-free masked percentile: iterative bracket refinement by
    comparison counting. Each iteration splits every percentile's
    bracket into ``edges`` spans and counts values below each edge with
    one fused compare+reduce over the data (no sort, no scatter).
    Accuracy ~(range / edges**iters): at the defaults and 60 m grid
    scale that is ~3e-6 of the data range, below both f32
    order-statistic spacing and the u16 DN quantization of the inputs.
    For exact np.percentile interpolation semantics use
    :func:`masked_percentile`."""
    valid = mask.ravel()
    xf = jnp.where(valid, x.ravel(), jnp.nan)  # NaN: all compares False
    n = jnp.sum(valid.astype(jnp.float32))
    glo = jnp.min(jnp.where(valid, x.ravel(), jnp.inf))
    ghi = jnp.max(jnp.where(valid, x.ravel(), -jnp.inf))
    k = qs.shape[0]
    targets = qs.astype(jnp.float32) / 100.0 * n          # (K,)
    lo0 = jnp.broadcast_to(glo, (k,))
    hi0 = jnp.broadcast_to(ghi, (k,))

    def refine(carry, _):
        lo, hi = carry                                     # (K,)
        width = jnp.maximum(hi - lo, 1e-30)
        grid = jnp.arange(1, edges, dtype=jnp.float32) / edges
        e = lo[:, None] + width[:, None] * grid[None, :]   # (K, E-1)
        below = (xf[:, None, None] < e[None]) & valid[:, None, None]
        counts = jnp.sum(below.astype(jnp.float32), axis=0)  # (K, E-1)
        # index of the sub-span containing the target count
        idx = jnp.sum((counts <= targets[:, None]).astype(jnp.int32),
                      axis=1)                              # (K,) in [0, E-1]
        return (lo + idx.astype(jnp.float32) / edges * width,
                lo + (idx + 1).astype(jnp.float32) / edges * width), None

    (lo, hi), _ = jax.lax.scan(refine, (lo0, hi0), None, length=iters)
    # empty mask -> NaN, matching masked_percentile's nanpercentile
    return jnp.where(n > 0, (lo + hi) / 2.0, jnp.nan)


@partial(jax.jit, static_argnames=("method",))
def shared_percentile_stretch(img: jax.Array, mask: jax.Array,
                              pmin: float = 2.0, pmax: float = 98.0,
                              method: str = "bitsearch") -> jax.Array:
    """Per-channel percentile stretch within mask, clipped to [0, 1] —
    apply_shared_percentile_stretch (color.py:25-34). img (H, W, C).

    ``method="bitsearch"`` (default) computes the exact order
    statistics with the sort-free 32-step bit search
    (:func:`masked_percentile_channels`) — the sort's order statistics
    with code size independent of the array shape. ``method="sort"``
    keeps the nan-sort percentile;
    ``method="bracket"`` estimates with :func:`bracket_percentile`
    (~3e-6-of-range accuracy; kept as the fixed-shape multi-device
    option)."""
    if method == "bitsearch":
        lohi = masked_percentile_channels(
            img, mask, jnp.asarray([pmin, pmax]))      # (C, 2)
        lo = lohi[:, 0]
        hi = lohi[:, 1]
        return jnp.clip((img - lo) / (hi - lo + 1e-12),
                        0.0, 1.0).astype(jnp.float32)
    pct = (bracket_percentile if method == "bracket" else masked_percentile)

    def one(channel):
        lo, hi = pct(channel, mask, jnp.asarray([pmin, pmax]))
        return jnp.clip((channel - lo) / (hi - lo + 1e-12), 0.0, 1.0)
    return jnp.stack([one(img[..., c]) for c in range(img.shape[-1])],
                     axis=-1).astype(jnp.float32)


@jax.jit
def robust_norm(x: jax.Array, pmin: float = 2.0, pmax: float = 98.0
                ) -> jax.Array:
    """Unmasked nan-aware stretch (color.py:6-8)."""
    lo, hi = jnp.nanpercentile(x, jnp.asarray([pmin, pmax]))
    return jnp.clip((x - lo) / (hi - lo + 1e-12), 0.0, 1.0)


@jax.jit
def robust_norm_rgb(img: jax.Array, mask: jax.Array,
                    pmin: float = 2.0, pmax: float = 98.0) -> jax.Array:
    """Per-channel stretch within mask; invalid pixels become NaN
    (color.py:10-23)."""
    def one(channel):
        lo, hi = masked_percentile(channel, mask, jnp.asarray([pmin, pmax]))
        cc = (channel - lo) / (hi - lo + 1e-12)
        cc = jnp.where(mask, cc, jnp.nan)
        return jnp.clip(cc, 0.0, 1.0)
    return jnp.stack([one(img[..., c]) for c in range(img.shape[-1])],
                     axis=-1)


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("nodata_u16",))
def quantize_u16(x: jax.Array, lo: jax.Array, hi: jax.Array,
                 valid: jax.Array, nodata_u16: int = 0) -> jax.Array:
    """Scale [lo, hi] -> [0, 65535] uint16 with a nodata sentinel —
    gdal_translate -scale semantics (emit_proj.py:413-427). lo/hi may be
    scalars or per-band (B,) for (..., B) input. The sentinel code is
    RESERVED: valid pixels clipping to it are nudged one step inward
    (with lo at a p1 percentile, ~1% of valid pixels sit at/below lo and
    would otherwise decode as nodata)."""
    scaled = (x - lo) / (hi - lo + 1e-32) * 65535.0
    q_lo = 1.0 if nodata_u16 == 0 else 0.0
    q_hi = 65534.0 if nodata_u16 == 65535 else 65535.0
    q = jnp.clip(jnp.rint(scaled), q_lo, q_hi).astype(jnp.uint16)
    return jnp.where(valid, q, jnp.asarray(nodata_u16, dtype=jnp.uint16))


@partial(jax.jit, static_argnames=("nodata_u16", "scale"))
def quantize_reflectance_u16(x: jax.Array, valid: jax.Array,
                             scale: float = 10000.0,
                             nodata_u16: int = 65535) -> jax.Array:
    """EMIT tile quantization: round(x * 10000), clipped to
    [0, nodata-1], invalid -> nodata (tiles_helpers/utils.py:362-373)."""
    q = jnp.clip(jnp.rint(x * scale), 0.0, float(nodata_u16 - 1))
    q = q.astype(jnp.uint16)
    return jnp.where(valid, q, jnp.asarray(nodata_u16, dtype=jnp.uint16))


@jax.jit
def dequantize_u16(q: jax.Array, scale: jax.Array, offset: jax.Array,
                   nodata_u16: int, fill: float = jnp.nan) -> jax.Array:
    """Inverse of quantize: true = raw * scale + offset
    (emit_proj.py:432-455)."""
    x = q.astype(jnp.float32) * scale + offset
    return jnp.where(q == nodata_u16, jnp.asarray(fill, dtype=jnp.float32), x)


def erode_mask(mask: jax.Array, iterations: int = 1) -> jax.Array:
    """Binary erosion with the 4-connected cross structure (scipy
    ``binary_erosion`` default semantics: outside the array counts as
    background, so border pixels erode away)."""
    m = mask
    for _ in range(iterations):
        p = jnp.pad(m, 1, constant_values=False)
        m = (p[1:-1, 1:-1] & p[:-2, 1:-1] & p[2:, 1:-1]
             & p[1:-1, :-2] & p[1:-1, 2:])
    return m


@partial(jax.jit, static_argnames=("erode",))
def cube_psnr_sam(cube: jax.Array, truth: jax.Array, fill: float,
                  erode: int = 2,
                  data_range: float = 1.0) -> Tuple[jax.Array, jax.Array,
                                                    jax.Array]:
    """(valid_frac, PSNR dB, mean SAM rad) of an (H, W, B) product cube
    against a truth cube, over the ``erode``-px interior of the valid
    mask — the device-resident form of ``pipeline.psnr``/``sam`` on
    ``cube[binary_erosion(valid, iterations=erode)]``. Scalar-only
    readback: at granule scale, fetching the cube to host for metrics
    costs minutes on constrained links."""
    vmask = cube[..., 0] != fill
    e = erode_mask(vmask, erode)
    n_px = jnp.maximum(jnp.sum(e), 1)
    d2 = jnp.sum((cube - truth) ** 2, axis=-1)
    mse = jnp.sum(jnp.where(e, d2, 0.0)) / (n_px * cube.shape[-1])
    p_db = 10.0 * jnp.log10(data_range ** 2 / mse)
    num = jnp.sum(cube * truth, axis=-1)
    den = (jnp.linalg.norm(cube, axis=-1)
           * jnp.linalg.norm(truth, axis=-1) + 1e-12)
    ang = jnp.arccos(jnp.clip(num / den, -1.0, 1.0))
    s_rad = jnp.sum(jnp.where(e, ang, 0.0)) / n_px
    return vmask.mean(), p_db, s_rad
