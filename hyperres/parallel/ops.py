"""Sharded collective operations (shard_map + XLA collectives).

The multi-chip counterparts of the single-chip kernels, per SURVEY.md
section 2.8:
- distributed percentiles via histogram + psum (the shared stretch
  color.py:25-34 and robust min/max emit_proj.py:459-492 across shards),
- data-parallel ridge training via psum of Gram terms (the spectral-SR
  fit over tile shards),
- sharded tile map (pjit over the tile axis — the tile loop
  tiles_helpers/utils.py:266-301 across chips),
- halo exchange over spatially sharded rasters via ppermute (cubic
  needs a 2-px halo, bilinear 1-px),
- band-sharded SRF synthesis (the 285-band axis sharded, partial
  matmuls psum-reduced) — the multi-chip form of the 32-band chunk loop.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..fusion.ridge_sr import RidgeSpectralSR, RidgeSRParams
from ..kernels.lstsq import logit
from ..kernels.warp import _PRECISIONS


# ---------------------------------------------------------------------------
# Distributed percentile (histogram + psum)
# ---------------------------------------------------------------------------

def sharded_histogram_percentile(x, mask, qs, mesh: Mesh,
                                 axis: str = "data", nbins: int = 2048,
                                 iters: int = 2):
    """Percentiles of the masked global distribution of ``x`` whose
    leading dim is sharded over ``axis``. Deterministic, fixed-shape:
    per-shard histograms are psum-reduced each refinement round."""
    qs = jnp.asarray(qs, dtype=jnp.float32)

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis), P(axis), P()),
             out_specs=P())
    def run(x_s, m_s, qs_s):
        xf = x_s.ravel()
        valid = m_s.ravel()
        w = valid.astype(jnp.float32)
        n = jax.lax.psum(jnp.sum(w), axis)
        glo = jax.lax.pmin(jnp.min(jnp.where(valid, xf, jnp.inf)), axis)
        ghi = jax.lax.pmax(jnp.max(jnp.where(valid, xf, -jnp.inf)), axis)

        def one_q(q):
            target = q / 100.0 * n

            def refine(carry, _):
                lo, hi = carry
                width = jnp.maximum(hi - lo, 1e-30)
                idx = jnp.clip(((xf - lo) / width * nbins).astype(jnp.int32),
                               0, nbins - 1)
                inside = (xf >= lo) & (xf <= hi)
                hist = jnp.zeros((nbins,), jnp.float32).at[idx].add(
                    jnp.where(inside, w, 0.0))
                hist = jax.lax.psum(hist, axis)
                below = jax.lax.psum(
                    jnp.sum(jnp.where(xf < lo, w, 0.0)), axis)
                cdf = below + jnp.cumsum(hist)
                b = jnp.clip(jnp.searchsorted(cdf, target), 0, nbins - 1)
                return (lo + b / nbins * width,
                        lo + (b + 1) / nbins * width), None

            (lo, hi), _ = jax.lax.scan(refine, (glo, ghi), None,
                                       length=iters)
            return (lo + hi) / 2.0

        return jax.vmap(one_q)(qs_s)

    return run(x, mask, qs)


# ---------------------------------------------------------------------------
# Data-parallel ridge spectral-SR training step
# ---------------------------------------------------------------------------

def data_parallel_ridge_fit(model: RidgeSpectralSR, X, Y, mesh: Mesh,
                            axis: str = "data",
                            weights=None) -> RidgeSRParams:
    """One data-parallel training step of the spectral-SR model: each
    shard of (N, Bx)/(N, By) computes its Gram contribution; psum
    assembles the global system; every chip solves the (small) replicated
    system. N must divide the mesh axis size."""
    if weights is None:
        weights = jnp.ones(X.shape[0], dtype=jnp.float32)

    cfg = model.cfg

    @partial(shard_map, mesh=mesh,
             in_specs=(P(axis), P(axis), P(axis)),
             out_specs=P())
    def step(X_s, Y_s, w_s):
        wcol = w_s[:, None]
        n = jax.lax.psum(jnp.sum(w_s), axis)
        x_sum = jax.lax.psum(jnp.sum(X_s * wcol, axis=0), axis)
        x_mean = x_sum / n
        x_var = jax.lax.psum(
            jnp.sum(wcol * (X_s - x_mean) ** 2, axis=0), axis) / n
        x_std = jnp.sqrt(x_var) + 1e-12

        Y_logit = logit(Y_s, eps=cfg.logit_eps)
        Xs = (X_s - x_mean) / x_std
        F = model.expand(Xs)
        f_sum = jax.lax.psum(jnp.sum(F * wcol, axis=0), axis)
        y_sum = jax.lax.psum(jnp.sum(Y_logit * wcol, axis=0), axis)
        FtF = jax.lax.psum(
            jnp.dot((F * wcol).T, F, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST), axis)
        FtY = jax.lax.psum(
            jnp.dot((F * wcol).T, Y_logit,
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST), axis)
        W, intercept = RidgeSpectralSR._solve_from_gram(
            n, f_sum, y_sum, FtF, FtY, cfg.alpha)
        return RidgeSRParams(x_mean, x_std, W, intercept)

    params = step(jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32),
                  jnp.asarray(weights, jnp.float32))
    model.params = params
    return params


# ---------------------------------------------------------------------------
# Sharded tile map
# ---------------------------------------------------------------------------

def sharded_tile_map(fn: Callable, tiles, mesh: Mesh, axis: str = "data"):
    """Apply a per-tile function over a (T, ...) tile stack sharded across
    the mesh. ``fn`` maps one tile -> pytree of arrays; vmapped per shard.
    T must be a multiple of the axis size (pad upstream)."""
    spec_in = P(axis)

    @partial(shard_map, mesh=mesh, in_specs=(spec_in,),
             out_specs=spec_in)
    def run(tile_shard):
        return jax.vmap(fn)(tile_shard)

    return run(tiles)


# ---------------------------------------------------------------------------
# Halo exchange (ppermute) for spatially sharded rasters
# ---------------------------------------------------------------------------

def halo_exchange_rows(x_shard: jax.Array, halo: int, axis: str):
    """Inside shard_map: pad a row-sharded raster block (h, ...) with
    ``halo`` rows from the neighbouring shards (edge-replicated at the
    outer boundaries). Cubic resampling needs halo=2, bilinear halo=1."""
    n = jax.lax.axis_size(axis)
    i = jax.lax.axis_index(axis)
    up = [(j, (j - 1) % n) for j in range(n)]     # send top rows upward
    down = [(j, (j + 1) % n) for j in range(n)]   # send bottom rows downward

    top_rows = x_shard[:halo]
    bot_rows = x_shard[-halo:]
    from_below = jax.lax.ppermute(top_rows, axis, perm=up)
    from_above = jax.lax.ppermute(bot_rows, axis, perm=down)
    # outer edges: replicate own border rows
    from_above = jnp.where(i == 0, jnp.repeat(x_shard[:1], halo, axis=0),
                           from_above)
    from_below = jnp.where(i == n - 1,
                           jnp.repeat(x_shard[-1:], halo, axis=0),
                           from_below)
    return jnp.concatenate([from_above, x_shard, from_below], axis=0)


# ---------------------------------------------------------------------------
# Band-sharded SRF synthesis
# ---------------------------------------------------------------------------

def sharded_srf_synthesize(cube_hwb, weights_bs, mesh: Mesh,
                           axis: str = "band"):
    """SRF matmul with the spectral axis sharded: each chip contracts its
    band slice, psum assembles the (H, W, S) synthesis. The multi-chip
    successor of the reference's 32-band chunk loop
    (emit_proj.py:969-987). B must divide the axis size."""
    @partial(shard_map, mesh=mesh,
             in_specs=(P(None, None, axis), P(axis, None)),
             out_specs=P())
    def run(cube_s, w_s):
        h, w, b = cube_s.shape
        part = jnp.dot(cube_s.reshape(-1, b), w_s,
                       preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
        return jax.lax.psum(part.reshape(h, w, -1), axis)

    return run(jnp.asarray(cube_hwb, jnp.float32),
               jnp.asarray(weights_bs, jnp.float32))


# ---------------------------------------------------------------------------
# Sharded fused ortho-warp (destination rows data-parallel)
# ---------------------------------------------------------------------------

def sharded_orthowarp(raw, glt_flat_idx, glt_valid, rows, cols, mesh: Mesh,
                      axis: str = "data", method: str = "cubic",
                      fill: float = -9999.0, row_chunks: int = 1):
    """Multi-chip fused GLT+warp: the destination coordinate fields are
    sharded over ``axis`` (each chip produces its block of output rows);
    the raw cube and GLT are replicated (a full EMIT granule is ~1.8 GB —
    comfortably resident per chip). Scales the dominant ortho stage
    linearly across chips with zero collectives in the hot loop.
    Destination height must divide the axis size."""
    from ..kernels.warp import orthowarp_taploop

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(), P(), P(axis), P(axis)),
             out_specs=P(axis))
    def run(raw_s, gf_s, gv_s, rows_s, cols_s):
        return orthowarp_taploop(raw_s, gf_s, gv_s, rows_s, cols_s,
                                 method=method, fill=fill,
                                 row_chunks=row_chunks)

    return run(jnp.asarray(raw), jnp.asarray(glt_flat_idx),
               jnp.asarray(glt_valid), jnp.asarray(rows),
               jnp.asarray(cols))


def _sharded_two_pass_build(glt_flat_idx, rows, mesh: Mesh, axis: str,
                            method: str, fill: float, halo: int,
                            precision: str):
    """Host-side shard checks + the shard_map warp program shared by
    :func:`sharded_orthowarp_two_pass` (one-shot) and
    :func:`sharded_streamed_orthowarp` (per-chunk fold)."""
    from ..kernels.warp import _two_pass_pass1, _two_pass_pass2

    n = mesh.shape[axis]
    ho, wo = np.asarray(glt_flat_idx).shape
    hd, wd = np.asarray(rows).shape
    if ho % n or hd % n:
        raise ValueError(f"source height {ho} and destination height "
                         f"{hd} must divide the mesh axis {n}")
    if halo > ho // n:
        raise ValueError(
            f"halo {halo} exceeds the per-shard scanline count "
            f"{ho // n} (ppermute exchanges at most one full shard)")
    ho_l, hd_l = ho // n, hd // n
    radius = 2.0 if method == "cubic" else 1.0
    rows_np = np.asarray(rows)
    for i in range(n):
        blk = rows_np[i * hd_l:(i + 1) * hd_l]
        lo = np.floor(blk.min() - radius)
        hi = np.ceil(blk.max() + radius)
        if lo < i * ho_l - halo or hi > (i + 1) * ho_l + halo:
            raise ValueError(
                f"destination shard {i} needs scanlines [{lo}, {hi}] "
                f"outside its halo window "
                f"[{i * ho_l - halo}, {(i + 1) * ho_l + halo}]; "
                f"increase halo")
    prec = _PRECISIONS[precision]

    @partial(shard_map, mesh=mesh,
             in_specs=(P(), P(axis), P(axis), P(axis), P(axis), P(axis)),
             out_specs=P(axis))
    def run(raw_s, gf_s, gv_s, rows_s, cols_s, cstar_s):
        idx = jax.lax.axis_index(axis)
        b = raw_s.shape[-1]
        raw_flat = raw_s.reshape(-1, b)
        v = jnp.take(raw_flat, gf_s.reshape(-1),
                     axis=0).reshape(gf_s.shape + (b,))
        validf = gv_s.astype(jnp.float32)[..., None]
        src_ext = jnp.concatenate([v * validf, validf], axis=-1)
        # pass 1 on my scanlines only
        h_t = _two_pass_pass1(src_ext, cstar_s, wd, method,
                              min(64, ho_l), prec)  # (Wd, ho_l, C)
        # halo exchange along the scanline axis: receive the last `halo`
        # scanlines of the previous shard and the first `halo` of the
        # next (edges filled with zeros and masked out in pass 2)
        fwd = [(j, (j + 1) % n) for j in range(n)]
        bwd = [(j, (j - 1) % n) for j in range(n)]
        from_prev = jax.lax.ppermute(h_t[:, -halo:], axis, fwd)
        from_next = jax.lax.ppermute(h_t[:, :halo], axis, bwd)
        h_ext = jnp.concatenate([from_prev, h_t, from_next], axis=1)
        # local fractional scanline index + global-bounds validity mask
        offset = (idx * ho_l - halo).astype(jnp.float32)
        rows_local = rows_s - offset
        m_global = jnp.arange(ho_l + 2 * halo, dtype=jnp.float32) + offset
        m_valid = ((m_global >= 0) & (m_global < ho)
                   # wrap-around halo rows are garbage at the outer edges
                   & (m_global >= (idx - 1) * ho_l)
                   & (m_global < (idx + 2) * ho_l)).astype(jnp.float32)
        out_ext = _two_pass_pass2(h_ext, rows_local, method,
                                  min(64, hd_l), prec, m_valid=m_valid)
        den = out_ext[..., -1:]
        good = jnp.abs(den) > 1e-6
        res = jnp.where(good,
                        out_ext[..., :b] / jnp.where(good, den, 1.0),
                        jnp.asarray(fill, jnp.float32))
        centre_in = ((rows_s >= -0.5) & (rows_s <= ho - 0.5)
                     & (cols_s >= -0.5) & (cols_s <= wo - 0.5))[..., None]
        return jnp.where(centre_in, res, jnp.asarray(fill, jnp.float32))

    return run


def sharded_orthowarp_two_pass(raw, glt_flat_idx, glt_valid, rows, cols,
                               cstar, mesh: Mesh, axis: str = "data",
                               method: str = "cubic",
                               fill: float = -9999.0, halo: int = 32,
                               precision: str = "highest"):
    """Multi-chip two-pass scanline ortho-warp.

    SPMD decomposition: pass 1 (horizontal, per source scanline) is
    sharded over the SOURCE scanline axis — each chip GLT-gathers and
    resamples only its own scanlines; pass 2 (vertical, per destination
    row) is sharded over the DESTINATION row axis. Because the row field
    is monotone, destination shard i needs source scanlines from
    (roughly) source shard i plus a bounded overlap — satisfied with a
    single ``ppermute`` halo exchange of ``halo`` scanlines per
    neighbour; no all-gather and no collectives in either matmul pass.

    Requirements checked on the host: source height and destination
    height divisible by the mesh axis; every destination shard's
    scanline support (rows field ± kernel radius) within its halo-
    extended window (raise otherwise — increase ``halo``).
    """
    run = _sharded_two_pass_build(glt_flat_idx, rows, mesh, axis, method,
                                  fill, halo, precision)
    return run(jnp.asarray(raw), jnp.asarray(glt_flat_idx),
               jnp.asarray(glt_valid), jnp.asarray(rows),
               jnp.asarray(cols), jnp.asarray(cstar))


def sharded_streamed_orthowarp(read_bands, shape_hwb, glt_flat_idx,
                               glt_valid, rows, cols, cstar, mesh: Mesh,
                               axis: str = "data", method: str = "cubic",
                               fill: float = -9999.0, halo: int = 32,
                               precision: str = "highest",
                               transfer: str = "u16",
                               chunk_bands: int = 8, depth: int = 2):
    """The PRODUCTION streamed ingest fold under a device mesh: the UTM
    accumulator lives row-sharded across the chips, and each band chunk
    is dequantized + warped by the sharded two-pass kernel + written
    into the shard-local accumulator rows, all in ONE jitted program per
    chunk (ortho/pipeline.py's ``_warp_chunk_update`` fold, SPMD-ified).
    Host reads / quantization / transfer overlap the device folds
    exactly like the single-chip path."""
    from jax.sharding import NamedSharding

    from ..io.ingest import dequant_slab, stream_cube_fold

    run = _sharded_two_pass_build(glt_flat_idx, rows, mesh, axis, method,
                                  fill, halo, precision)
    hd, wd = np.asarray(rows).shape
    h, w, n_bands = shape_hwb
    gf = jnp.asarray(glt_flat_idx)
    gv = jnp.asarray(glt_valid)
    rows_j = jnp.asarray(rows)
    cols_j = jnp.asarray(cols)
    cs = jnp.asarray(cstar)

    @partial(jax.jit, donate_argnums=0)
    def fold_prog(utm, payload, b0, gf, gv, rows_j, cols_j, cs):
        x = dequant_slab(payload, transfer, fill)
        wchunk = run(x, gf, gv, rows_j, cols_j, cs)
        return jax.lax.dynamic_update_slice(
            utm, wchunk, (jnp.int32(0), jnp.int32(0), b0))

    def fold(utm, payload, b0):
        return fold_prog(utm, payload, b0, gf, gv, rows_j, cols_j, cs)

    utm0 = jax.device_put(
        jnp.full((hd, wd, n_bands), jnp.float32(fill)),
        NamedSharding(mesh, P(axis, None, None)))
    return stream_cube_fold(
        read_bands, shape_hwb, fold, utm0, transfer=transfer,
        chunk_bands=chunk_bands, depth=depth, nodata=fill,
        payload_mode=True)


# ---------------------------------------------------------------------------
# Data-parallel spectral-SR inference (the serving path across chips)
# ---------------------------------------------------------------------------

def sharded_sr_predict_u16(model: RidgeSpectralSR, X, valid, mesh: Mesh,
                           axis: str = "data"):
    """Row-sharded granule-scale SR inference: each chip runs the
    fused predict program (standardise -> monomial expansion -> ridge
    matmul -> sigmoid -> u16 quantize) on its pixel shard; no
    collectives are needed (the model parameters replicate). The
    multi-chip form of ``RidgeSpectralSR.predict_cube_u16`` for
    production serving.

    X (N, Bx) f32 (finite), valid (N,) bool; N must divide the mesh
    axis size. Returns (N, By) uint16 (65535 = nodata).
    """
    from ..kernels.lstsq import sigmoid

    assert model.params is not None, "fit() first"
    p = model.params
    n = X.shape[0]
    n_dev = mesh.shape[axis]
    if n % n_dev:
        raise ValueError(f"N={n} must divide the '{axis}' axis "
                         f"({n_dev}) — pad the pixel rows first")

    def local(X_s, v_s):
        # one-shot per shard (a shard is already 1/n_dev of the cube;
        # fori-batching inside shard_map trips the varying-manual-axes
        # carry check) — the exact _predict_quant_batches math, at the
        # same HIGHEST precision
        z = jnp.dot(model.expand((X_s - p.x_mean) / p.x_std), p.W,
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST) + p.intercept
        q = jnp.clip(jnp.rint(sigmoid(z) * 10000.0), 0.0,
                     65534.0).astype(jnp.uint16)
        return jnp.where(v_s[:, None], q, jnp.uint16(65535))

    run = shard_map(local, mesh=mesh, in_specs=(P(axis), P(axis)),
                    out_specs=P(axis))
    return run(jnp.asarray(X, jnp.float32), jnp.asarray(valid))


# ---------------------------------------------------------------------------
# 2-axis mesh: row-sharded two-pass warp x band-sharded SRF synthesis
# ---------------------------------------------------------------------------

def sharded_orthowarp_srf_2d(raw, glt_flat_idx, glt_valid, rows, cols,
                             cstar, weights_bs, mesh: Mesh,
                             row_axis: str = "row",
                             band_axis: str = "band",
                             method: str = "cubic",
                             fill: float = -9999.0, halo: int = 32,
                             precision: str = "highest"):
    """GLT ortho-warp + SRF band synthesis on a 2-D (row x band) mesh —
    proof that the framework's two production shardings COMPOSE: the
    spatial decomposition of :func:`sharded_orthowarp_two_pass`
    (ppermute halo exchange along ``row_axis``) runs simultaneously
    with the spectral decomposition of :func:`sharded_srf_synthesize`
    (psum contraction along ``band_axis``). Each (i, j) chip gathers +
    warps only its scanline block of its band slice, then contracts it
    against its slice of the SRF weight matrix; one psum over
    ``band_axis`` assembles the (Hd, Wd, S) pseudo-S2 product, left
    row-sharded for downstream stages.

    raw (Hr, Wr, B) with B divisible by the band axis; the spatial
    fields follow :func:`sharded_orthowarp_two_pass`'s divisibility /
    halo contract on ``row_axis``. Returns the synthesized (Hd, Wd, S)
    stack (fill-invalid pixels contain garbage exactly like the
    single-chip ``srf_synthesize`` on a fill-carrying cube — mask with
    the warped band-0 validity downstream, _fusion_core semantics).
    """
    from ..kernels.warp import _two_pass_pass1, _two_pass_pass2

    n = mesh.shape[row_axis]
    nb = mesh.shape[band_axis]
    ho, wo = np.asarray(glt_flat_idx).shape
    hd, wd = np.asarray(rows).shape
    b_total = np.asarray(raw).shape[-1]
    if ho % n or hd % n:
        raise ValueError(f"source height {ho} and destination height "
                         f"{hd} must divide the '{row_axis}' axis {n}")
    if b_total % nb:
        raise ValueError(f"band count {b_total} must divide the "
                         f"'{band_axis}' axis {nb}")
    if halo > ho // n:
        raise ValueError(f"halo {halo} exceeds the per-shard scanline "
                         f"count {ho // n}")
    ho_l, hd_l = ho // n, hd // n
    radius = 2.0 if method == "cubic" else 1.0
    rows_np = np.asarray(rows)
    for i in range(n):
        blk = rows_np[i * hd_l:(i + 1) * hd_l]
        lo = np.floor(blk.min() - radius)
        hi = np.ceil(blk.max() + radius)
        if lo < i * ho_l - halo or hi > (i + 1) * ho_l + halo:
            raise ValueError(
                f"destination shard {i} needs scanlines [{lo}, {hi}] "
                f"outside its halo window; increase halo")
    prec = _PRECISIONS[precision]

    @partial(shard_map, mesh=mesh,
             in_specs=(P(None, None, band_axis), P(row_axis),
                       P(row_axis), P(row_axis), P(row_axis),
                       P(row_axis), P(band_axis, None)),
             out_specs=P(row_axis))
    def run(raw_s, gf_s, gv_s, rows_s, cols_s, cstar_s, w_s):
        idx = jax.lax.axis_index(row_axis)
        b = raw_s.shape[-1]          # local band slice
        raw_flat = raw_s.reshape(-1, b)
        v = jnp.take(raw_flat, gf_s.reshape(-1),
                     axis=0).reshape(gf_s.shape + (b,))
        validf = gv_s.astype(jnp.float32)[..., None]
        src_ext = jnp.concatenate([v * validf, validf], axis=-1)
        h_t = _two_pass_pass1(src_ext, cstar_s, wd, method,
                              min(64, ho_l), prec)
        fwd = [(j, (j + 1) % n) for j in range(n)]
        bwd = [(j, (j - 1) % n) for j in range(n)]
        from_prev = jax.lax.ppermute(h_t[:, -halo:], row_axis, fwd)
        from_next = jax.lax.ppermute(h_t[:, :halo], row_axis, bwd)
        h_ext = jnp.concatenate([from_prev, h_t, from_next], axis=1)
        offset = (idx * ho_l - halo).astype(jnp.float32)
        rows_local = rows_s - offset
        m_global = (jnp.arange(ho_l + 2 * halo, dtype=jnp.float32)
                    + offset)
        m_valid = ((m_global >= 0) & (m_global < ho)
                   & (m_global >= (idx - 1) * ho_l)
                   & (m_global < (idx + 2) * ho_l)).astype(jnp.float32)
        out_ext = _two_pass_pass2(h_ext, rows_local, method,
                                  min(64, hd_l), prec, m_valid=m_valid)
        den = out_ext[..., -1:]
        good = jnp.abs(den) > 1e-6
        res = jnp.where(good,
                        out_ext[..., :b] / jnp.where(good, den, 1.0),
                        jnp.asarray(fill, jnp.float32))
        centre_in = ((rows_s >= -0.5) & (rows_s <= ho - 0.5)
                     & (cols_s >= -0.5)
                     & (cols_s <= wo - 0.5))[..., None]
        res = jnp.where(centre_in, res, jnp.asarray(fill, jnp.float32))
        # band-sharded SRF contraction: psum assembles the synthesis
        part = jnp.dot(res.reshape(-1, b), w_s,
                       preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
        return jax.lax.psum(part.reshape(hd_l, wd, -1), band_axis)

    return run(jnp.asarray(raw, jnp.float32), jnp.asarray(glt_flat_idx),
               jnp.asarray(glt_valid), jnp.asarray(rows),
               jnp.asarray(cols), jnp.asarray(cstar),
               jnp.asarray(weights_bs, jnp.float32))
