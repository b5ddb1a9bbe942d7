"""Paired tiling for ML dataset prep.

Reference semantics (tiles_helpers/utils.py):
- ``is_black_mask`` — a pixel is invalid when all bands are ~nodata, all
  bands are ~-0.01 (EMIT masked reflectance), or all bands are ~0
  (:201-220);
- ``find_valid_paired_tiles`` — scan the EMIT grid in
  ``emit_tile_size`` steps with the S2 window scaled by ``scale``, keep
  pairs whose black fraction is within threshold (:223-305);
- ``save_tile_pair`` — EMIT scaled x10000 to uint16 (nodata 65535),
  tiled DEFLATE GeoTIFFs, tags/descriptions preserved (:308-440);
- ``write_emit_b32_tile`` — evenly subsampled 32-band tile (:444-491).

Device reformulation: the double window loop becomes ONE device
program — compute the black mask over the full raster, block-reduce it
to per-tile black fractions for EMIT and S2 simultaneously, and read the
(few) accepted windows afterwards. No per-tile host round trips.
"""

from __future__ import annotations

from functools import partial
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..core.cube import subsample_bands_evenly
from ..core.grid import Window
from ..io.tiff import TiffReader, write_geotiff
from ..kernels.stats import quantize_reflectance_u16


@partial(jax.jit, static_argnames=())
def is_black_mask(arr_bhw: jax.Array, nodata: Optional[float] = None,
                  masked_val: float = -0.01, nodata_atol: float = 1e-3,
                  zero_atol: float = 1e-6) -> jax.Array:
    """(B, H, W) -> (H, W) bool of black/invalid pixels (reference
    formula, tiles_helpers/utils.py:201-220)."""
    if nodata is not None:
        nodata_mask = jnp.all(jnp.abs(arr_bhw - nodata) <= nodata_atol,
                              axis=0)
    else:
        nodata_mask = jnp.zeros(arr_bhw.shape[1:], dtype=bool)
    masked_mask = jnp.all(jnp.abs(arr_bhw - masked_val) <= nodata_atol,
                          axis=0)
    zero_mask = jnp.all(jnp.abs(arr_bhw) < zero_atol, axis=0)
    return nodata_mask | masked_mask | zero_mask


@partial(jax.jit, static_argnames=("tile",))
def tile_black_fractions(black_hw: jax.Array, tile: int) -> jax.Array:
    """(H, W) bool -> (H//tile, W//tile) black fraction per tile —
    the whole tile scan as one block reduction."""
    h, w = black_hw.shape
    th, tw = h // tile, w // tile
    sub = black_hw[:th * tile, :tw * tile]
    return sub.reshape(th, tile, tw, tile).mean(axis=(1, 3))


def find_valid_paired_tiles(
    emit: Union[str, Path, np.ndarray],
    s2: Union[str, Path, np.ndarray],
    emit_tile_size: int = 100,
    scale: int = 6,
    max_black_frac: float = 0.0,
    max_tiles: Optional[int] = None,
    emit_nodata: Optional[float] = None,
    s2_nodata: Optional[float] = None,
) -> List[Dict]:
    """Returns tile descriptors [{idx, emit_window, s2_window,
    emit_black_frac, s2_black_frac}] with the reference's acceptance rule.
    Inputs are GeoTIFF paths or in-memory (B, H, W) arrays."""
    def load(src, nodata):
        if isinstance(src, (str, Path)):
            with TiffReader(src) as r:
                return r.read().astype(np.float32), (
                    nodata if nodata is not None else r.nodata)
        return np.asarray(src, dtype=np.float32), nodata

    emit_arr, emit_nodata = load(emit, emit_nodata)
    s2_arr, s2_nodata = load(s2, s2_nodata)

    h_e, w_e = emit_arr.shape[1:]
    h_s, w_s = s2_arr.shape[1:]

    emit_black = is_black_mask(jnp.asarray(emit_arr), emit_nodata)
    s2_black = is_black_mask(jnp.asarray(s2_arr), s2_nodata)

    t = emit_tile_size
    fe = np.asarray(tile_black_fractions(emit_black, t))
    fs = np.asarray(tile_black_fractions(s2_black, t * scale))

    tiles: List[Dict] = []
    idx = 0
    n_rows = (h_e - t) // t + 1 if h_e >= t else 0
    n_cols = (w_e - t) // t + 1 if w_e >= t else 0
    for ty in range(n_rows):
        for tx in range(n_cols):
            row_s = ty * t * scale
            col_s = tx * t * scale
            if row_s + t * scale > h_s or col_s + t * scale > w_s:
                continue
            if ty >= fe.shape[0] or tx >= fe.shape[1]:
                continue
            ef = float(fe[ty, tx])
            sf = float(fs[ty, tx]) if (ty < fs.shape[0] and tx < fs.shape[1]) else 1.0
            if ef <= max_black_frac and sf <= max_black_frac:
                tiles.append({
                    "idx": idx,
                    "emit_window": Window(tx * t, ty * t, t, t),
                    "s2_window": Window(col_s, row_s, t * scale, t * scale),
                    "emit_black_frac": ef,
                    "s2_black_frac": sf,
                })
                idx += 1
                if max_tiles is not None and len(tiles) >= max_tiles:
                    return tiles
    return tiles


def save_tile_pair(
    emit_path: Union[str, Path],
    s2_path: Union[str, Path],
    tile_info: Dict,
    out_dir: Union[str, Path],
    *,
    overwrite: bool = True,
    emit_scale: float = 10000.0,
    emit_nodata_u16: int = 65535,
    zlevel: int = 1,
) -> Tuple[Path, Path]:
    """Write the paired tile GeoTIFFs: EMIT quantized to uint16
    (tiles_helpers/utils.py:308-440). Returns (emit_out, s2_out)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    k = int(tile_info["idx"])
    emit_out = out_dir / f"tile_{k:03d}_emit.tif"
    s2_out = out_dir / f"tile_{k:03d}_s2.tif"
    if not overwrite and emit_out.exists() and s2_out.exists():
        return emit_out, s2_out

    w_emit: Window = tile_info["emit_window"]
    w_s2: Window = tile_info["s2_window"]

    def _auto_block(width: int, height: int) -> int:
        m = min(width, height)
        if m >= 256:
            return 256
        if m >= 64:
            return 64
        return 16

    with TiffReader(emit_path) as er, TiffReader(s2_path) as sr:
        emit_tile = er.read(window=w_emit).astype(np.float32)
        s2_tile = sr.read(window=w_s2)
        if emit_tile.size == 0:
            raise ValueError(f"Empty EMIT tile idx={k}, window={w_emit}")
        if s2_tile.size == 0:
            raise ValueError(f"Empty S2 tile idx={k}, window={w_s2}")

        valid = np.isfinite(emit_tile)
        if er.nodata is not None:
            valid &= emit_tile != er.nodata
        emit_u16 = np.asarray(quantize_reflectance_u16(
            jnp.asarray(emit_tile), jnp.asarray(valid),
            scale=emit_scale, nodata_u16=emit_nodata_u16))

        emit_grid = er.grid.window_grid(w_emit) if er.grid else None
        s2_grid = sr.grid.window_grid(w_s2) if sr.grid else None
        eb = _auto_block(w_emit.width, w_emit.height)
        sb = _auto_block(w_s2.width, w_s2.height)

        write_geotiff(emit_out, emit_u16, emit_grid,
                      nodata=emit_nodata_u16, compress="deflate",
                      zlevel=zlevel, predictor=2, tiled=True,
                      blockxsize=eb, blockysize=eb,
                      descriptions=er.descriptions,
                      tags=er.dataset_tags, band_tags=er.band_tags)
        s2_is_int = np.issubdtype(s2_tile.dtype, np.integer)
        write_geotiff(s2_out, s2_tile, s2_grid, nodata=sr.nodata,
                      compress="deflate", zlevel=zlevel,
                      predictor=2 if s2_is_int else 1, tiled=True,
                      blockxsize=sb, blockysize=sb,
                      descriptions=sr.descriptions)
    return emit_out, s2_out


def write_emit_b32_tile(
    emit_tile_path: Union[str, Path],
    *,
    num_keep: int = 32,
    idx_0based: Optional[np.ndarray] = None,
    overwrite: bool = True,
) -> Tuple[Path, np.ndarray]:
    """Evenly subsampled band subset of an EMIT tile
    (tiles_helpers/utils.py:460-491)."""
    emit_tile_path = Path(emit_tile_path)
    out = emit_tile_path.with_name(emit_tile_path.stem
                                   + f"_b{num_keep}.tif")
    with TiffReader(emit_tile_path) as src:
        if idx_0based is None:
            if src.count < num_keep:
                raise ValueError(
                    f"Tile has only {src.count} bands, can't keep {num_keep}.")
            idx_0based = subsample_bands_evenly(src.count, num_keep=num_keep)
        idx_0based = np.asarray(idx_0based, dtype=int)
        if out.exists() and not overwrite:
            return out, idx_0based
        data = src.read(bands=list(idx_0based))
        descs = [src.descriptions[i] if i < len(src.descriptions) else None
                 for i in idx_0based]
        write_geotiff(out, data, src.grid, nodata=src.nodata,
                      compress="deflate", predictor=2, tiled=True,
                      descriptions=descs, tags=src.dataset_tags)
    return out, idx_0based
