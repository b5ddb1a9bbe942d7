"""EMIT granule -> analysis-ready S2-anchored cube (the ``nc_to_envi``
equivalent, reference: EMIT_data/emit_proj.py:563-1356).

Device flow per product (DATA / LOC / OBS):
1. host: open granule (framework HDF5 codec), GLT -> flat indices,
2. device: one-op GLT gather of the full cube onto the geographic ortho
   grid (no 32-band chunk loop — that was a host-RAM workaround),
3. device: cubic warp onto the S2-anchored UTM 60 m grid (coordinate
   field from the f64 CRS engine; _compute_te snap contract),
4. host: ENVI + GeoTIFF + XML sidecar writes, with an ``info`` ledger
   recording every stage, timing, and raster geometry (generalising the
   reference's commands/outputs/rasters record, emit_proj.py:820-855).

Idempotency contract preserved: existing outputs are skipped unless
``overwrite`` (emit_proj.py:816-872).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from functools import partial
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.config import OrthoConfig
from ..core.constants import NO_DATA_VALUE
from ..core.grid import Grid, s2_anchored_target_grid
from ..io import envi
from ..io.granule import EmitGranule
from ..io.tiff import TiffReader
from ..io.xml_sidecar import write_xml_sidecar
from ..kernels.glt import glt_gather, prepare_glt
from ..kernels.warp import (
    orthowarp_taploop, orthowarp_two_pass, resample_to_grid,
    scanline_cstar, select_warp_backend, source_index_field,
)
from . import products

# EMIT L1B OBS band names (the 11 geometry bands,
# reference: EMIT_data/emit_proj.py:29-115)
OBS_BAND_NAMES = [
    "Path length (sensor-to-ground in meters)",
    "To-sensor azimuth (0 to 360 degrees CW from N)",
    "To-sensor zenith (0 to 90 degrees from zenith)",
    "To-sun azimuth (0 to 360 degrees CW from N)",
    "To-sun zenith (0 to 90 degrees from zenith)",
    "Solar phase (degrees between to-sensor and to-sun vectors)",
    "Slope (local surface slope as derived from DEM in degrees)",
    "Aspect (local surface aspect 0 to 360 degrees clockwise from N)",
    "Cosine(i) (apparent local illumination factor)",
    "UTC Time (decimal hours for mid-line pixels)",
    "Earth-sun distance (AU)",
]


def raster_meta(grid: Grid, shape, dtype: str, nodata=None) -> Dict:
    """Compact raster geometry record (emit_proj.py:281-306 analogue)."""
    return {
        "crs": str(grid.crs),
        "transform": list(grid.geotransform),
        "width": grid.width,
        "height": grid.height,
        "bounds": list(grid.bounds),
        "shape": list(shape),
        "dtype": str(dtype),
        "nodata": nodata,
    }


@dataclass
class OrthoResult:
    data_envi_bin: Path
    utm_grid: Grid
    info: Dict = field(default_factory=dict)
    # device-resident UTM DATA cube (populated when keep_device_cube is
    # requested and the DATA product was computed this run) — lets the
    # fusion stage run without a disk/host round-trip
    device_cube: object = None
    wavelengths: Optional[np.ndarray] = None
    good_mask: Optional[np.ndarray] = None


def _grid_from_s2_tif(s2_tif_path: Union[str, Path]) -> Grid:
    with TiffReader(s2_tif_path) as r:
        if r.grid is None:
            raise ValueError(f"S2 template has no georeferencing: {s2_tif_path}")
        return r.grid


@partial(jax.jit, donate_argnums=0,
         static_argnames=("method", "kernel", "row_chunks", "transfer",
                          "banded_group"))
def _warp_chunk_update(utm, payload, b0, flat_idx, valid, wr, wc, cstar,
                       method, kernel, row_chunks, transfer,
                       banded_group=None):
    """Dequant + orthowarp one band chunk and write it into the UTM
    accumulator — the fold step of the compute-overlapped ingest (each
    chunk's warp runs while the next chunk is read/quantized/shipped;
    the full raw cube never materializes in HBM). The u16/u12 dequant
    (bit-unpack + per-band affine) runs INSIDE this program, so it fuses
    with the warp's GLT gather instead of writing an f32 chunk."""
    from ..io.ingest import dequant_slab
    chunk = dequant_slab(payload, transfer, NO_DATA_VALUE)
    if kernel == "two_pass":
        w = orthowarp_two_pass(chunk, flat_idx, valid, wr, wc, cstar,
                               method=method, fill=NO_DATA_VALUE,
                               banded_group=banded_group)
    else:
        w = orthowarp_taploop(chunk, flat_idx, valid, wr, wc,
                              method=method, fill=NO_DATA_VALUE,
                              row_chunks=row_chunks)
    return lax.dynamic_update_slice(
        utm, w, (jnp.int32(0), jnp.int32(0), b0))


@partial(jax.jit, donate_argnums=0,
         static_argnames=("method", "kernel", "row_chunks", "transfer",
                          "banded_group"))
def _warp_chunk_update_bandmask(utm, payload, b0, flat_idx, valid, wr, wc,
                                cstar, method, kernel, row_chunks,
                                transfer, banded_group=None):
    """Band-masked fold step: the dequantized chunk is [data * vb | vb]
    (2 nb channels, vb the per-band 0/1 validity from the L2A band
    mask). Both halves ride the SAME warp, so dividing the warped
    premultiplied data by the warped validity renormalises each band's
    interpolation around its masked sources — exact per-band-nodata
    gdalwarp semantics, with zero extra gather traffic (just 2x matmul
    channels)."""
    from ..io.ingest import dequant_slab
    chunk2 = dequant_slab(payload, transfer, NO_DATA_VALUE)
    nb = chunk2.shape[-1] // 2
    if kernel == "two_pass":
        w = orthowarp_two_pass(chunk2, flat_idx, valid, wr, wc, cstar,
                               method=method, fill=NO_DATA_VALUE,
                               banded_group=banded_group)
    else:
        w = orthowarp_taploop(chunk2, flat_idx, valid, wr, wc,
                              method=method, fill=NO_DATA_VALUE,
                              row_chunks=row_chunks)
    num = w[..., :nb]
    den = w[..., nb:]
    # den <= eps: every contributing source (or the whole pixel) was
    # masked -> nodata. The eps absorbs cubic-lobe cancellation noise.
    good = den > 1e-3
    band = jnp.where(good, num / jnp.where(good, den, 1.0),
                     jnp.float32(NO_DATA_VALUE))
    return lax.dynamic_update_slice(
        utm, band, (jnp.int32(0), jnp.int32(0), b0 // 2))


@partial(jax.jit, static_argnames=("n_keep",))
def _slice_bands(cube, n_keep):
    # no donation: the smaller output cannot alias the padded input
    return lax.slice_in_dim(cube, 0, n_keep, axis=-1)


class _StageTimer:
    def __init__(self, info: Dict):
        self.info = info.setdefault("stages", {})

    def record(self, name: str, t0: float, **extra):
        rec = {"seconds": round(time.perf_counter() - t0, 6)}
        rec.update(extra)
        self.info[name] = rec


def orthorectify_granule(
    img_file: Union[str, Path],
    out_dir: Union[str, Path],
    s2_grid: Union[Grid, str, Path],
    *,
    obs_file: Union[str, Path, None] = None,
    mask_file: Union[str, Path, None] = None,
    export_loc: bool = False,
    config: OrthoConfig = OrthoConfig(),
    tag: Optional[str] = None,
    save_info_path: Union[str, Path, None] = None,
    keep_device_cube: bool = False,
) -> OrthoResult:
    """Full DATA (+ optional LOC / OBS) ortho export onto the S2-anchored
    UTM 60 m grid. Returns the main projected ENVI path + info ledger.

    ``mask_file``: optional EMIT L2A mask granule. Its quality mask
    (``config.quality_bands`` flag bands, emit_tools.py:271-298) is
    folded into the GLT validity channel, so masked raw pixels are
    excluded from the warp's interpolation (nodata-aware gdalwarp
    semantics) and end up nodata in the DATA product — and therefore
    excluded from fusion fits, tile black-fraction checks and SR
    training downstream (the reference applies the mask to the cube in
    its notebooks before use). Set ``config.apply_band_mask`` to
    additionally apply the packed per-pixel-per-band mask
    (emit_tools.py:301-321) pointwise after the warp."""
    cfg = config
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if not isinstance(s2_grid, Grid):
        s2_grid = _grid_from_s2_tif(s2_grid)

    img_path = Path(img_file)
    if tag is None:
        tag = img_path.stem.replace("EMIT_", "")

    data_utm = out_dir / f"{tag}.bin"
    data_hdr = data_utm.with_suffix(".hdr")
    loc_utm = out_dir / f"{tag}_LOC.bin"
    loc_hdr = loc_utm.with_suffix(".hdr")
    obs_utm = out_dir / f"{tag}_OBS.bin"
    obs_hdr = obs_utm.with_suffix(".hdr")

    export_loc = export_loc or cfg.export_loc
    need_data = cfg.overwrite or not (data_utm.exists() and data_hdr.exists())
    need_loc = export_loc and (cfg.overwrite
                               or not (loc_utm.exists() and loc_hdr.exists()))
    need_obs = (obs_file is not None) and (
        cfg.overwrite or not (obs_utm.exists() and obs_hdr.exists()))

    g = EmitGranule(img_path)
    description = ("Radiance micro-watts/cm^2/nm/sr"
                   if g.product == "L1B_RDN" else "Reflectance (unitless)")

    info: Dict = {
        "img_file": str(img_path),
        "obs_file": str(obs_file) if obs_file else None,
        "mask_file": str(mask_file) if mask_file else None,
        "tag": tag,
        "backend": "hyperres-hdf5",
        "product": g.product,
        "description": description,
        "time": {"start": g.time_coverage_start, "end": g.time_coverage_end},
        "out": {
            "out_crs": str(s2_grid.crs),
            "out_epsg": s2_grid.crs.epsg,
            "pixel_size_m": [cfg.target_res_m, cfg.target_res_m],
            "nodata": NO_DATA_VALUE,
            "resampling": cfg.resampling,
            # ingest traceability: the streamed u16/u12 transfer is a
            # (documented, sub-sensor-noise) lossy step versus f32, so
            # the product ledger records which path produced the cube
            "streaming_ingest": cfg.streaming_ingest,
            "ingest_transfer": (cfg.ingest_transfer
                                if cfg.streaming_ingest else "f32"),
        },
        "s2_align": {
            "s2_grid_extent": list(s2_grid.bounds),
            "s2_origin": [s2_grid.x0, s2_grid.y0],
            "s2_transform": list(s2_grid.geotransform),
            "emit_target_ps": [cfg.target_res_m, cfg.target_res_m],
            "emit_anchor_mode": "s2_origin",
        },
        "outputs": {},
        "rasters": {},
    }
    timer = _StageTimer(info)

    if not (need_data or need_loc or need_obs):
        info["outputs"]["data_envi_bin"] = str(data_utm)
        info["outputs"]["data_envi_hdr"] = str(data_hdr)
        # register every product that already exists so resumed runs see
        # the same outputs record as the run that produced them
        # (the reference's skip path, emit_proj.py:816-872)
        geotiff_dir = out_dir / "geotiff"
        for key, path in {
            "data_utm_tif": geotiff_dir / f"{tag}_DATA_warp_utm.tif",
            "loc_utm_tif": geotiff_dir / f"{tag}_LOC_warp_utm.tif",
            "obs_utm_tif": geotiff_dir / f"{tag}_OBS_warp_utm.tif",
            "data_xml": data_utm.with_suffix(".xml"),
        }.items():
            if path.exists():
                info["outputs"][key] = str(path)
        if export_loc:
            info["outputs"]["loc_envi_bin"] = str(loc_utm)
        if obs_file is not None:
            info["outputs"]["obs_envi_bin"] = str(obs_utm)
        info["skipped"] = True
        _save_info(info, save_info_path)
        wavelengths = (np.asarray(g.wavelengths)
                       if g.wavelengths is not None else None)
        good_mask = g.good_wavelengths
        grid = s2_anchored_target_grid(g.ortho_grid, s2_grid,
                                       cfg.target_res_m, cfg.target_res_m)
        g.close()
        return OrthoResult(data_utm, grid, info,
                           wavelengths=wavelengths, good_mask=good_mask)

    # --- GLT preparation (host) ---
    t0 = time.perf_counter()
    flat_idx, valid = prepare_glt(g.glt, (g.raw_height, g.raw_width))
    # diag counts straight from prepare_glt's masks (glt_indices would
    # redo the same full-raster conversion+bounds pass)
    n_nonzero = int(np.count_nonzero(np.all(g.glt != 0, axis=-1)))
    n_inbounds = int(np.count_nonzero(valid))
    info["glt_diag"] = {
        "raw_shape_yx": [g.raw_height, g.raw_width],
        "valid_glt_count": n_nonzero,
        "valid_glt_inbounds_count": n_inbounds,
        "valid_glt_dropped_oob": n_nonzero - n_inbounds,
    }
    flat_j = jnp.asarray(flat_idx)
    valid_j = jnp.asarray(valid)
    timer.record("glt_prep", t0)

    # --- target UTM grid (the _compute_te contract) ---
    utm_grid = s2_anchored_target_grid(g.ortho_grid, s2_grid,
                                       cfg.target_res_m, cfg.target_res_m)

    # geographic corner ring of the ortho grid (emit_proj.py:731-744)
    og = g.ortho_grid
    corners = [[og.x0, og.y0],
               [og.x0 + og.width * og.dx, og.y0],
               [og.x0 + og.width * og.dx, og.y0 - og.height * og.dy],
               [og.x0, og.y0 - og.height * og.dy]]

    wr_field, wc_field = source_index_field(g.ortho_grid, utm_grid)
    wr_j = jnp.asarray(wr_field)
    wc_j = jnp.asarray(wc_field)
    use_two_pass = (cfg.fused_orthowarp and cfg.warp_kernel == "two_pass"
                    and cfg.resampling in ("cubic", "bilinear"))
    cstar_np = (scanline_cstar(wr_field, wc_field, g.ortho_grid.height)
                if use_two_pass else None)
    cstar_j = jnp.asarray(cstar_np) if cstar_np is not None else None
    warp_backend, banded_group = "dense", None
    if use_two_pass:
        warp_backend, banded_group = select_warp_backend(
            cstar_np, wr_field, cfg.warp_backend)
    info["out"]["warp_backend"] = warp_backend
    if banded_group is not None:
        info["out"]["banded_group"] = int(banded_group)

    device_holder: Dict = {}

    def _export_product(cube_raw, kind: str, envi_path: Path,
                        hdr_extra: Dict,
                        utm_precomputed=None,
                        valid_arg=None) -> Tuple[np.ndarray, Grid]:
        """gather -> warp -> ENVI write; returns the UTM cube.
        ``utm_precomputed`` skips straight to the write (the streamed
        fold path already produced the device UTM cube).
        ``valid_arg`` overrides the GLT validity (quality-masked DATA)."""
        va = valid_arg if valid_arg is not None else valid_j
        if utm_precomputed is not None:
            utm_dev = utm_precomputed
        elif use_two_pass:
            t = time.perf_counter()
            utm_dev = orthowarp_two_pass(
                jnp.asarray(cube_raw, jnp.float32), flat_j, va,
                wr_j, wc_j, cstar_j, method=cfg.resampling,
                fill=NO_DATA_VALUE, banded_group=banded_group)
            timer.record(f"{kind}_two_pass_orthowarp", t,
                         shape=list(utm_dev.shape),
                         resampling=cfg.resampling)
        elif cfg.fused_orthowarp and cfg.resampling in ("cubic", "bilinear"):
            t = time.perf_counter()
            utm_dev = orthowarp_taploop(
                jnp.asarray(cube_raw, jnp.float32), flat_j, va,
                wr_j, wc_j, method=cfg.resampling, fill=NO_DATA_VALUE,
                row_chunks=cfg.orthowarp_row_chunks)
            timer.record(f"{kind}_fused_orthowarp", t,
                         shape=list(utm_dev.shape),
                         resampling=cfg.resampling)
        else:
            t = time.perf_counter()
            ortho = glt_gather(jnp.asarray(cube_raw, jnp.float32), flat_j,
                               va, fill_value=NO_DATA_VALUE)
            ortho.block_until_ready()
            timer.record(f"{kind}_gather", t,
                         shape=list(ortho.shape))
            t = time.perf_counter()
            utm_dev = resample_to_grid(ortho, g.ortho_grid, utm_grid,
                                       method=cfg.resampling,
                                       nodata=NO_DATA_VALUE,
                                       fill=NO_DATA_VALUE)
            timer.record(f"{kind}_warp", t, shape=list(utm_dev.shape),
                         resampling=cfg.resampling)
        if keep_device_cube and kind == "data":
            device_holder["data"] = utm_dev
        utm = np.asarray(utm_dev)
        t = time.perf_counter()
        envi.write_cube(
            envi_path, utm.astype(np.float32), utm_grid,
            interleave="bil", nodata=NO_DATA_VALUE,
            extra_header=hdr_extra)
        timer.record(f"{kind}_envi_write", t)
        return utm, utm_grid

    geotiff_dir = out_dir / "geotiff"
    result_grid = utm_grid

    # ===== DATA =====
    if need_data:
        # L2A quality / band masks (emit_tools.py:271-321). The quality
        # mask (spatial, all bands) folds into the GLT validity channel:
        # masked raw pixels simply stop being valid warp sources, so the
        # resampler renormalises around them EXACTLY like a nodata-aware
        # gdalwarp — no sentinel values ever enter the interpolation.
        # The per-(pixel, band) band mask rides the warp as
        # premultiplied validity planes (see _warp_chunk_update_bandmask).
        read_bands = g.read_bands
        data_valid_j = valid_j
        vb = None
        if mask_file is not None:
            from ..io.granule import EmitMaskGranule
            t0 = time.perf_counter()
            with EmitMaskGranule(mask_file) as mg:
                qmask = mg.quality_mask(cfg.quality_bands).astype(bool)
                bmask = (mg.band_mask().astype(bool)
                         if cfg.apply_band_mask else None)
            if qmask.shape != (g.raw_height, g.raw_width):
                raise ValueError(
                    f"mask granule shape {qmask.shape} does not match "
                    f"raw cube ({g.raw_height}, {g.raw_width})")
            data_valid = valid & ~qmask.reshape(-1)[flat_idx]
            data_valid_j = jnp.asarray(data_valid)
            info["mask"] = {
                "quality_bands": list(cfg.quality_bands),
                "quality_masked_px": int(qmask.sum()),
                "ortho_cells_quality_masked":
                    int(valid.sum() - data_valid.sum()),
                "band_mask_applied": bmask is not None,
                "band_masked_px": 0,
            }
            if bmask is not None:
                if bmask.shape[-1] < g.n_bands:
                    raise ValueError(
                        f"band mask has {bmask.shape[-1]} bands for a "
                        f"{g.n_bands}-band cube")
                bmask = bmask[:, :, :g.n_bands]
                info["mask"]["band_masked_px"] = int(bmask.sum())
                vb = (~bmask).astype(np.float32)
                if not (cfg.fused_orthowarp
                        and cfg.resampling in ("cubic", "bilinear")):
                    raise ValueError(
                        "apply_band_mask needs the fused orthowarp path "
                        "(fused_orthowarp=True, cubic/bilinear)")
            timer.record("mask_read", t0)

        raw = None
        utm_pre = None
        streaming = cfg.streaming_ingest and g.n_bands > cfg.band_chunk
        can_fold = (streaming and cfg.fused_orthowarp
                    and cfg.resampling in ("cubic", "bilinear"))
        if vb is not None:
            # band-masked streamed fold: each chunk ships
            # [data * vb | vb] and the fold renormalises per band
            from ..io.ingest import stream_cube_fold
            t0 = time.perf_counter()
            kernel = "two_pass" if use_two_pass else "taploop"
            cb = cfg.band_chunk
            n_chunks = -(-g.n_bands // cb)
            b_pad = n_chunks * cb
            utm0 = jnp.full(
                (utm_grid.height, utm_grid.width, b_pad),
                jnp.float32(NO_DATA_VALUE))
            cstar_arg = (cstar_j if cstar_j is not None
                         else jnp.zeros((1, 1), jnp.float32))

            def read2(b0, b1):
                # b0 runs in DOUBLED band space (2*cb per chunk); each
                # slab is a fixed-width [data*vb(cb) | vb(cb)] pair,
                # zero-padded per half so every fold sees one shape
                k = b0 // (2 * cb)
                a0 = k * cb
                a1 = min(a0 + cb, g.n_bands)
                slab = np.asarray(g.read_bands(a0, a1), dtype=np.float32)
                v = vb[:, :, a0:a1]
                m = a1 - a0
                if m < cb:
                    z = np.zeros(slab.shape[:2] + (cb - m,), np.float32)
                    return np.concatenate([slab * v, z, v, z], axis=-1)
                return np.concatenate([slab * v, v], axis=-1)

            def fold2(utm, payload, b0):
                return _warp_chunk_update_bandmask(
                    utm, payload, b0, flat_j, data_valid_j, wr_j, wc_j,
                    cstar_arg, cfg.resampling, kernel,
                    cfg.orthowarp_row_chunks, cfg.ingest_transfer,
                    banded_group)

            utm_pre = stream_cube_fold(
                read2, (g.raw_height, g.raw_width, n_chunks * 2 * cb),
                fold2, utm0, transfer=cfg.ingest_transfer,
                chunk_bands=2 * cb, depth=cfg.ingest_depth,
                payload_mode=True)
            if b_pad != g.n_bands:
                utm_pre = _slice_bands(utm_pre, g.n_bands)
            utm_pre.block_until_ready()
            timer.record("data_bandmasked_streamed_orthowarp", t0,
                         transfer=cfg.ingest_transfer,
                         chunk_bands=cfg.band_chunk, kernel=kernel,
                         resampling=cfg.resampling,
                         shape=[utm_grid.height, utm_grid.width,
                                g.n_bands])
        elif can_fold:
            # compute-overlapped ingest: each chunk's orthowarp runs
            # while the next chunk is read/quantized/shipped; the full
            # raw cube never materializes in HBM (peak = UTM cube + one
            # chunk). Replaces the reference's sequential 32-band loop
            # (emit_proj.py:969-987).
            from ..io.ingest import stream_cube_fold
            t0 = time.perf_counter()
            kernel = "two_pass" if use_two_pass else "taploop"
            n_chunks = -(-g.n_bands // cfg.band_chunk)
            b_pad = n_chunks * cfg.band_chunk
            utm0 = jnp.full(
                (utm_grid.height, utm_grid.width, b_pad),
                jnp.float32(NO_DATA_VALUE))
            cstar_arg = (cstar_j if cstar_j is not None
                         else jnp.zeros((1, 1), jnp.float32))

            def fold(utm, payload, b0):
                return _warp_chunk_update(
                    utm, payload, b0, flat_j, data_valid_j, wr_j, wc_j,
                    cstar_arg, cfg.resampling, kernel,
                    cfg.orthowarp_row_chunks, cfg.ingest_transfer,
                    banded_group)

            utm_pre = stream_cube_fold(
                read_bands, (g.raw_height, g.raw_width, g.n_bands),
                fold, utm0, transfer=cfg.ingest_transfer,
                chunk_bands=cfg.band_chunk, depth=cfg.ingest_depth,
                pad_to_chunk=True, payload_mode=True)
            if b_pad != g.n_bands:
                utm_pre = _slice_bands(utm_pre, g.n_bands)
            utm_pre.block_until_ready()
            timer.record("data_streamed_orthowarp", t0,
                         transfer=cfg.ingest_transfer,
                         chunk_bands=cfg.band_chunk, kernel=kernel,
                         resampling=cfg.resampling,
                         shape=[utm_grid.height, utm_grid.width,
                                g.n_bands])
        elif streaming:
            # chunked HDF5 reads overlapped with quantize + host->HBM
            # transfer and device-side assembly
            from ..io.ingest import stream_cube_to_device
            t0 = time.perf_counter()
            raw = stream_cube_to_device(
                read_bands, (g.raw_height, g.raw_width, g.n_bands),
                transfer=cfg.ingest_transfer,
                chunk_bands=cfg.band_chunk, depth=cfg.ingest_depth)
            raw.block_until_ready()
            timer.record("data_stream_ingest", t0,
                         transfer=cfg.ingest_transfer,
                         chunk_bands=cfg.band_chunk,
                         depth=cfg.ingest_depth)
        else:
            raw = read_bands(0, g.n_bands)
        hdr_extra = {
            "description": description,
            "sensor type": "EMIT",
            "start acquisition time": g.time_coverage_start,
            "end acquisition time": g.time_coverage_end,
            "bounding box": [f"{c[0]:.8f} {c[1]:.8f}" for c in corners],
        }
        # wavelength-less granules (OBS/generic 3-D cubes run as the
        # main product) simply omit the spectral header entries
        if g.wavelengths is not None:
            hdr_extra["wavelength"] = [float(x) for x in g.wavelengths]
            hdr_extra["wavelength units"] = "nanometers"
        if g.fwhm is not None:
            hdr_extra["fwhm"] = [float(x) for x in g.fwhm]
        utm_cube, _ = _export_product(raw, "data", data_utm, hdr_extra,
                                      utm_precomputed=utm_pre,
                                      valid_arg=data_valid_j)
        info["outputs"]["data_envi_bin"] = str(data_utm)
        info["outputs"]["data_envi_hdr"] = str(data_hdr)
        info["rasters"]["data_envi"] = raster_meta(
            utm_grid, utm_cube.shape, "float32", NO_DATA_VALUE)

        if cfg.save_geotiffs:
            geotiff_dir.mkdir(parents=True, exist_ok=True)
            t = time.perf_counter()
            utm_tif = geotiff_dir / f"{tag}_DATA_warp_utm.tif"
            rec = products.export_reflectance_u16(
                utm_cube, utm_grid, utm_tif,
                scale_range=cfg.reflectance_scale)
            timer.record("data_utm_tif", t, **rec)
            info["outputs"]["data_utm_tif"] = str(utm_tif)
            info["rasters"]["data_utm_tif"] = raster_meta(
                utm_grid, utm_cube.shape, "uint16", 65535)
            # diagnostic single-band quicklook (emit_proj.py:989-1012)
            t = time.perf_counter()
            diag_dir = out_dir / "diag"
            diag_dir.mkdir(parents=True, exist_ok=True)
            diag_band = utm_cube.shape[-1] // 2
            diag_tif = diag_dir / (
                f"{tag}_DATA_diag_band{diag_band:03d}_warp_utm.tif")
            products.export_reflectance_u16(
                utm_cube[..., diag_band:diag_band + 1], utm_grid, diag_tif,
                scale_range=cfg.reflectance_scale)
            timer.record("data_diag_tif", t)
            info["outputs"]["data_diag_utm_tif"] = str(diag_tif)

        if cfg.write_xml:
            write_xml_sidecar(
                str(data_utm), product=g.product,
                epsg_str=f"EPSG:{s2_grid.crs.epsg}",
                crs_wkt=s2_grid.crs.to_wkt(),
                pixel_size=(cfg.target_res_m, cfg.target_res_m),
                shape=(utm_grid.height, utm_grid.width, g.n_bands),
                start_time_utc=g.time_coverage_start or "",
                end_time_utc=g.time_coverage_end or "",
                bbox_lonlat=corners,
                wavelengths=([float(x) for x in g.wavelengths]
                             if g.wavelengths is not None else None),
                fwhm=[float(x) for x in g.fwhm] if g.fwhm is not None else None,
                description=description)
            info["outputs"]["data_xml"] = str(data_utm.with_suffix(".xml"))

    # ===== LOC =====
    if need_loc:
        lon = g.location("lon")
        lat = g.location("lat")
        elev = g.location("elev")
        if lon is None or lat is None:
            info["loc_skipped_reason"] = "granule has no location lon/lat"
        else:
            loc_raw = np.stack(
                [lon, lat, elev if elev is not None else np.zeros_like(lon)],
                axis=-1).astype(np.float32)
            loc_cube, _ = _export_product(loc_raw, "loc", loc_utm, {
                "description": "EMIT LOC (lon, lat, elev)",
                "band names": ["longitude", "latitude", "elevation"],
            })
            info["outputs"]["loc_envi_bin"] = str(loc_utm)
            info["rasters"]["loc_envi"] = raster_meta(
                utm_grid, loc_cube.shape, "float32", NO_DATA_VALUE)
            if cfg.save_geotiffs:
                geotiff_dir.mkdir(parents=True, exist_ok=True)
                loc_tif = geotiff_dir / f"{tag}_LOC_warp_utm.tif"
                rec = products.export_loc_u16(
                    loc_cube, utm_grid, loc_tif,
                    lon_range=cfg.lon_range, lat_range=cfg.lat_range,
                    elev_range=cfg.elev_range)
                info["outputs"]["loc_utm_tif"] = str(loc_tif)
                info["stages"]["loc_utm_tif"] = rec

    # ===== OBS =====
    if need_obs:
        try:
            with EmitGranule(obs_file) as obs_g:
                obs_raw = obs_g.read_cube()
                obs_names = obs_g.band_names
            nb = obs_raw.shape[-1]
            # band names from the granule's observation_bands when
            # present (the real L1B_OBS metadata), canonical fallback
            names = (list(obs_names)[:nb] if obs_names
                     else OBS_BAND_NAMES[:nb])
            obs_cube, _ = _export_product(obs_raw, "obs", obs_utm, {
                "description": "EMIT OBS geometry bands",
                "band names": names,
            })
            info["outputs"]["obs_envi_bin"] = str(obs_utm)
            info["rasters"]["obs_envi"] = raster_meta(
                utm_grid, obs_cube.shape, "float32", NO_DATA_VALUE)
            if cfg.save_geotiffs:
                geotiff_dir.mkdir(parents=True, exist_ok=True)
                obs_tif = geotiff_dir / f"{tag}_OBS_warp_utm.tif"
                rec = products.export_obs_u16(
                    obs_cube, utm_grid, obs_tif, band_names=names,
                    sample_stride=cfg.obs_sample_stride,
                    percentiles=cfg.obs_percentiles)
                info["outputs"]["obs_utm_tif"] = str(obs_tif)
                info["stages"]["obs_utm_tif"] = rec
        except Exception as e:  # record-and-continue (emit_proj.py:1196-1201)
            info["obs_error"] = str(e)

    wavelengths = (np.asarray(g.wavelengths)
                   if g.wavelengths is not None else None)
    good_mask = g.good_wavelengths
    g.close()
    _save_info(info, save_info_path)
    return OrthoResult(data_utm, result_grid, info,
                       device_cube=device_holder.get("data"),
                       wavelengths=wavelengths, good_mask=good_mask)


def _save_info(info: Dict, save_info_path) -> None:
    if save_info_path is not None:
        p = Path(save_info_path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(info, indent=2, default=str))
        info["saved_info_path"] = str(p)


def convert_granules(
    img_files,
    out_dir,
    s2_grid,
    *,
    obs_files=None,
    mask_files=None,
    config: OrthoConfig = OrthoConfig(),
    export_loc: bool = False,
):
    """Batch ortho conversion — the ``convert_emit_nc_to_envi`` wrapper
    (emit_proj.py:1303-1356): run every granule, record-and-continue on
    failures, return [(path_or_None, info_dict), ...]."""
    results = []
    obs_files = obs_files or [None] * len(img_files)
    mask_files = mask_files or [None] * len(img_files)
    if len(obs_files) != len(img_files):
        raise ValueError(
            f"obs_files has {len(obs_files)} entries for "
            f"{len(img_files)} granules (pad with None for granules "
            "without an OBS file)")
    if len(mask_files) != len(img_files):
        raise ValueError(
            f"mask_files has {len(mask_files)} entries for "
            f"{len(img_files)} granules (pad with None)")
    for img, obs, msk in zip(img_files, obs_files, mask_files):
        try:
            res = orthorectify_granule(
                img, out_dir, s2_grid, obs_file=obs, mask_file=msk,
                export_loc=export_loc, config=config)
            results.append((res.data_envi_bin, res.info))
        except Exception as e:  # record-and-continue
            results.append((None, {"img_file": str(img), "error": str(e)}))
    return results
