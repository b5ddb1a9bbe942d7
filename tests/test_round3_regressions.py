"""Round-3 regression pins.

1. ``good_mask`` plumbing: flagged bad wavelengths must not move the
   fused product (reference masks them in the SRF integral,
   s2_emit/synth.py:34-35), and ``run_pair_pipeline`` must actually
   pass the granule's mask to ``fuse_pair``.
2. phases-engine 10 m validity: outside-swath sentinel garbage must not
   survive the stretch-clip as "valid" 0.0 pixels.
"""

from pathlib import Path

import numpy as np
import pytest

import hyperres.pipeline as hp
from hyperres.core.crs import CRS
from hyperres.core.grid import Grid
from hyperres.kernels.srf import build_srf_weight_matrix
from hyperres.pipeline import fuse_pair
from hyperres.spectral import builtin_srf
from hyperres.testing.scenes import (
    emit_wavelength_grid, endmember_spectra, make_scene, truth_reflectance,
)


@pytest.fixture(scope="module")
def mini_pair():
    """In-memory EMIT-cube / S2-RGB pair over a shared world, plus the
    index of an EMIT band inside B3's SRF support."""
    utm = CRS.utm(33, True)
    H = W = 40
    emit_grid = Grid(utm, 399960.0, 5800020.0, 60.0, 60.0, W, H)
    s2_grid = Grid(utm, 399960.0, 5800020.0, 10.0, 10.0, W * 6, H * 6)
    wl, good = emit_wavelength_grid(96)
    spectra = endmember_spectra(wl)
    xs, ys = emit_grid.pixel_center_coords()
    X, Y = np.meshgrid(xs, ys)
    cube = truth_reflectance(X, Y, spectra, noise=0.0)

    srf3 = builtin_srf("S2A", bands=["B2", "B3", "B4"])
    W3, _, _ = build_srf_weight_matrix(wl, srf3, good)
    band_spec = (spectra @ np.asarray(W3)).astype(np.float32)
    sxs, sys_ = s2_grid.pixel_center_coords()
    SX, SY = np.meshgrid(sxs, sys_)
    from hyperres.testing.scenes import abundance_maps
    a10 = abundance_maps(SX, SY).astype(np.float32)
    s2 = np.moveaxis(np.clip(a10 @ band_spec, 0, 1), -1, 0)

    # an EMIT band with real weight in the B3 (green) integral
    w_b3 = np.asarray(W3)[:, 1]
    idx = int(np.argmax(w_b3))
    assert w_b3[idx] > 0
    return dict(cube=cube, wl=wl, good=good, emit_grid=emit_grid,
                s2=s2, s2_grid=s2_grid, bad_idx=idx)


@pytest.mark.parametrize("engine", ["fused", "phases"])
def test_good_mask_blocks_flagged_bands(mini_pair, engine):
    p = mini_pair
    good = p["good"].copy()
    good[p["bad_idx"]] = False
    poisoned = p["cube"].copy()
    # spatially varying garbage (a constant would be removed by the
    # percentile stretch and hide a plumbing failure)
    rng = np.random.default_rng(3)
    poisoned[..., p["bad_idx"]] = 5.0 * rng.random(
        poisoned.shape[:2]).astype(np.float32)

    kw = dict(engine=engine)
    a = fuse_pair(poisoned, p["wl"], p["emit_grid"], p["s2"],
                  p["s2_grid"], good_mask=good, **kw)
    b = fuse_pair(p["cube"], p["wl"], p["emit_grid"], p["s2"],
                  p["s2_grid"], good_mask=good, **kw)
    # flagged band has zero SRF weight: the poison cannot move the output
    np.testing.assert_array_equal(np.nan_to_num(a.fused_10m),
                                  np.nan_to_num(b.fused_10m))
    # control: without the mask the poison DOES move the output
    c = fuse_pair(poisoned, p["wl"], p["emit_grid"], p["s2"],
                  p["s2_grid"], good_mask=None, **kw)
    assert not np.allclose(np.nan_to_num(c.fused_10m),
                           np.nan_to_num(b.fused_10m), atol=1e-3)


def test_run_pair_pipeline_passes_good_mask(tmp_path, monkeypatch):
    """The orchestration call threads the granule's good_wavelengths
    into fuse_pair (round-2 verdict: it was dropped at the call site)."""
    scene = make_scene(tmp_path / "scene", raw_shape=(48, 56), n_bands=48,
                       s2_size=240)
    seen = {}
    real = hp.fuse_pair

    def spy(*args, **kwargs):
        seen["good_mask"] = kwargs.get("good_mask")
        return real(*args, **kwargs)

    monkeypatch.setattr(hp, "fuse_pair", spy)
    hp.run_pair_pipeline(
        scene.emit_nc_path, scene.s2_tif_path, tmp_path / "run",
        train_sr=False, max_tiles=0)
    assert seen["good_mask"] is not None
    np.testing.assert_array_equal(np.asarray(seen["good_mask"], bool),
                                  scene.good_bands)


def test_phases_engine_masks_sentinel_garbage(mini_pair):
    """60 m cells that are nodata in the cube must be invalid at 10 m in
    the phases engine too (not clipped-to-0 'valid' pixels)."""
    p = mini_pair
    cube = p["cube"].copy()
    cube[:10, :, :] = -9999.0  # nodata swath edge
    out = fuse_pair(cube, p["wl"], p["emit_grid"], p["s2"], p["s2_grid"],
                    good_mask=p["good"], engine="phases")
    v10 = np.isfinite(out.fused_10m).all(-1)
    # rows over the nodata strip (minus the bilinear boundary row) are
    # invalid; rows well inside the valid region are valid
    assert not v10[:48].any()
    assert v10[80:].mean() > 0.99


# ---------------------------------------------------------------------------
# L2A quality / band mask integration (emit_tools.py:271-321)
# ---------------------------------------------------------------------------

def test_quality_mask_excluded_from_fusion_and_tiles(tmp_path):
    """Masked cloud pixels become nodata in the ortho product, shrink the
    OT fit's valid set, and count as black in the paired tiling."""
    from hyperres.core.config import TilingConfig
    from hyperres.io import envi
    from hyperres.testing.scenes import make_mask_granule

    scene = make_scene(tmp_path / "scene", raw_shape=(48, 56), n_bands=48,
                       s2_size=240)
    h, w = scene.emit_raw_shape
    cloud = np.zeros((h, w), dtype=np.uint8)
    cloud[:, : w // 2] = 1  # half the swath under cloud
    mask_nc = make_mask_granule(tmp_path / "mask.nc", (h, w), n_bands=48,
                                cloud_mask=cloud)

    tc = TilingConfig(emit_tile_size=8, max_black_frac=0.05)
    res_clean = hp.run_pair_pipeline(
        scene.emit_nc_path, scene.s2_tif_path, tmp_path / "clean",
        tiling_config=tc, train_sr=False)
    res_masked = hp.run_pair_pipeline(
        scene.emit_nc_path, scene.s2_tif_path, tmp_path / "masked",
        mask_file=mask_nc, tiling_config=tc, train_sr=False)

    minfo = res_masked.ortho_info["mask"]
    assert minfo["quality_masked_px"] == int(cloud.sum())
    assert res_masked.ortho_info["mask_file"] == str(mask_nc)
    # masked pixels are nodata in the UTM ENVI product
    cube = envi.EnviReader(
        Path(res_masked.ortho_info["outputs"]["data_envi_bin"])
        .with_suffix(".hdr")).read()
    cube_clean = envi.EnviReader(
        Path(res_clean.ortho_info["outputs"]["data_envi_bin"])
        .with_suffix(".hdr")).read()
    n_nodata_masked = int((cube == -9999.0).all(-1).sum())
    n_nodata_clean = int((cube_clean == -9999.0).all(-1).sum())
    assert n_nodata_masked > n_nodata_clean * 1.2
    # the fusion fit sees fewer valid pixels, tiling loses tiles
    assert (res_masked.fusion.info["n_valid_60m"]
            < 0.8 * res_clean.fusion.info["n_valid_60m"])
    assert len(res_masked.tiles) < len(res_clean.tiles)


def test_band_mask_per_band_nodata(tmp_path):
    """apply_band_mask masks specific (pixel, band) entries only."""
    from hyperres.core.config import OrthoConfig
    from hyperres.io import envi
    from hyperres.testing.scenes import make_mask_granule

    scene = make_scene(tmp_path / "scene", raw_shape=(32, 36), n_bands=48,
                       s2_size=180)
    h, w = scene.emit_raw_shape
    bm = np.zeros((h, w, 48), dtype=np.uint8)
    bm[:, :, 7] = 1  # band 7 bad everywhere
    mask_nc = make_mask_granule(tmp_path / "mask.nc", (h, w), n_bands=48,
                                band_mask=bm)
    res = hp.orthorectify_granule(
        scene.emit_nc_path, tmp_path / "out", scene.s2_tif_path,
        mask_file=mask_nc,
        config=OrthoConfig(save_geotiffs=False, write_xml=False,
                           apply_band_mask=True))
    cube = envi.EnviReader(res.data_envi_bin.with_suffix(".hdr")).read()
    valid_spatial = cube[..., 0] != -9999.0
    assert valid_spatial.sum() > 0
    # band 7 nodata wherever the cube has data; neighbours untouched
    assert (cube[valid_spatial][:, 7] == -9999.0).all()
    assert (cube[valid_spatial][:, 6] != -9999.0).all()
    assert res.info["mask"]["band_masked_px"] == int(bm.sum())


# ---------------------------------------------------------------------------
# Granule-scale SR product path (device-batched u16 prediction)
# ---------------------------------------------------------------------------

def test_predict_cube_u16_matches_host_path(rng):
    """The single-program device prediction (predict_cube_u16) matches
    the reference-shaped host-batched predict_cube + quantize."""
    import jax.numpy as jnp
    from hyperres.core.config import RidgeSRConfig
    from hyperres.fusion import RidgeSpectralSR
    from hyperres.kernels.stats import quantize_reflectance_u16

    bx, by = 6, 12
    X = rng.random((4000, bx)).astype(np.float32)
    Y = np.clip(0.2 + 0.5 * X[:, :1] + 0.05 * rng.random((4000, by)),
                0.01, 0.99).astype(np.float32)
    model = RidgeSpectralSR(bx, by, RidgeSRConfig(degree=2,
                                                  batch_pixels=512))
    model.fit(X, Y)

    h, w = 37, 41  # h*w not a multiple of batch: exercises padding
    cube = rng.random((bx, h, w)).astype(np.float32)
    cube[:, 3, 5] = np.nan          # invalid pixel
    cube[:, 10, 2] = -9999.0        # nodata pixel

    q_dev = model.predict_cube_u16(cube, nodata=-9999.0)
    pred = model.predict_cube(cube, nodata=-9999.0)
    valid = np.isfinite(pred)
    q_ref = np.asarray(quantize_reflectance_u16(
        jnp.asarray(np.nan_to_num(pred, nan=0.0)), jnp.asarray(valid)))

    assert q_dev.shape == (by, h, w)
    assert q_dev.dtype == np.uint16
    np.testing.assert_array_equal(q_dev == 65535, q_ref == 65535)
    assert q_dev[:, 3, 5].max() == 65535 and q_dev[:, 10, 2].max() == 65535
    d = np.abs(q_dev.astype(np.int32) - q_ref.astype(np.int32))
    assert d.max() <= 1  # f32 sigmoid rounding at the quantization edge


def test_fused_plan_pallas_banded_matches_xla(tmp_path):
    """FusedOrthoFusionPlan(warp_kernel='banded') reproduces the dense
    two-pass plan."""
    from hyperres.core.grid import s2_anchored_target_grid
    from hyperres.fusion.fused import FusedOrthoFusionPlan
    from hyperres.io.granule import EmitGranule

    scene = make_scene(tmp_path / "scene", raw_shape=(40, 44), n_bands=48,
                       s2_size=180)
    with EmitGranule(scene.emit_nc_path) as g:
        raw = g.read_cube()
        args = (g.ortho_grid,
                s2_anchored_target_grid(g.ortho_grid, scene.s2_grid,
                                        60.0, 60.0),
                scene.s2_grid, (g.raw_height, g.raw_width), g.glt,
                g.wavelengths, g.good_wavelengths)
    from hyperres.io.tiff import TiffReader
    with TiffReader(scene.s2_tif_path) as t:
        stack = t.read().astype(np.float32)
        nodata = t.nodata
    kw = dict(s2_nodata=nodata, s2_scale=1e-4)
    plan_x = FusedOrthoFusionPlan(*args, warp_kernel="two_pass", **kw)
    plan_b = FusedOrthoFusionPlan(*args, warp_kernel="banded", **kw)
    assert plan_x.warp_statics.backend == "dense"
    assert plan_b.warp_statics.backend == "banded"
    a = plan_x(raw, plan_x.prepare_s2(stack))
    b = plan_b(raw, plan_b.prepare_s2(stack))
    va = np.isfinite(np.asarray(a["fused_10m"])).all(-1)
    vb = np.isfinite(np.asarray(b["fused_10m"])).all(-1)
    np.testing.assert_array_equal(va, vb)
    d = np.abs(np.asarray(a["fused_10m"])[va]
               - np.asarray(b["fused_10m"])[vb])
    assert d.max() < 1e-4
    np.testing.assert_allclose(np.asarray(a["coeffs"]),
                               np.asarray(b["coeffs"]), atol=1e-4)
