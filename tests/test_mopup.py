"""Mop-up coverage: helpers not exercised elsewhere."""

import numpy as np
import jax.numpy as jnp
import pytest

from hyperres.core.crs import CRS
from hyperres.core.grid import Grid
from hyperres.kernels import stats as kstats
from hyperres.kernels import lstsq as kls
from hyperres.kernels import warp as kwarp


def test_robust_norm_matches_reference(rng):
    x = rng.normal(size=(40, 50)).astype(np.float32)
    x[3, 4] = np.nan
    got = np.asarray(kstats.robust_norm(jnp.asarray(x)))
    lo, hi = np.nanpercentile(x, [2, 98])
    want = np.clip((x - lo) / (hi - lo + 1e-12), 0, 1)
    np.testing.assert_allclose(got[np.isfinite(want)],
                               want[np.isfinite(want)], atol=1e-5)


def test_robust_norm_rgb_nan_outside_mask(rng):
    img = rng.random((20, 22, 3)).astype(np.float32)
    mask = rng.random((20, 22)) > 0.4
    out = np.asarray(kstats.robust_norm_rgb(jnp.asarray(img),
                                            jnp.asarray(mask)))
    assert np.isnan(out[~mask]).all()
    assert np.isfinite(out[mask]).all()
    assert out[mask].min() >= 0 and out[mask].max() <= 1


def test_polyfit_channels_vmapped(rng):
    x = rng.random((300, 3)).astype(np.float32)
    coeffs_true = np.array([[0.5, 0.2], [1.5, -0.3], [-0.7, 0.9]],
                           dtype=np.float32)
    y = np.stack([np.polyval(coeffs_true[c], x[:, c]) for c in range(3)],
                 axis=1)
    got = np.asarray(kls.polyfit_channels(jnp.asarray(x), jnp.asarray(y), 1))
    np.testing.assert_allclose(got, coeffs_true, atol=1e-4)


def test_resample_nearest_path(rng):
    utm = CRS.utm(33, True)
    src = Grid(utm, 0.0, 0.0, 60.0, 60.0, 10, 10)
    dst = Grid(utm, 0.0, 0.0, 30.0, 30.0, 20, 20)
    data = rng.random((10, 10)).astype(np.float32)
    out = kwarp.resample_to_grid(data, src, dst, method="nearest")
    # every 2x2 block replicates one source pixel
    np.testing.assert_array_equal(out[::2, ::2], data)
    np.testing.assert_array_equal(out[1::2, 1::2], data)


def test_resample_band_chunk_option(rng):
    utm = CRS.utm(33, True)
    src = Grid(utm, 0.0, 0.0, 60.0, 60.0, 12, 12)
    dst = Grid(CRS.utm(32, True), 500000.0, 10.0, 60.0, 60.0, 4, 4)
    # different CRS forces the full-field path; band_chunk exercises the
    # chunked concat
    data = rng.random((12, 12, 7)).astype(np.float32)
    a = kwarp.resample_to_grid(data, src, dst, method="bilinear",
                               band_chunk=None)
    b = kwarp.resample_to_grid(data, src, dst, method="bilinear",
                               band_chunk=3)
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_envi_bsq_band_read(tmp_path, rng):
    from hyperres.io import envi
    cube = rng.random((9, 11, 4)).astype(np.float32)
    envi.write_cube(tmp_path / "b.bin", cube, interleave="bsq")
    r = envi.EnviReader(tmp_path / "b.hdr")
    np.testing.assert_array_equal(r.read_band(2), cube[:, :, 2])


def test_grid_south_hemisphere_roundtrip():
    g = Grid(CRS.utm(56, False), 300000.0, 6260000.0, 10.0, 10.0, 50, 50)
    lon, lat = g.crs.to_geographic(g.x0, g.y0)
    assert lat < 0  # southern hemisphere
    x, y = g.crs.from_geographic(lon, lat)
    assert abs(float(x) - g.x0) < 1e-6
    assert abs(float(y) - g.y0) < 1e-6


def test_histogram_percentile_masked(rng):
    x = rng.normal(size=(50_000,)).astype(np.float32)
    mask = x > 0  # heavy masking
    got = np.asarray(kstats.histogram_percentile(
        jnp.asarray(x), jnp.asarray(mask), jnp.asarray([50.0])))
    want = np.percentile(x[mask], 50)
    assert abs(float(got[0]) - want) < (x.max() - x.min()) / 2048 * 2


def test_sample_valid_pixels_device_weights(rng):
    from hyperres.fusion.sampling import sample_valid_pixels_device
    import jax
    img = rng.random((10, 10, 3)).astype(np.float32)
    mask = np.zeros((10, 10), dtype=bool)
    mask[:3, :3] = True  # only 9 valid
    take, w = sample_valid_pixels_device(
        jnp.asarray(img), jnp.asarray(mask), 16, jax.random.PRNGKey(0))
    assert take.shape == (16, 3)
    assert float(w.sum()) == 9.0
    # the 9 weighted rows are genuine valid pixels
    valid_vals = img[mask]
    for row in np.asarray(take)[np.asarray(w) > 0]:
        assert (np.abs(valid_vals - row).sum(1) < 1e-6).any()


def test_sample_valid_pixels_device_is_exact_top_k(rng):
    """The device sampler is exact Gumbel top-k: its picks are the
    lax.top_k of the masked Gumbel scores drawn from the same key."""
    from hyperres.fusion.sampling import sample_valid_pixels_device
    import jax
    img = rng.random((30, 30, 3)).astype(np.float32)
    mask = rng.random((30, 30)) > 0.4
    key = jax.random.PRNGKey(3)
    take, w = sample_valid_pixels_device(jnp.asarray(img),
                                         jnp.asarray(mask), 40, key)
    g = jax.random.gumbel(key, (900,))
    score = jnp.where(jnp.asarray(mask.reshape(-1)), g, -jnp.inf)
    _, idx = jax.lax.top_k(score, 40)
    np.testing.assert_array_equal(np.asarray(take),
                                  img.reshape(-1, 3)[np.asarray(idx)])
    assert float(w.sum()) == 40.0
    with pytest.raises(TypeError):
        sample_valid_pixels_device(jnp.asarray(img), jnp.asarray(mask),
                                   40, key, method="approx")


def test_make_grid_template(tmp_path, rng):
    from hyperres.io.tiff import TiffReader, write_geotiff
    from hyperres.spectral import make_grid_template_from_raster
    g = Grid(CRS.utm(33, True), 0.0, 0.0, 60.0, 60.0, 8, 6)
    write_geotiff(tmp_path / "src.tif",
                  rng.random((2, 6, 8)).astype(np.float32), g)
    out = make_grid_template_from_raster(tmp_path / "src.tif",
                                         tmp_path / "tpl.tif")
    with TiffReader(out) as r:
        assert r.count == 1
        assert r.grid == g
        assert np.all(r.read() == 0)


def test_downsample_s2_to_grid_api(tmp_path, rng):
    from hyperres.io.tiff import write_geotiff
    from hyperres.spectral import downsample_s2_to_grid
    utm = CRS.utm(33, True)
    s2g = Grid(utm, 0.0, 0.0, 10.0, 10.0, 60, 60)
    eg = Grid(utm, 0.0, 0.0, 60.0, 60.0, 10, 10)
    data = (rng.random((4, 60, 60)) * 250).astype(np.uint8)
    write_geotiff(tmp_path / "s2.tif", data, s2g)
    write_geotiff(tmp_path / "emit.tif",
                  np.zeros((1, 10, 10), np.float32), eg)
    out = downsample_s2_to_grid(tmp_path / "s2.tif", tmp_path / "emit.tif",
                                band_indexes=[1, 3],
                                src_scale=1.0 / 255.0,
                                resampling="average")
    assert out.shape == (2, 10, 10)
    want = data[0].reshape(10, 6, 10, 6).mean(axis=(1, 3)) / 255.0
    np.testing.assert_allclose(out[0], want, atol=1e-5)


def test_stage_timer_and_profile_trace(tmp_path):
    import time as _t
    from hyperres.utils import StageTimer, profile_trace
    ledger = {}
    t = StageTimer(ledger)
    with t.stage("work", shape=[3, 4]):
        _t.sleep(0.01)
    assert ledger["work"]["seconds"] >= 0.009
    assert ledger["work"]["shape"] == [3, 4]
    with profile_trace(None):  # no-op path
        pass
