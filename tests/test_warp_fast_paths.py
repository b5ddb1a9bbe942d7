import numpy as np
import jax.numpy as jnp
import pytest

from hyperres.kernels import warp as kw


def index_axes(hs, ws, hd, wd, scale, off=0.0):
    rows = (np.arange(hd) + 0.5) / scale - 0.5 + off
    cols = (np.arange(wd) + 0.5) / scale - 0.5 + off
    return rows.astype(np.float32), cols.astype(np.float32)


@pytest.mark.parametrize("method", ["bilinear", "cubic"])
def test_taploop_matches_unrolled(rng, method):
    img = rng.normal(size=(40, 44, 7)).astype(np.float32)
    img[3:6, 8:11, :] = -9999.0
    rows = rng.uniform(-2, 41, size=(25, 30)).astype(np.float32)
    cols = rng.uniform(-2, 45, size=(25, 30)).astype(np.float32)
    a = np.asarray(kw.warp_interpolate(jnp.asarray(img), jnp.asarray(rows),
                                       jnp.asarray(cols), nodata=-9999.0,
                                       method=method))
    b = np.asarray(kw.warp_interpolate_taploop(
        jnp.asarray(img), jnp.asarray(rows), jnp.asarray(cols),
        nodata=-9999.0, method=method))
    np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)


@pytest.mark.parametrize("method", ["bilinear", "cubic"])
def test_separable_matmul_matches_gather(rng, method):
    hs, ws, b = 30, 34, 5
    img = rng.normal(size=(hs, ws, b)).astype(np.float32)
    img[10:12, 5:9, :] = -9999.0
    hd, wd = 85, 97
    rows1, cols1 = index_axes(hs, ws, hd, wd, scale=2.85)
    rows2d, cols2d = np.meshgrid(rows1, cols1, indexing="ij")
    want = np.asarray(kw.warp_interpolate(
        jnp.asarray(img), jnp.asarray(rows2d), jnp.asarray(cols2d),
        nodata=-9999.0, method=method))
    Wr = kw.separable_weight_matrix(rows1, hs, method)
    Wc = kw.separable_weight_matrix(cols1, ws, method)
    got = np.asarray(kw.separable_resample_matmul(
        jnp.asarray(img), jnp.asarray(Wr), jnp.asarray(Wc),
        nodata=-9999.0, fast=False))
    # pixels whose valid-weight mass nearly cancels (signed cubic taps
    # next to the nodata block) are fp-ill-conditioned under
    # renormalisation; compare them loosely and the rest tightly
    rows2d_, cols2d_ = np.meshgrid(rows1, cols1, indexing="ij")
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)
    stable = np.abs(want) < 1e4  # all finite pixels
    diffs = np.abs(got - want)[stable]
    assert np.percentile(diffs, 99) < 5e-5


def test_separable_matmul_no_nodata(rng):
    img = rng.random((20, 22, 3)).astype(np.float32)
    rows1, cols1 = index_axes(20, 22, 60, 66, scale=3.0)
    rows2d, cols2d = np.meshgrid(rows1, cols1, indexing="ij")
    want = np.asarray(kw.warp_interpolate(
        jnp.asarray(img), jnp.asarray(rows2d), jnp.asarray(cols2d),
        method="bilinear", fill=-9999.0))
    Wr = kw.separable_weight_matrix(rows1, 20, "bilinear")
    Wc = kw.separable_weight_matrix(cols1, 22, "bilinear")
    got = np.asarray(kw.separable_resample_matmul(
        jnp.asarray(img), jnp.asarray(Wr), jnp.asarray(Wc),
        fill=-9999.0, fast=False))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_separable_matmul_outside_fill(rng):
    img = rng.random((10, 10, 1)).astype(np.float32)
    rows1 = np.array([-3.0, 4.0], dtype=np.float32)   # first fully outside
    cols1 = np.array([4.0, 30.0], dtype=np.float32)   # second fully outside
    Wr = kw.separable_weight_matrix(rows1, 10, "cubic")
    Wc = kw.separable_weight_matrix(cols1, 10, "cubic")
    got = np.asarray(kw.separable_resample_matmul(
        jnp.asarray(img), jnp.asarray(Wr), jnp.asarray(Wc),
        fill=-9999.0, fast=False))
    assert got[0, 0, 0] == -9999.0
    assert got[0, 1, 0] == -9999.0
    assert got[1, 1, 0] == -9999.0
    assert got[1, 0, 0] != -9999.0


def test_fused_orthowarp_matches_two_step(rng):
    """orthowarp_taploop == glt_gather + warp_interpolate (cubic) with
    reference nodata semantics."""
    from hyperres.kernels.glt import glt_gather, prepare_glt

    raw = rng.random((30, 35, 9)).astype(np.float32)
    ho, wo = 40, 44
    glt = np.zeros((ho, wo, 2), dtype=np.int32)
    valid = rng.random((ho, wo)) > 0.25
    glt[..., 0] = np.where(valid, rng.integers(1, 36, (ho, wo)), 0)
    glt[..., 1] = np.where(valid, rng.integers(1, 31, (ho, wo)), 0)
    flat_idx, vmask = prepare_glt(glt, (30, 35))

    rows = rng.uniform(-2, ho + 1, size=(50, 52)).astype(np.float32)
    cols = rng.uniform(-2, wo + 1, size=(50, 52)).astype(np.float32)

    ortho = glt_gather(jnp.asarray(raw), jnp.asarray(flat_idx),
                       jnp.asarray(vmask))
    want = np.asarray(kw.warp_interpolate(
        ortho, jnp.asarray(rows), jnp.asarray(cols), nodata=-9999.0,
        method="cubic"))
    got = np.asarray(kw.orthowarp_taploop(
        jnp.asarray(raw), jnp.asarray(flat_idx), jnp.asarray(vmask),
        jnp.asarray(rows), jnp.asarray(cols), method="cubic"))
    # identical up to renormalisation conditioning at masked borders
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-3)
    diffs = np.abs(got - want)
    assert np.percentile(diffs, 99) < 1e-4


def test_band_chunked_matches_plain(rng):
    img = rng.normal(size=(30, 34, 11)).astype(np.float32)
    img[5:7, 8:10, :] = -9999.0
    rows = rng.uniform(0, 29, size=(20, 21)).astype(np.float32)
    cols = rng.uniform(0, 33, size=(20, 21)).astype(np.float32)
    a = np.asarray(kw.warp_interpolate(
        jnp.asarray(img), jnp.asarray(rows), jnp.asarray(cols),
        nodata=-9999.0, method="cubic"))
    b = np.asarray(kw.warp_interpolate_chunked(
        jnp.asarray(img), jnp.asarray(rows), jnp.asarray(cols),
        nodata=-9999.0, method="cubic", band_chunk=4))
    np.testing.assert_allclose(a, b, rtol=0, atol=5e-3)
    assert np.percentile(np.abs(a - b), 99) < 1e-4


def test_two_pass_matches_taploop_separable(rng):
    """With axis-separable index fields there is no scanline shear, so
    orthowarp_two_pass must match orthowarp_taploop to fp tolerance."""
    from hyperres.kernels.glt import prepare_glt

    raw = rng.random((30, 35, 9)).astype(np.float32)
    ho, wo = 40, 44
    glt = np.zeros((ho, wo, 2), dtype=np.int32)
    valid = rng.random((ho, wo)) > 0.25
    glt[..., 0] = np.where(valid, rng.integers(1, 36, (ho, wo)), 0)
    glt[..., 1] = np.where(valid, rng.integers(1, 31, (ho, wo)), 0)
    flat_idx, vmask = prepare_glt(glt, (30, 35))
    r1 = np.sort(rng.uniform(-1, ho, size=50)).astype(np.float32)
    c1 = np.sort(rng.uniform(-1, wo, size=52)).astype(np.float32)
    rows = np.broadcast_to(r1[:, None], (50, 52)).copy()
    cols = np.broadcast_to(c1[None, :], (50, 52)).copy()
    cstar = np.broadcast_to(c1[None, :], (ho, 52)).copy()
    want = np.asarray(kw.orthowarp_taploop(
        jnp.asarray(raw), jnp.asarray(flat_idx), jnp.asarray(vmask),
        jnp.asarray(rows), jnp.asarray(cols), method="cubic",
        row_chunks=2))
    got = np.asarray(kw.orthowarp_two_pass(
        jnp.asarray(raw), jnp.asarray(flat_idx), jnp.asarray(vmask),
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(cstar),
        method="cubic", block_rows_src=16, block_rows_dst=16))
    d = np.abs(got - want)
    assert d.max() < 5e-3
    assert np.percentile(d, 99) < 1e-5


@pytest.mark.parametrize("method", ["bilinear", "cubic"])
def test_two_pass_projective_parity(rng, method):
    """Bench-like projective geometry (rotated swath, geographic ortho
    grid -> UTM): the two-pass warp agrees with the exact fused kernel to
    sub-1e-3 reflectance and produces the identical fill mask."""
    from hyperres.core.crs import CRS
    from hyperres.core.grid import Grid
    from hyperres.kernels.glt import prepare_glt

    utm = CRS.utm(33, True)
    raw_h, raw_w, B = 90, 100, 6
    cx, cy, th = 500000.0, 5800000.0, np.deg2rad(15.0)
    rr, cc = np.meshgrid(np.arange(raw_h), np.arange(raw_w), indexing="ij")
    du = (cc - raw_w / 2.0) * 60.0
    dv = -(rr - raw_h / 2.0) * 60.0
    X = cx + du * np.cos(th) - dv * np.sin(th)
    Y = cy + du * np.sin(th) + dv * np.cos(th)
    # smooth multi-band world (reflectance-like): kernel-shape differences
    # between the sheared and axis-aligned footprints cancel on smooth
    # fields, which is the regime the products live in
    phase = np.linspace(0, np.pi, B)
    raw = (0.45 + 0.35 * np.sin(X[..., None] / 900.0 + phase)
           * np.cos(Y[..., None] / 1100.0)).astype(np.float32)
    lon, lat = utm.to_geographic(X, Y)
    res = 0.0006
    og = Grid(CRS.geographic(), lon.min() - 2 * res, lat.max() + 2 * res,
              res, res, int((lon.max() - lon.min()) / res) + 4,
              int((lat.max() - lat.min()) / res) + 4)
    oxs, oys = og.pixel_center_coords()
    olon, olat = np.meshgrid(oxs, oys)
    oux, ouy = utm.from_geographic(olon, olat)
    du2 = (oux - cx) * np.cos(th) + (ouy - cy) * np.sin(th)
    dv2 = -(oux - cx) * np.sin(th) + (ouy - cy) * np.cos(th)
    ci = np.round(du2 / 60.0 + raw_w / 2.0).astype(np.int64)
    ri = np.round(-dv2 / 60.0 + raw_h / 2.0).astype(np.int64)
    inside = (ri >= 0) & (ri < raw_h) & (ci >= 0) & (ci < raw_w)
    glt = np.zeros(olon.shape + (2,), np.int32)
    glt[..., 0] = np.where(inside, ci + 1, 0)
    glt[..., 1] = np.where(inside, ri + 1, 0)
    flat_idx, vmask = prepare_glt(glt, (raw_h, raw_w))
    ug = Grid(utm, np.floor(oux.min() / 60) * 60,
              np.ceil(ouy.max() / 60) * 60, 60.0, 60.0,
              int((oux.max() - oux.min()) / 60) - 1,
              int((ouy.max() - ouy.min()) / 60) - 1)
    wr, wc = kw.source_index_field(og, ug)
    cstar = kw.scanline_cstar(wr, wc, og.height)

    args = [jnp.asarray(a) for a in (raw, flat_idx, vmask, wr, wc)]
    want = np.asarray(kw.orthowarp_taploop(*args, method=method,
                                           row_chunks=4))
    got = np.asarray(kw.orthowarp_two_pass(
        *args, jnp.asarray(cstar), method=method,
        block_rows_src=32, block_rows_dst=32))
    # fill masks agree except where the sheared footprint straddles a
    # nodata boundary differently than the axis-aligned one (see kernel
    # docstring) — a handful of pixels at GLT holes/swath edges
    mask_mismatch = (want == -9999.0) != (got == -9999.0)
    assert mask_mismatch.mean() < 1e-3, mask_mismatch.mean()
    # compare on the interior (2 px from any fill), where both kernels
    # see fully valid footprints
    vm = ((want != -9999.0) & (got != -9999.0)).all(axis=-1)
    interior = vm.copy()
    for sh in (1, -1, 2, -2):
        interior &= np.roll(vm, sh, axis=0) & np.roll(vm, sh, axis=1)
    d = np.abs(got - want)[interior]
    assert d.max() < 2e-3, d.max()
    assert np.percentile(d, 99) < 1e-4


def test_generic_two_pass_per_band_nodata(rng):
    """warp_two_pass (kernel='two_pass' routing in resample_to_grid)
    matches the gather kernel including per-band nodata renormalisation
    on a cross-CRS transfer."""
    from hyperres.core.crs import CRS
    from hyperres.core.grid import Grid

    src = Grid(CRS.geographic(), 13.0, 52.0, 0.0008, 0.0008, 90, 70)
    dst = Grid(CRS.utm(33, True), 362000.0, 5764000.0, 60.0, 60.0, 64, 56)
    # smooth bands + scattered per-band nodata holes
    y, x = np.mgrid[0:70, 0:90].astype(np.float32)
    data = np.stack([0.4 + 0.3 * np.sin(x / 9 + k) * np.cos(y / 11)
                     for k in range(3)], axis=-1).astype(np.float32)
    holes = rng.random((70, 90, 3)) < 0.02
    data[holes] = -9999.0

    got = kw.resample_to_grid(data, src, dst, method="cubic",
                              nodata=-9999.0, kernel="two_pass")
    want = kw.resample_to_grid(data, src, dst, method="cubic",
                               nodata=-9999.0, kernel="gather")
    mask_mismatch = (want == -9999.0) != (got == -9999.0)
    assert mask_mismatch.mean() < 2e-3
    vm = (want != -9999.0) & (got != -9999.0)
    d = np.abs(np.where(vm, got - want, 0.0))
    # the documented scanline-shear deviation bound is sub-1e-3; this
    # geometry has real shear (89 m geographic px onto 60 m UTM)
    assert np.percentile(d[vm], 99) < 1e-3, np.percentile(d[vm], 99)
    allv = vm.all(-1)
    interior = allv.copy()
    for sh in (1, -1, 2, -2):
        interior &= np.roll(allv, sh, axis=0) & np.roll(allv, sh, axis=1)
    assert np.abs(got - want)[interior].max() < 5e-3


def test_generic_two_pass_no_nodata_matches_gather(rng):
    from hyperres.core.crs import CRS
    from hyperres.core.grid import Grid

    src = Grid(CRS.geographic(), 13.0, 52.0, 0.0008, 0.0008, 80, 60)
    dst = Grid(CRS.utm(33, True), 362000.0, 5763000.0, 60.0, 60.0, 50, 44)
    y, x = np.mgrid[0:60, 0:80].astype(np.float32)
    data = (0.4 + 0.3 * np.sin(x / 7) * np.cos(y / 9)).astype(np.float32)
    got = kw.resample_to_grid(data, src, dst, method="bilinear",
                              kernel="two_pass", fill=np.nan)
    want = kw.resample_to_grid(data, src, dst, method="bilinear",
                               kernel="gather", fill=np.nan)
    both = np.isfinite(got) & np.isfinite(want)
    assert both.mean() > 0.5
    # sub-1e-3 scanline-shear deviation (documented) on sheared geometry
    np.testing.assert_allclose(got[both], want[both], atol=2e-3)
    assert np.percentile(np.abs(got - want)[both], 90) < 1e-4


# ---------------------------------------------------------------------------
# Integer-aligned separable fast paths (round 3): pad/reshape block-sum
# average and phase-cycled lerp bilinear vs the weight-matrix matmuls
# ---------------------------------------------------------------------------

def _aligned_grids():
    from hyperres.core.crs import CRS
    from hyperres.core.grid import Grid

    utm = CRS.utm(33, True)
    emit = Grid(utm, 500000.0, 5800000.0, 60.0, 60.0, 37, 41)
    # 10 m grid on the 60 m lattice, overhanging the 60 m grid
    s2 = Grid(utm, 500000.0 - 120.0, 5800000.0 + 60.0, 10.0, 10.0,
              229, 233)
    return emit, s2


def _axes64(src, dst):
    xs, ys = dst.pixel_center_coords()
    cols, _ = src.colrow_of(xs, src.y0)
    _, rows = src.colrow_of(src.x0, ys)
    return np.asarray(rows, np.float64), np.asarray(cols, np.float64)


@pytest.mark.parametrize("direction", ["down_average", "up_bilinear"])
@pytest.mark.parametrize("masking", ["none", "nodata", "vm", "both"])
def test_separable_fast_matches_matmul(rng, direction, masking):
    from hyperres.core.grid import Grid  # noqa: F401 (fixture import)

    emit, s2 = _aligned_grids()
    if direction == "down_average":
        src, dst, method, scale = s2, emit, "average", 6.0
    else:
        src, dst, method, scale = emit, s2, "bilinear", None

    r64, c64 = _axes64(src, dst)
    sr = kw.separable_fast_spec(r64, src.height, method, scale=scale)
    sc = kw.separable_fast_spec(c64, src.width, method, scale=scale)
    assert sr is not None and sc is not None
    assert sr[0] == ("avg" if method == "average" else "bilin")
    assert sr[1] == 6

    idx = kw.separable_index_axes(src, dst)
    Wr = kw.separable_weight_matrix(idx[0], src.height, method,
                                    scale=scale)
    Wc = kw.separable_weight_matrix(idx[1], src.width, method,
                                    scale=scale)

    img = rng.random((src.height, src.width, 3)).astype(np.float32)
    nodata = None
    vm = None
    if masking in ("nodata", "both"):
        nodata = -9999.0
        img[5, 3:9, :] = -9999.0
        img[8:10, :, 1] = np.nan  # non-finite counts as nodata too
    if masking in ("vm", "both"):
        vm = rng.random((src.height, src.width)) > 0.25

    ref = np.asarray(kw.separable_resample_matmul(
        jnp.asarray(img), jnp.asarray(Wr), jnp.asarray(Wc),
        nodata=nodata, fill=np.nan, fast=False,
        valid_mask=None if vm is None else jnp.asarray(vm)))
    got = np.asarray(kw.separable_resample_fast(
        jnp.asarray(img), sr, sc, nodata=nodata, fill=np.nan,
        valid_mask=None if vm is None else jnp.asarray(vm)))
    assert got.shape == (dst.height, dst.width, 3)
    assert (np.isfinite(ref) == np.isfinite(got)).all()
    both = np.isfinite(ref)
    np.testing.assert_allclose(got[both], ref[both], rtol=0, atol=2e-5)
    # edge cells outside the source extent must be fill in both
    assert np.isnan(got[0 if direction == "down_average" else -1]).any() \
        or both.all()


def test_separable_fast_spec_rejects_unaligned():
    # non-integer ratio
    idx = (np.arange(40) + 0.5) / 5.5 - 0.5
    assert kw.separable_fast_spec(idx, 300, "bilinear") is None
    # integer ratio but misaligned block start for average
    idx = np.arange(30) * 6.0 + 2.5 + 0.3
    assert kw.separable_fast_spec(idx, 200, "average", scale=6.0) is None
    # non-uniform steps
    idx = np.cumsum(np.full(30, 6.0) + np.linspace(0, 0.1, 30))
    assert kw.separable_fast_spec(idx, 400, "average", scale=6.0) is None


def test_fused_plan_uses_fast_specs():
    """FusedFusionPlan on S2-anchored grids activates both fast specs
    and keeps the dense weight matrices as 1x1 dummies; an unaligned
    S2 grid falls back to the matmuls."""
    from hyperres.core.grid import Grid
    from hyperres.fusion.fused import FusedFusionPlan
    from hyperres.testing import scenes

    emit, s2 = _aligned_grids()
    wl, good = scenes.emit_wavelength_grid(285)
    plan = FusedFusionPlan(emit, s2, wl, good, s2_nodata=65535.0,
                           s2_scale=1e-4)
    assert plan.statics.down_fast is not None
    assert plan.statics.up_fast is not None
    assert plan._Wr60.shape == (1, 1) and plan._Wr10.shape == (1, 1)

    off = Grid(s2.crs, s2.x0 + 5.0, s2.y0, 10.0, 10.0, s2.width,
               s2.height)  # origin off the 60 m lattice
    plan2 = FusedFusionPlan(emit, off, wl, good)
    assert plan2.statics.down_fast is None
    assert plan2._Wr60.shape != (1, 1)


def test_separable_resample_fast_cmajor_matches(rng):
    """The channel-major (C, H, W) fast-resample twin reproduces the
    (H, W, C) path (same masks, f32 roundoff values) for bilinear
    upsample and average downsample, with and without a valid mask."""
    import jax.numpy as jnp
    import hyperres.kernels.warp as kw

    h60, w60, f = 41, 47, 6
    h10, w10 = h60 * f, w60 * f
    idx_r = (np.arange(h10) + 0.5) / f - 0.5
    idx_c = (np.arange(w10) + 0.5) / f - 0.5
    sr = kw.separable_fast_spec(idx_r, h60, "bilinear")
    sc = kw.separable_fast_spec(idx_c, w60, "bilinear")
    img = rng.random((h60, w60, 3)).astype(np.float32)
    v = rng.random((h60, w60)) > 0.25
    a = np.asarray(kw.separable_resample_fast(
        jnp.asarray(img), sr, sc, fill=np.nan, valid_mask=jnp.asarray(v)))
    b = np.moveaxis(np.asarray(kw.separable_resample_fast_cmajor(
        jnp.asarray(np.moveaxis(img, -1, 0)), sr, sc, fill=np.nan,
        valid_mask=jnp.asarray(v))), 0, -1)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                               rtol=0, atol=5e-7)

    # average downsample (10 m -> 60 m), no mask
    idx_rd = (np.arange(h60) + 0.5) * f - 0.5
    idx_cd = (np.arange(w60) + 0.5) * f - 0.5
    srd = kw.separable_fast_spec(idx_rd, h10, "average", scale=f)
    scd = kw.separable_fast_spec(idx_cd, w10, "average", scale=f)
    big = rng.random((h10, w10, 3)).astype(np.float32)
    c_ = np.asarray(kw.separable_resample_fast(
        jnp.asarray(big), srd, scd, fill=np.nan))
    d = np.moveaxis(np.asarray(kw.separable_resample_fast_cmajor(
        jnp.asarray(np.moveaxis(big, -1, 0)), srd, scd, fill=np.nan)),
        0, -1)
    np.testing.assert_allclose(np.nan_to_num(c_), np.nan_to_num(d),
                               rtol=0, atol=5e-7)


def test_cmajor_nodata_renormalisation(rng):
    """Per-channel nodata renormalisation in the channel-major twin
    matches the channel-minor path (each channel's nodata pattern gets
    its own denominator)."""
    import jax.numpy as jnp
    import hyperres.kernels.warp as kw

    h10, w10, f = 60, 72, 6
    h60, w60 = h10 // f, w10 // f
    idx_r = (np.arange(h60) + 0.5) * f - 0.5
    idx_c = (np.arange(w60) + 0.5) * f - 0.5
    sr = kw.separable_fast_spec(idx_r, h10, "average", scale=f)
    sc = kw.separable_fast_spec(idx_c, w10, "average", scale=f)
    img = rng.random((h10, w10, 3)).astype(np.float32)
    # distinct nodata pattern per channel
    img[5:20, 8:30, 0] = 65535.0
    img[2:9, 40:66, 2] = 65535.0
    a = np.asarray(kw.separable_resample_fast(
        jnp.asarray(img), sr, sc, nodata=65535.0, fill=np.nan))
    b = np.moveaxis(np.asarray(kw.separable_resample_fast_cmajor(
        jnp.asarray(np.moveaxis(img, -1, 0)), sr, sc, nodata=65535.0,
        fill=np.nan)), 0, -1)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                               rtol=0, atol=5e-7)
    # channels must renormalise independently: channel 1 (no nodata)
    # keeps plain means where channel 0 is masked
    assert not np.isnan(a[1, 2, 1])
