"""The banded two-pass warp (windowed contraction in plain lax) and the
one backend-selection function, against the dense two-pass reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hyperres.kernels.glt import prepare_glt
from hyperres.kernels.warp import (
    BANDED_GROUP_CANDIDATES, _two_pass_core, banded_spans_ok,
    banded_two_pass, orthowarp_two_pass, scanline_cstar,
    select_banded_group, select_warp_backend,
)


def _projective_fields(hd, wd, ho, wo):
    """A mildly sheared/projective dst->src field (EMIT-like geometry)."""
    r = np.arange(hd, dtype=np.float32)[:, None]
    j = np.arange(wd, dtype=np.float32)[None, :]
    rows = (r * (ho / hd) + 0.004 * j * r / hd + 0.3).astype(np.float32)
    cols = (j * (wo / wd) + 0.003 * r - 0.2).astype(np.float32)
    return rows, cols


def _glt_scene(rng, ho=200, wo=210):
    raw = rng.random((150, 160, 7)).astype(np.float32)
    glt = np.zeros((ho, wo, 2), np.int32)
    valid = rng.random((ho, wo)) > 0.15
    glt[..., 0] = np.where(valid, rng.integers(1, 161, (ho, wo)), 0)
    glt[..., 1] = np.where(valid, rng.integers(1, 151, (ho, wo)), 0)
    flat_idx, vmask = prepare_glt(glt, (150, 160))
    return raw, flat_idx, vmask


@pytest.mark.parametrize("method", ["cubic", "bilinear"])
def test_banded_two_pass_matches_dense(rng, method):
    """The banded windowed contraction reproduces the dense two-pass warp
    pre-division at precision "highest"; end to end through
    orthowarp_two_pass the nodata masks agree."""
    ho, wo, hd, wd = 200, 210, 190, 205
    raw, flat_idx, vmask = _glt_scene(rng, ho, wo)
    rows, cols = _projective_fields(hd, wd, ho, wo)
    cstar = np.asarray(scanline_cstar(rows, cols, ho))
    assert banded_spans_ok(cstar) and banded_spans_ok(rows.T)

    b = raw.shape[-1]
    v = jnp.take(jnp.asarray(raw).reshape(-1, b),
                 jnp.asarray(flat_idx).reshape(-1),
                 axis=0).reshape(ho, wo, b)
    validf = jnp.asarray(vmask).astype(jnp.float32)[..., None]
    src_ext = jnp.concatenate([v * validf, validf], axis=-1)
    dense = np.asarray(_two_pass_core(
        src_ext, jnp.asarray(rows), jnp.asarray(cstar), method,
        64, 64, jax.lax.Precision.HIGHEST))
    band = np.asarray(banded_two_pass(
        src_ext, jnp.asarray(rows), jnp.asarray(cstar), method=method,
        precision="highest", group=8))
    np.testing.assert_allclose(band, dense, rtol=0, atol=3e-6)
    args = [jnp.asarray(x) for x in (raw, flat_idx, vmask, rows, cols,
                                     cstar)]
    a = np.asarray(orthowarp_two_pass(*args, method=method))
    g = np.asarray(orthowarp_two_pass(*args, method=method,
                                      banded_group=8))
    np.testing.assert_array_equal(a == -9999.0, g == -9999.0)


def test_select_banded_group_adaptive(rng):
    """select_banded_group returns the largest candidate whose grouped
    span check passes, degrades for curvier fields, and returns None
    when even the smallest group is infeasible."""
    d = 512
    j = np.arange(d, dtype=np.float32)[None, :]

    def field(slope):
        r = np.arange(256, dtype=np.float32)[:, None]
        return (j + slope * r).astype(np.float32)

    near_identity = field(0.0)
    assert select_banded_group(near_identity, near_identity) == \
        BANDED_GROUP_CANDIDATES[0]
    # slope 5: a group of 32 rows spans 31*5=155 extra samples on top of
    # the 127-wide tile -> >251, infeasible; 16 rows span 75+127 -> ok
    curved = field(5.0)
    g = select_banded_group(curved, near_identity)
    assert g is not None and g < BANDED_GROUP_CANDIDATES[0]
    assert banded_spans_ok(curved, group=g)
    # strong downsampling: even per-4-rows tiles span > 251 samples
    wide = (j * 4.0) + 0.0 * np.arange(8, dtype=np.float32)[:, None]
    assert select_banded_group(wide, wide) is None


def test_banded_groups_agree(rng):
    """The banded warp produces identical results for every window-
    sharing group size (the group only changes which samples are
    gathered together, not the taps)."""
    ho, wo, c = 150, 160, 5
    hd, wd = 140, 155
    src = rng.random((ho, wo, c)).astype(np.float32)
    rows, cols = _projective_fields(hd, wd, ho, wo)
    cstar = np.asarray(scanline_cstar(rows, cols, ho))
    outs = []
    for g in (4, 8, 32):
        assert banded_spans_ok(cstar, group=g)
        assert banded_spans_ok(rows.T, group=g)
        outs.append(np.asarray(banded_two_pass(
            jnp.asarray(src), jnp.asarray(rows), jnp.asarray(cstar),
            method="cubic", precision="highest", group=g)))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


def test_banded_tile_geometries_agree(rng):
    """Window/tile geometry (nblk window blocks x dtile destination
    samples) changes which samples each dot contracts, not the taps:
    every feasible geometry produces identical results, including
    windows of more than the default 3 blocks and tiles wider than
    128."""
    ho, wo, c = 150, 600, 5
    hd, wd = 140, 590
    src = rng.random((ho, wo, c)).astype(np.float32)
    rows, cols = _projective_fields(hd, wd, ho, wo)
    cstar = np.asarray(scanline_cstar(rows, cols, ho))
    outs = []
    for nblk, dtile, g in ((3, 128, 8), (4, 256, 8), (5, 384, 4)):
        assert banded_spans_ok(cstar, group=g, nblk=nblk, dtile=dtile)
        assert banded_spans_ok(rows.T, group=g, nblk=nblk, dtile=dtile)
        outs.append(np.asarray(banded_two_pass(
            jnp.asarray(src), jnp.asarray(rows), jnp.asarray(cstar),
            method="cubic", precision="highest", group=g, nblk=nblk,
            dtile=dtile)))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


def test_banded_spans_ok_rejects_wide_tiles():
    pos = np.linspace(0.0, 4000.0, 256, dtype=np.float32)[None, :]
    assert not banded_spans_ok(pos)   # ~2000-sample tile span
    pos2 = np.linspace(0.0, 250.0, 256, dtype=np.float32)[None, :]
    assert banded_spans_ok(pos2)      # ~125-sample tile span


@pytest.mark.parametrize("platform", ["cpu", "gpu", "rocm"])
def test_select_warp_backend_ignores_platform(monkeypatch, platform):
    """The backend follows the geometry alone: the same choice whatever
    JAX reports as its backend."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    rows, cols = _projective_fields(190, 205, 200, 210)
    cstar = np.asarray(scanline_cstar(rows, cols, 200))
    assert select_warp_backend(cstar, rows) == (
        "banded", BANDED_GROUP_CANDIDATES[0])
    assert select_warp_backend(cstar, rows, "dense") == ("dense", None)


def test_select_warp_backend_dense_on_infeasible_geometry():
    """Strong downsampling leaves the windows: "auto" takes the dense
    path, an explicit "banded" request raises instead of losing taps,
    and unknown names are rejected."""
    r = np.arange(64, dtype=np.float32)[:, None]
    j = np.arange(300, dtype=np.float32)[None, :]
    rows = np.broadcast_to(r * 4.0, (64, 300)).astype(np.float32)
    cstar = np.broadcast_to(j * 4.0, (256, 300)).astype(np.float32)
    assert select_warp_backend(cstar, rows) == ("dense", None)
    with pytest.raises(ValueError, match="infeasible"):
        select_warp_backend(cstar, rows, "banded")
    with pytest.raises(ValueError, match="Unknown warp backend"):
        select_warp_backend(cstar, rows, "pallas")


def test_orthowarp_two_pass_banded_block_sizes_agree(rng):
    """orthowarp_two_pass hands its block sizes to the banded passes: a
    64-row block loop, a 16-row one and one block per pass (a single
    dot_general each) give identical products."""
    raw, flat_idx, vmask = _glt_scene(rng, 200, 210)
    rows, cols = _projective_fields(190, 205, 200, 210)
    cstar = scanline_cstar(rows, cols, 200)
    args = [jnp.asarray(x) for x in (raw, flat_idx, vmask, rows, cols,
                                     cstar)]
    outs = [np.asarray(orthowarp_two_pass(
        *args, banded_group=8, block_rows_src=bs, block_rows_dst=bd))
        for bs, bd in ((64, 64), (16, 16), (256, 256))]
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])
