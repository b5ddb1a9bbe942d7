"""Full-granule-scale accuracy validation on the device.

Produces the BASELINE.md parity metrics (PSNR / SAM) of the fused
GLT+cubic orthowarp product against the analytic world truth, plus
agreement between the fused kernel and the reference-semantics two-step
path, at real granule scale. Usage:

    python scripts/validate_fullscale.py [scale]
"""

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    import jax
    import jax.numpy as jnp

    from hyperres.core.crs import CRS
    from hyperres.core.grid import Grid, s2_anchored_target_grid
    from hyperres.kernels.glt import prepare_glt
    from hyperres.kernels.warp import (orthowarp_taploop,
                                       orthowarp_two_pass, scanline_cstar,
                                       source_index_field)
    from hyperres.pipeline import psnr, sam
    from hyperres.testing import scenes

    scale = float(sys.argv[1]) if len(sys.argv) > 1 else 1.0
    raw_h = max(64, int(1242 * scale))
    raw_w = max(64, int(1280 * scale))
    n_bands = 285

    rng = np.random.default_rng(0)
    wl, good = scenes.emit_wavelength_grid(n_bands)
    spectra = scenes.endmember_spectra(wl)
    utm = CRS.utm(33, True)
    cx, cy, th = 450000.0, 5770000.0, np.radians(13.0)
    rows, cols = np.meshgrid(np.arange(raw_h), np.arange(raw_w),
                             indexing="ij")
    u = (cols - raw_w / 2.0) * 60.0
    v = -(rows - raw_h / 2.0) * 60.0
    rx = cx + u * np.cos(th) - v * np.sin(th)
    ry = cy + u * np.sin(th) + v * np.cos(th)
    a = scenes.abundance_maps(rx, ry)
    noise = 0.002
    raw = np.clip(a @ spectra + rng.normal(scale=noise, size=(
        raw_h, raw_w, n_bands)), 0.005, 0.95).astype(np.float32)
    del a
    lon, lat = utm.to_geographic(rx, ry)
    res_x = 60.0 / 111320.0 / np.cos(np.radians(float(lat.mean())))
    res_y = 60.0 / 111320.0
    lon0 = float(lon.min()) - res_x
    lat0 = float(lat.max()) + res_y
    ow = int(np.ceil((float(lon.max()) + res_x - lon0) / res_x))
    oh = int(np.ceil((lat0 - (float(lat.min()) - res_y)) / res_y))
    og = Grid(CRS.geographic(), lon0, lat0, res_x, res_y, ow, oh)
    oxs, oys = og.pixel_center_coords()
    olon, olat = np.meshgrid(oxs, oys)
    oux, ouy = utm.from_geographic(olon, olat)
    du = (oux - cx) * np.cos(th) + (ouy - cy) * np.sin(th)
    dv = -(oux - cx) * np.sin(th) + (ouy - cy) * np.cos(th)
    ci = np.round(du / 60.0 + raw_w / 2.0).astype(np.int64)
    ri = np.round(-dv / 60.0 + raw_h / 2.0).astype(np.int64)
    inside = (ri >= 0) & (ri < raw_h) & (ci >= 0) & (ci < raw_w)
    glt = np.zeros((oh, ow, 2), dtype=np.int32)
    glt[..., 0] = np.where(inside, ci + 1, 0)
    glt[..., 1] = np.where(inside, ri + 1, 0)
    s2_x0 = np.floor(float(oux.min()) / 60.0) * 60.0
    s2_y0 = np.ceil(float(ouy.max()) / 60.0) * 60.0
    s2g = Grid(utm, s2_x0, s2_y0, 10.0, 10.0,
               int((float(oux.max()) - s2_x0) // 10.0),
               int((s2_y0 - float(ouy.min())) // 10.0))
    utm60 = s2_anchored_target_grid(og, s2g, 60.0, 60.0)
    flat_idx, valid = prepare_glt(glt, (raw_h, raw_w))
    wr, wc = source_index_field(og, utm60)

    cstar = scanline_cstar(wr, wc, og.height)
    print(f"raw {raw_h}x{raw_w}x{n_bands}; utm60 "
          f"{utm60.height}x{utm60.width}", flush=True)

    # truth at UTM pixel centres: upload only the (H, W, K) abundance
    # maps (~50 MB) and mix on device, so no 2.5 GB product cube has to
    # come back to the host for its metrics
    uxs, uys = utm60.pixel_center_coords()
    UX, UY = np.meshgrid(uxs, uys)
    a_truth = scenes.abundance_maps(UX, UY).astype(np.float32)
    noise_floor_db = 10 * np.log10(1.0 / noise ** 2)

    from hyperres.kernels.stats import cube_psnr_sam

    @jax.jit
    def device_metrics(cube, a_t, spec):
        truth = jnp.clip(a_t @ spec, 0.005, 0.95)
        return cube_psnr_sam(cube, truth, fill=-9999.0, erode=2)

    from hyperres.kernels.warp import select_warp_backend
    dev = [jax.device_put(a) for a in (raw, flat_idx, valid, wr, wc)]
    a_t = jax.device_put(a_truth)
    spec_j = jax.device_put(spectra.astype(np.float32))
    kernels = {"taploop": None, "two_pass/dense": None}
    backend, group = select_warp_backend(cstar, wr)
    if backend == "banded":
        kernels["two_pass/banded"] = group
    for kernel, banded_group in kernels.items():
        t0 = time.perf_counter()
        if kernel.startswith("two_pass"):
            cube = orthowarp_two_pass(
                *dev, jax.device_put(cstar), method="cubic",
                fill=-9999.0, banded_group=banded_group)
        else:
            cube = orthowarp_taploop(
                *dev, method="cubic", fill=-9999.0, row_chunks=64)
        vf, p, s = (float(x) for x in device_metrics(cube, a_t, spec_j))
        print(f"{kernel} orthowarp+metrics (incl. compile): "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        print(f"{kernel}: valid fraction {vf:.3f}; "
              f"PSNR vs world truth {p:.2f} dB "
              f"(sensor-noise ceiling ~{noise_floor_db:.1f} dB); "
              f"SAM {s:.5f} rad", flush=True)
        assert p > 30.0 and s < 0.05
        del cube
    print("PASS")


if __name__ == "__main__":
    main()
