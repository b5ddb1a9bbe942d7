"""SRF parametric-vs-measured sensitivity analysis (round-4 VERDICT
item 4).

Measured Copernicus SRF curves cannot ship in-repo (no egress), so the
default is the parametric super-Gaussian model. This bounds the
consequence: perturb the parametric model within realistic
parametric-vs-measured divergence bounds (band centre +-2 nm, FWHM
+-5%, shoulder exponent 3..5), propagate each perturbation through

  1. SRF band synthesis (the direct pseudo-S2 band values), and
  2. the FULL OT+poly fusion (the shipped product),

and report worst-case deltas. Writes the table that docs/PARITY.md
cites. Runs on the CPU.

Usage: python scripts/srf_sensitivity.py [--h60 96] [--w60 128]
"""

import argparse
import itertools
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def log(m):
    print(m, file=sys.stderr, flush=True)


def perturb_srf(srf, d_centre_nm=0.0, fwhm_factor=1.0):
    """Shift each band's wavelength axis by d_centre_nm and scale its
    width about the response-weighted centre by fwhm_factor (the
    response samples are untouched — this transforms the support)."""
    out = {}
    for b, (lam, resp) in srf.items():
        c = float(np.trapz(lam * resp, lam) / np.trapz(resp, lam))
        lam2 = c + (lam - c) * fwhm_factor + d_centre_nm
        out[b] = (lam2, resp)
    return out


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from hyperres.core.config import OTConfig, PolyFusionConfig
    from hyperres.core.crs import CRS
    from hyperres.core.grid import Grid
    from hyperres.fusion.fused import FusedFusionPlan
    from hyperres.kernels.srf import build_srf_weight_matrix
    from hyperres.spectral import builtin_srf
    from hyperres.testing import scenes

    ap = argparse.ArgumentParser()
    ap.add_argument("--h60", type=int, default=96)
    ap.add_argument("--w60", type=int, default=128)
    args = ap.parse_args()

    n_bands = 285
    wl, good = scenes.emit_wavelength_grid(n_bands)
    spectra = scenes.endmember_spectra(wl)  # (K, 285) realistic shapes

    utm = CRS.utm(33, True)
    h60, w60 = args.h60, args.w60
    emit_grid = Grid(utm, 399960.0, 5800020.0, 60.0, 60.0, w60, h60)
    s2_grid = Grid(utm, 399960.0, 5800020.0, 10.0, 10.0, w60 * 6,
                   h60 * 6)
    xs, ys = emit_grid.pixel_center_coords()
    X, Y = np.meshgrid(xs, ys)
    ab = scenes.abundance_maps(X, Y).astype(np.float32)
    rng = np.random.default_rng(0)
    cube = np.clip(ab @ spectra.astype(np.float32)
                   + rng.normal(scale=0.002,
                                size=(h60, w60, n_bands)).astype(
                                    np.float32),
                   0.005, 0.95).astype(np.float32)

    bands = ["B2", "B3", "B4"]
    base_srf = builtin_srf("S2A", bands=bands)
    Wb, names, _ = build_srf_weight_matrix(wl, base_srf, good)
    Wb = np.asarray(Wb)

    # the "real" S2 at 10 m: world through the BASELINE curves (the
    # measured-truth stand-in), so perturbations model EMIT-side
    # synthesis running on wrong curves against fixed real S2 data
    xs2, ys2 = s2_grid.pixel_center_coords()
    X2, Y2 = np.meshgrid(xs2, ys2)
    ab2 = scenes.abundance_maps(X2, Y2).astype(np.float32)
    band_spec = (spectra @ Wb).astype(np.float32)
    s2rgb = np.clip(ab2 @ band_spec, 0.0, 1.0).astype(np.float32)
    del ab2

    valid = np.ones((h60, w60), bool)
    flat = cube.reshape(-1, n_bands)

    cfg = PolyFusionConfig(degree=4, ot=OTConfig(n_samples=2000))

    def run_fusion(srf):
        plan = FusedFusionPlan(emit_grid, s2_grid, wl, good,
                               config=cfg, srf=srf)
        out = plan(jnp.asarray(cube), jnp.asarray(s2rgb))
        f = np.asarray(out["fused_10m"])
        return f

    log("baseline fusion ...")
    fused_base = run_fusion(base_srf)

    rows = []
    worst_band = 0.0
    worst_fused_rms = 0.0
    worst_fused_psnr = np.inf
    combos = list(itertools.product([-2.0, 0.0, 2.0],
                                    [0.95, 1.0, 1.05],
                                    [3.0, 4.0, 5.0]))
    for dc, ff, expo in combos:
        if dc == 0.0 and ff == 1.0 and expo == 4.0:
            continue
        srf_p = perturb_srf(builtin_srf("S2A", bands=bands,
                                        exponent=expo), dc, ff)
        Wp, _, _ = build_srf_weight_matrix(wl, srf_p, good)
        Wp = np.asarray(Wp)
        syn_b = flat @ Wb
        syn_p = flat @ Wp
        d = np.abs(syn_p - syn_b)
        band_max = float(d.max())
        band_rel = float((d / np.maximum(syn_b, 1e-3)).max())
        fused_p = run_fusion(srf_p)
        m = np.isfinite(fused_p).all(-1) & np.isfinite(fused_base).all(-1)
        df = fused_p[m] - fused_base[m]
        rms = float(np.sqrt((df ** 2).mean()))
        mx = float(np.abs(df).max())
        psnr = float(10 * np.log10(1.0 / max((df ** 2).mean(), 1e-12)))
        rows.append({
            "d_centre_nm": dc, "fwhm_factor": ff, "exponent": expo,
            "band_abs_max": round(band_max, 5),
            "band_rel_max": round(band_rel, 4),
            "fused_rms": round(rms, 5), "fused_abs_max": round(mx, 4),
            "fused_psnr_db_vs_baseline": round(psnr, 1),
        })
        worst_band = max(worst_band, band_max)
        worst_fused_rms = max(worst_fused_rms, rms)
        worst_fused_psnr = min(worst_fused_psnr, psnr)
        log(f"dc={dc:+.0f}nm fwhm x{ff:.2f} p={expo:.0f}: "
            f"band max {band_max:.4f} ({band_rel * 100:.2f}%), fused "
            f"rms {rms:.5f} max {mx:.4f} ({psnr:.1f} dB)")

    summary = {
        "perturbations": len(rows),
        "worst_band_abs_delta_reflectance": round(worst_band, 5),
        "worst_fused_rms_stretched": round(worst_fused_rms, 5),
        "worst_fused_psnr_db_vs_baseline": round(worst_fused_psnr, 1),
        "rows": rows,
    }
    print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
