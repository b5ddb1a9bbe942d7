"""Tests that need the card. They skip without a GPU; on a machine with
one, run them with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
``chip_smoke.py`` runs the same checks at full granule size."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev


def test_banded_warp_matches_dense_on_gpu(gpu, rng):
    """Banded vs dense two-pass at "highest" as the GPU compiles them."""
    import jax
    import jax.numpy as jnp

    from hyperres.kernels.warp import (
        _two_pass_core, banded_two_pass, scanline_cstar,
    )

    ho, wo, hd, wd, c = 700, 720, 690, 705, 33
    src = jnp.asarray(rng.random((ho, wo, c)).astype(np.float32))
    r = np.arange(hd, dtype=np.float32)[:, None]
    j = np.arange(wd, dtype=np.float32)[None, :]
    rows = (r * (ho / hd) + 0.004 * j * r / hd + 0.3).astype(np.float32)
    cols = (j * (wo / wd) + 0.003 * r - 0.2).astype(np.float32)
    cstar = scanline_cstar(rows, cols, ho)
    dense = _two_pass_core(src, jnp.asarray(rows), jnp.asarray(cstar),
                           "cubic", 64, 64, jax.lax.Precision.HIGHEST)
    band = banded_two_pass(src, jnp.asarray(rows), jnp.asarray(cstar),
                           "cubic", "highest", group=32)
    assert float(jnp.max(jnp.abs(band - dense))) <= 1e-5


def test_sr_predict_on_gpu_matches_float64(gpu):
    from chip_smoke import fit_sr_model, sr_oracle_u16

    model = fit_sr_model(285, 20000, seed=0)
    cube = np.random.default_rng(1).random((10, 256, 256)).astype(
        np.float32)
    q = model.predict_cube_u16(cube)
    flat = cube.reshape(10, -1).T
    want = sr_oracle_u16(model.params, flat[:4096], 3)
    got = q.reshape(285, -1).T[:4096].astype(np.int64)
    assert np.abs(got - want).max() <= 1


def test_fused_plan_on_gpu_meets_gates(gpu):
    import jax

    import bench

    wk = bench.build_workload(0.2, "auto")
    plan = wk["plan"]
    s2 = plan.prepare_s2(wk["s2_dn"])
    out = plan(wk["raw"], s2, key=jax.random.PRNGKey(0))
    target = plan.s2_reference_10m(out["utm_cube"], s2)
    acc = [float(x) for x in jax.jit(bench.accuracy_metrics)(
        out["fused_10m"], target, out["coeffs"])]
    assert bench.gates_pass(acc, bench.accuracy_gates()), acc
