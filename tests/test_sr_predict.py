"""The spectral-SR product path (one XLA engine) against float64 NumPy
at the production model width: 10 S2 bands, degree 3, 285 outputs."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import fit_sr_model, sr_oracle_u16  # noqa: E402


@pytest.fixture(scope="module")
def model():
    return fit_sr_model(285, 8000, seed=0)


def test_predict_cube_u16_matches_float64(model):
    """Every pixel of a cube that is not a multiple of the batch is
    within one u16 step of the float64 evaluation of the same params;
    the non-finite pixel is nodata."""
    rng = np.random.default_rng(1)
    assert model.n_features == 285
    cube = rng.random((10, 23, 29)).astype(np.float32)
    cube[:, 4, 6] = np.nan
    q = model.predict_cube_u16(cube, batch_pixels=256)
    assert q.shape == (285, 23, 29) and q.dtype == np.uint16
    flat = cube.reshape(10, -1).T
    ok = np.isfinite(flat).all(1)
    want = sr_oracle_u16(model.params, flat[ok], 3)
    got = q.reshape(285, -1).T[ok].astype(np.int64)
    assert np.abs(got - want).max() <= 1
    assert (q[:, 4, 6] == 65535).all()


def test_predict_cube_u16_has_one_engine(model):
    cube = np.zeros((10, 4, 4), np.float32)
    with pytest.raises(TypeError):
        model.predict_cube_u16(cube, engine="pallas")


def test_sharded_sr_predict_has_one_engine(model):
    from hyperres.parallel import make_mesh
    from hyperres.parallel.ops import sharded_sr_predict_u16

    with pytest.raises(TypeError):
        sharded_sr_predict_u16(model, np.zeros((8, 10), np.float32),
                               np.ones(8, bool), make_mesh(),
                               engine="pallas")
