import numpy as np
import jax.numpy as jnp
import pytest

from hyperres.kernels import lstsq as kls
from hyperres.kernels import sinkhorn as kot


# ------------------------------------------------------------- sinkhorn ----

def numpy_sinkhorn(a, b, M, reg, iters=20000, thr=1e-10):
    """Independent linear-domain oracle (the textbook algorithm POT
    implements). Convergence is judged on the *row* marginal — the column
    marginal is satisfied identically right after the v-update."""
    K = np.exp(-M / reg)
    u = np.ones_like(a)
    v = np.ones_like(b)
    for i in range(iters):
        u = a / (K @ v + 1e-300)
        v = b / (K.T @ u + 1e-300)
        if i % 10 == 0:
            P = u[:, None] * K * v[None, :]
            if np.abs(P.sum(axis=1) - a).sum() < thr:
                break
    return u[:, None] * K * v[None, :]


def test_cdist_matches_numpy(rng):
    X = rng.random((40, 3)).astype(np.float32)
    Y = rng.random((50, 3)).astype(np.float32)
    got = np.asarray(kot.sqeuclidean_cdist(jnp.asarray(X), jnp.asarray(Y)))
    want = ((X[:, None, :] - Y[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_sinkhorn_matches_linear_domain_oracle(rng):
    n, m = 60, 70
    X = rng.random((n, 3))
    Y = rng.random((m, 3)) * 0.8 + 0.1
    M = ((X[:, None, :] - Y[None, :, :]) ** 2).sum(-1)
    a = np.full(n, 1.0 / n)
    b = np.full(m, 1.0 / m)
    P_oracle = numpy_sinkhorn(a, b, M, reg=0.05)
    P, err = kot.sinkhorn_log(jnp.asarray(a, dtype=jnp.float32),
                              jnp.asarray(b, dtype=jnp.float32),
                              jnp.asarray(M, dtype=jnp.float32), 0.05,
                              num_itermax=2000, stop_thr=1e-9)
    P = np.asarray(P)
    assert float(err) < 1e-6
    np.testing.assert_allclose(P.sum(axis=1), a, atol=1e-6)
    np.testing.assert_allclose(P.sum(axis=0), b, atol=1e-6)
    np.testing.assert_allclose(P, P_oracle, rtol=0, atol=2e-6)


def test_sinkhorn_log_weighted_marginals_match_oracle(rng):
    """Non-uniform marginals, including vanishing-mass padding slots
    (the fixed-shape device sampler's weights), against the linear-
    domain oracle."""
    n, m = 50, 64
    X = rng.random((n, 3))
    Y = rng.random((m, 3)) * 0.8 + 0.1
    M = ((X[:, None, :] - Y[None, :, :]) ** 2).sum(-1)
    wa = np.concatenate([rng.random(n - 8) + 0.5, np.full(8, 1e-12)])
    a = wa / wa.sum()
    wb = rng.random(m) + 0.5
    b = wb / wb.sum()
    P_oracle = numpy_sinkhorn(a, b, M, reg=0.05)
    P, err = kot.sinkhorn_log(jnp.asarray(a, dtype=jnp.float32),
                              jnp.asarray(b, dtype=jnp.float32),
                              jnp.asarray(M, dtype=jnp.float32), 0.05,
                              num_itermax=2000, stop_thr=1e-9)
    P = np.asarray(P)
    assert float(err) < 1e-6
    np.testing.assert_allclose(P.sum(axis=1), a, atol=1e-6)
    np.testing.assert_allclose(P.sum(axis=0), b, atol=1e-6)
    np.testing.assert_allclose(P, P_oracle, rtol=0, atol=2e-6)
    assert P[-8:].sum() < 1e-9   # padding slots carry no mass


def test_sinkhorn_log_early_stop(rng):
    """The stopping rule ends the loop at the first check (every 10
    iterations) whose marginal violation is under stop_thr: a loose
    threshold returns exactly the 10-iteration plan, while stop_thr=0
    runs to num_itermax and gives a different (further) iterate."""
    n, m = 80, 90
    X = rng.random((n, 3)).astype(np.float32)
    Y = (rng.random((m, 3)) * 0.5).astype(np.float32)
    a = jnp.full((n,), 1.0 / n, jnp.float32)
    b = jnp.full((m,), 1.0 / m, jnp.float32)
    M = kot.sqeuclidean_cdist(jnp.asarray(X), jnp.asarray(Y))
    P_loose, err = kot.sinkhorn_log(a, b, M, 0.01, num_itermax=5000,
                                    stop_thr=1.0)
    P_10, _ = kot.sinkhorn_log(a, b, M, 0.01, num_itermax=10,
                               stop_thr=0.0)
    P_200, _ = kot.sinkhorn_log(a, b, M, 0.01, num_itermax=200,
                                stop_thr=0.0)
    assert float(err) <= 1.0
    np.testing.assert_array_equal(np.asarray(P_loose), np.asarray(P_10))
    assert np.abs(np.asarray(P_200) - np.asarray(P_10)).max() > 1e-6


def test_barycentric_targets_pull_toward_reference(rng):
    """OT barycentric projection of X onto a shifted cloud Y must move
    points toward Y's distribution."""
    X = rng.normal(size=(200, 3)).astype(np.float32) * 0.1 + 0.3
    Y = (X + 0.25).astype(np.float32)  # same shape, shifted
    Ybar = np.asarray(kot.ot_barycentric_targets(
        jnp.asarray(X), jnp.asarray(Y), reg=0.05))
    # mean must move to Y's mean (mass conservation)
    np.testing.assert_allclose(Ybar.mean(0), Y.mean(0), atol=0.02)


# ---------------------------------------------------------------- lstsq ----

def test_polyfit_matches_numpy(rng):
    x = rng.random(500).astype(np.float32)
    y = (0.3 - 1.2 * x + 0.8 * x ** 2 + 0.1 * x ** 4
         + rng.normal(scale=0.01, size=500)).astype(np.float32)
    for deg in (1, 2, 4):
        got = np.asarray(kls.polyfit(jnp.asarray(x), jnp.asarray(y), deg))
        want = np.polyfit(x.astype(np.float64), y.astype(np.float64), deg)
        # compare applied values, not raw coefficients (conditioning)
        xs = np.linspace(0, 1, 50)
        np.testing.assert_allclose(
            np.asarray(kls.polyval(jnp.asarray(got), jnp.asarray(
                xs, dtype=jnp.float32))),
            np.polyval(want, xs), rtol=0, atol=5e-4)


def test_polyval_matches_numpy(rng):
    coeffs = rng.normal(size=5)
    x = rng.random((20, 30)).astype(np.float32)
    got = np.asarray(kls.polyval(jnp.asarray(coeffs, dtype=jnp.float32),
                                 jnp.asarray(x)))
    np.testing.assert_allclose(got, np.polyval(coeffs, x), rtol=1e-4,
                               atol=1e-5)


def test_polyfit_masked_weights(rng):
    x = rng.random(300).astype(np.float32)
    y = (2.0 * x + 1.0).astype(np.float32)
    y[::3] = 999.0  # corrupted samples
    w = np.ones(300, dtype=np.float32)
    w[::3] = 0.0
    got = np.asarray(kls.polyfit(jnp.asarray(x), jnp.asarray(y), 1,
                                 jnp.asarray(w)))
    np.testing.assert_allclose(got, [2.0, 1.0], atol=1e-4)


def test_linear_fit_masked_fallback(rng):
    x = rng.random(100).astype(np.float32)
    y = (3.0 * x - 0.5).astype(np.float32)
    valid = np.zeros(100, dtype=bool)
    valid[:10] = True  # below min_count=50 -> identity
    a, b = kls.linear_fit_masked(jnp.asarray(x), jnp.asarray(y),
                                 jnp.asarray(valid))
    assert float(a) == 1.0 and float(b) == 0.0
    valid[:] = True
    a, b = kls.linear_fit_masked(jnp.asarray(x), jnp.asarray(y),
                                 jnp.asarray(valid))
    np.testing.assert_allclose([float(a), float(b)], [3.0, -0.5], atol=1e-3)


def test_affine_fit_matches_lstsq(rng):
    X = rng.random((200, 3)).astype(np.float32)
    A_true = np.array([[0.9, 0.05, 0.0], [0.1, 1.1, -0.05],
                       [0.0, 0.02, 0.95]], dtype=np.float32)
    t_true = np.array([0.01, -0.02, 0.03], dtype=np.float32)
    Y = X @ A_true + t_true
    A, t = kls.affine_fit(jnp.asarray(X), jnp.asarray(Y))
    np.testing.assert_allclose(np.asarray(A), A_true, atol=1e-4)
    np.testing.assert_allclose(np.asarray(t), t_true, atol=1e-4)


def test_poly_feature_exponents_match_sklearn():
    from sklearn.preprocessing import PolynomialFeatures
    X = np.random.default_rng(0).random((7, 4))
    pf = PolynomialFeatures(degree=3, include_bias=False)
    want = pf.fit_transform(X)
    expand, n_out = kls.make_poly_expander(4, 3, include_bias=False)
    got = np.asarray(expand(jnp.asarray(X, dtype=jnp.float32)))
    assert n_out == want.shape[1]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_ridge_matches_sklearn(rng):
    from sklearn.linear_model import Ridge
    X = rng.random((400, 6)).astype(np.float32)
    W_true = rng.normal(size=(6, 3)).astype(np.float32)
    Y = X @ W_true + 0.05 * rng.normal(size=(400, 3)).astype(np.float32)
    alpha = 1.0
    W, b, _, _ = kls.ridge_fit_centered(jnp.asarray(X), jnp.asarray(Y),
                                        alpha)
    sk = Ridge(alpha=alpha).fit(X, Y)
    pred_sk = sk.predict(X)
    pred = np.asarray(X @ np.asarray(W) + np.asarray(b))
    np.testing.assert_allclose(pred, pred_sk, rtol=0, atol=2e-4)


def test_r2_rmse_matches_reference_formula(rng):
    yt = rng.random((500, 4)).astype(np.float32)
    yp = (yt + 0.05 * rng.normal(size=(500, 4))).astype(np.float32)
    r2, rmse = kls.r2_rmse_per_band(jnp.asarray(yt), jnp.asarray(yp))
    for j in range(4):
        ss_res = np.sum((yt[:, j] - yp[:, j]) ** 2)
        ss_tot = np.sum((yt[:, j] - yt[:, j].mean()) ** 2) + 1e-8
        np.testing.assert_allclose(float(r2[j]), 1 - ss_res / ss_tot,
                                   rtol=1e-4)
        np.testing.assert_allclose(float(rmse[j]),
                                   np.sqrt(np.mean((yt[:, j] - yp[:, j]) ** 2)),
                                   rtol=1e-4)


def test_logit_sigmoid_roundtrip(rng):
    x = rng.random((100,)).astype(np.float32) * 0.98 + 0.01
    z = kls.logit(jnp.asarray(x))
    back = np.asarray(kls.sigmoid(z))
    np.testing.assert_allclose(back, x, atol=1e-5)
