"""Batched least squares, polynomial fitting, and ridge regression.

Device replacements for np.polyfit/np.polyval (s2_emit/poly_regression.py:
58-84, demo cells 65/72), np.linalg.lstsq (color.py:106-109) and the
sklearn StandardScaler -> PolynomialFeatures -> Ridge pipeline
(legacy_notebooks/Spectral_matching.ipynb cells 22-25).

Numerics: fits use QR in f32 (not normal equations) so degree-4
Vandermonde systems stay well conditioned; ridge uses the standardised
normal equations with a Cholesky solve, whose Gram accumulation is a
single MXU matmul and reduces cleanly with psum across data shards.
"""

from __future__ import annotations

from functools import partial
from itertools import combinations_with_replacement
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# 1-D polynomial fit / eval (np.polyfit / np.polyval semantics)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("deg",))
def polyfit(x: jax.Array, y: jax.Array, deg: int,
            w: Optional[jax.Array] = None) -> jax.Array:
    """Least-squares polynomial fit; returns (deg+1,) coefficients highest
    power first (np.polyfit convention). ``w`` are 0/1 sample weights that
    keep shapes static while excluding masked points."""
    x = x.astype(jnp.float32)
    y = y.astype(jnp.float32)
    V = jnp.stack([x ** (deg - k) for k in range(deg + 1)], axis=1)
    if w is not None:
        sw = jnp.sqrt(w.astype(jnp.float32))
        V = V * sw[:, None]
        y = y * sw
    Q, R = jnp.linalg.qr(V)
    return jax.scipy.linalg.solve_triangular(
        R, jnp.dot(Q.T, y, precision=jax.lax.Precision.HIGHEST), lower=False)


@jax.jit
def polyval(coeffs: jax.Array, x: jax.Array) -> jax.Array:
    """Horner evaluation, coefficients highest power first."""
    out = jnp.zeros_like(x) + coeffs[0]
    for c in coeffs[1:]:
        out = out * x + c
    return out


# vmapped channel-wise variants (the (3, deg+1) RGB case)
polyfit_channels = jax.vmap(polyfit, in_axes=(1, 1, None), out_axes=0)


@jax.jit
def polyval_channels(coeffs: jax.Array, img: jax.Array) -> jax.Array:
    """coeffs (C, deg+1), img (..., C) -> (..., C)."""
    chans = [polyval(coeffs[c], img[..., c]) for c in range(img.shape[-1])]
    return jnp.stack(chans, axis=-1)


def polyval_channels_cmajor(coeffs: jax.Array, img_chw: jax.Array
                            ) -> jax.Array:
    """coeffs (C, deg+1), img (C, H, W) -> (C, H, W): the channel-major
    twin of :func:`polyval_channels` (Horner with per-channel
    coefficients broadcast over the spatial minor axes)."""
    c, k = coeffs.shape
    acc = jnp.broadcast_to(coeffs[:, 0][:, None, None], img_chw.shape)
    for i in range(1, k):
        acc = acc * img_chw + coeffs[:, i][:, None, None]
    return acc


@partial(jax.jit, static_argnames=())
def linear_fit_masked(x: jax.Array, y: jax.Array, valid: jax.Array,
                      min_count: int = 50) -> Tuple[jax.Array, jax.Array]:
    """Per-band y = a*x + b via masked closed form, identity fallback when
    fewer than ``min_count`` valid samples (demo cell 72)."""
    w = valid.astype(jnp.float32)
    n = jnp.sum(w)
    sx = jnp.sum(w * x)
    sy = jnp.sum(w * y)
    sxx = jnp.sum(w * x * x)
    sxy = jnp.sum(w * x * y)
    denom = n * sxx - sx * sx
    a = jnp.where(jnp.abs(denom) > 1e-20, (n * sxy - sx * sy) / denom, 1.0)
    b = jnp.where(jnp.abs(denom) > 1e-20, (sy - a * sx) / n, 0.0)
    ok = n >= min_count
    return jnp.where(ok, a, 1.0), jnp.where(ok, b, 0.0)


@jax.jit
def affine_fit(X: jax.Array, Y: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Least-squares affine map Y ~ X @ A + t (A (d, d), t (d,)) via the
    augmented system, matching color.py:106-109."""
    n = X.shape[0]
    Xa = jnp.concatenate([X, jnp.ones((n, 1), dtype=X.dtype)], axis=1)
    W, *_ = jnp.linalg.lstsq(Xa, Y)
    return W[:-1, :], W[-1, :]


# ---------------------------------------------------------------------------
# Multivariate polynomial features (sklearn PolynomialFeatures span)
# ---------------------------------------------------------------------------

def poly_feature_exponents(n_features: int, degree: int,
                           include_bias: bool = False) -> np.ndarray:
    """(F, n_features) exponent matrix enumerating all monomials with
    1 <= total degree <= degree (plus the constant when include_bias),
    in sklearn's ordering (degree-major, combinations with replacement)."""
    rows: List[np.ndarray] = []
    if include_bias:
        rows.append(np.zeros(n_features, dtype=np.int32))
    for d in range(1, degree + 1):
        for combo in combinations_with_replacement(range(n_features), d):
            e = np.zeros(n_features, dtype=np.int32)
            for i in combo:
                e[i] += 1
            rows.append(e)
    return np.stack(rows, axis=0)


def poly_factor_indices(n_features: int, degree: int,
                        include_bias: bool = False) -> np.ndarray:
    """(F, degree) int32: factor each monomial into exactly ``degree``
    indices into [1, x_0, ..., x_{n-1}] (index 0 is the constant-one
    column) — monomial m = prod_d X_ext[:, factor_idx[m, d]]."""
    if degree < 1:
        raise ValueError("degree must be >= 1")
    exps = poly_feature_exponents(n_features, degree, include_bias)
    factor_idx = np.zeros((exps.shape[0], degree), dtype=np.int32)
    for row, e in enumerate(exps):
        fs = []
        for i, p in enumerate(e):
            fs.extend([i + 1] * int(p))
        fs.extend([0] * (degree - len(fs)))
        factor_idx[row] = fs
    return factor_idx


def make_poly_expander(n_features: int, degree: int,
                       include_bias: bool = False):
    """Returns a traced function (N, n_features) -> (N, F) computing the
    monomial expansion as ``degree`` gathered-column products — three
    gathers and two elementwise multiplies for degree 3 instead of an
    unrolled per-monomial chain (a ~100x trace/compile-size reduction at
    285 features, and a vectorised runtime)."""
    factor_idx = poly_factor_indices(n_features, degree, include_bias)

    idx_const = [jnp.asarray(factor_idx[:, d]) for d in range(degree)]

    def expand(X: jax.Array) -> jax.Array:
        ones = jnp.ones(X.shape[:-1] + (1,), dtype=X.dtype)
        X_ext = jnp.concatenate([ones, X], axis=-1)
        out = jnp.take(X_ext, idx_const[0], axis=-1)
        for d in range(1, degree):
            out = out * jnp.take(X_ext, idx_const[d], axis=-1)
        return out

    return expand, factor_idx.shape[0]


# ---------------------------------------------------------------------------
# Ridge with standardisation (the Spectral_matching pipeline)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=())
def ridge_solve(XtX: jax.Array, XtY: jax.Array, alpha: float) -> jax.Array:
    """Solve (XtX + alpha I) W = XtY by Cholesky."""
    k = XtX.shape[0]
    A = XtX + alpha * jnp.eye(k, dtype=XtX.dtype)
    L = jnp.linalg.cholesky(A)
    return jax.scipy.linalg.cho_solve((L, True), XtY)


def ridge_fit_centered(F: jax.Array, Y: jax.Array, alpha: float,
                       sample_weight: Optional[jax.Array] = None):
    """Ridge with unpenalised intercept (sklearn Ridge semantics): centre
    features and targets, solve the penalised system, recover intercept.
    Returns (W (F, T), intercept (T,), f_mean (F,), y_mean (T,))."""
    if sample_weight is not None:
        w = sample_weight.astype(F.dtype)[:, None]
        n = jnp.sum(w)
        f_mean = jnp.sum(F * w, axis=0) / n
        y_mean = jnp.sum(Y * w, axis=0) / n
        Fc = (F - f_mean) * jnp.sqrt(w)
        Yc = (Y - y_mean) * jnp.sqrt(w)
    else:
        f_mean = jnp.mean(F, axis=0)
        y_mean = jnp.mean(Y, axis=0)
        Fc = F - f_mean
        Yc = Y - y_mean
    XtX = jnp.dot(Fc.T, Fc, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    XtY = jnp.dot(Fc.T, Yc, preferred_element_type=jnp.float32,
                  precision=jax.lax.Precision.HIGHEST)
    W = ridge_solve(XtX, XtY, alpha)
    intercept = y_mean - f_mean @ W
    return W, intercept, f_mean, y_mean


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

@jax.jit
def r2_rmse_per_band(y_true: jax.Array, y_pred: jax.Array,
                     valid: Optional[jax.Array] = None
                     ) -> Tuple[jax.Array, jax.Array]:
    """Per-band R^2 and RMSE over (N, B) arrays, matching the reference's
    evaluation (Spectral_matching cell 26)."""
    if valid is None:
        valid = jnp.isfinite(y_true) & jnp.isfinite(y_pred)
    w = valid.astype(jnp.float32)
    n = jnp.sum(w, axis=0)
    yt = jnp.where(valid, y_true, 0.0)
    yp = jnp.where(valid, y_pred, 0.0)
    mean = jnp.sum(yt, axis=0) / jnp.maximum(n, 1.0)
    ss_res = jnp.sum(w * (yt - yp) ** 2, axis=0)
    ss_tot = jnp.sum(w * (yt - mean[None, :]) ** 2, axis=0) + 1e-8
    r2 = 1.0 - ss_res / ss_tot
    rmse = jnp.sqrt(ss_res / jnp.maximum(n, 1.0))
    return r2, rmse


@jax.jit
def logit(x: jax.Array, eps: float = 1e-4) -> jax.Array:
    x = jnp.clip(x, eps, 1.0 - eps)
    return jnp.log(x / (1.0 - x))


@jax.jit
def sigmoid(z: jax.Array) -> jax.Array:
    z = jnp.clip(z, -50.0, 50.0)
    return 1.0 / (1.0 + jnp.exp(-z))
