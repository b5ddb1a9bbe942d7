"""Spectral super-resolution ridge model — the framework's flagship model.

Re-implements the reference's sklearn pipeline
``StandardScaler -> PolynomialFeatures(deg 3, no bias) -> Ridge(alpha 1)``
trained in logit space, with batched sigmoid inference over full 10 m
cubes (legacy_notebooks/Spectral_matching.ipynb cells 5-8, 20-27):

- training: one fused device program — standardise, expand monomials,
  accumulate the Gram system with one matmul, Cholesky solve. The Gram
  accumulation is a plain sum over samples, so data-parallel training
  across chips is a ``psum`` of per-shard Gram matrices (see
  hyperres.parallel).
- inference: jitted fixed-size pixel batches (the reference batches
  200k pixels on CPU), looped inside one device program for whole cubes.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import RidgeSRConfig
from ..kernels.lstsq import (
    logit, make_poly_expander, r2_rmse_per_band, ridge_solve, sigmoid,
)


@jax.tree_util.register_pytree_node_class
@dataclass
class RidgeSRParams:
    x_mean: jax.Array      # (Bx,)
    x_std: jax.Array       # (Bx,)
    W: jax.Array           # (F, By)
    intercept: jax.Array   # (By,)

    def tree_flatten(self):
        return (self.x_mean, self.x_std, self.W, self.intercept), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def flatten_pixels(X_bhw: np.ndarray, Y_bhw: np.ndarray,
                   x_nodata: Optional[float] = None,
                   y_nodata: Optional[float] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(Bx, H, W), (By, H, W) -> (N, Bx), (N, By) keeping only pixels
    finite in all bands and away from nodata (Spectral_matching cell 5)."""
    bx = X_bhw.shape[0]
    by = Y_bhw.shape[0]
    X = X_bhw.reshape(bx, -1).T
    Y = Y_bhw.reshape(by, -1).T
    mask = np.isfinite(X).all(axis=1) & np.isfinite(Y).all(axis=1)
    if x_nodata is not None:
        mask &= ~np.isclose(X, x_nodata).any(axis=1)
    if y_nodata is not None:
        mask &= ~np.isclose(Y, y_nodata).any(axis=1)
    return X[mask], Y[mask]


class RidgeSpectralSR:
    """S2 bands -> EMIT-band spectral super-resolution model."""

    def __init__(self, n_inputs: int, n_outputs: int,
                 config: RidgeSRConfig = RidgeSRConfig()):
        self.cfg = config
        self.n_inputs = int(n_inputs)
        self.n_outputs = int(n_outputs)
        self.expand, self.n_features = make_poly_expander(
            self.n_inputs, config.degree, include_bias=config.include_bias)
        self.params: Optional[RidgeSRParams] = None

    # ---- training ----

    def _gram_terms(self, X: jax.Array, Y_logit: jax.Array,
                    weights: Optional[jax.Array], x_mean, x_std):
        """Weighted Gram pieces for the centred ridge system."""
        Xs = (X - x_mean) / x_std
        F = self.expand(Xs)
        if weights is None:
            weights = jnp.ones(X.shape[0], dtype=jnp.float32)
        w = weights[:, None]
        n = jnp.sum(weights)
        f_sum = jnp.sum(F * w, axis=0)
        y_sum = jnp.sum(Y_logit * w, axis=0)
        FtF = jnp.dot((F * w).T, F, preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
        FtY = jnp.dot((F * w).T, Y_logit,
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
        return n, f_sum, y_sum, FtF, FtY

    @staticmethod
    def _solve_from_gram(n, f_sum, y_sum, FtF, FtY, alpha):
        """Centre the Gram system and solve the penalised normal
        equations; the intercept stays unpenalised (sklearn Ridge)."""
        f_mean = f_sum / n
        y_mean = y_sum / n
        FtF_c = FtF - jnp.outer(f_mean, f_sum) - jnp.outer(f_sum, f_mean) \
            + n * jnp.outer(f_mean, f_mean)
        FtY_c = FtY - jnp.outer(f_mean, y_sum) - jnp.outer(f_sum, y_mean) \
            + n * jnp.outer(f_mean, y_mean)
        W = ridge_solve(FtF_c, FtY_c, alpha)
        intercept = y_mean - f_mean @ W
        return W, intercept

    @partial(jax.jit, static_argnums=(0,))
    def _fit_device(self, X: jax.Array, Y: jax.Array,
                    weights: Optional[jax.Array]) -> RidgeSRParams:
        if weights is None:
            x_mean = jnp.mean(X, axis=0)
            x_std = jnp.std(X, axis=0) + 1e-12  # biased, like StandardScaler
        else:
            w = weights[:, None]
            n = jnp.sum(weights)
            x_mean = jnp.sum(X * w, axis=0) / n
            x_std = jnp.sqrt(jnp.sum(w * (X - x_mean) ** 2, axis=0) / n) + 1e-12
        Y_logit = logit(Y, eps=self.cfg.logit_eps)
        terms = self._gram_terms(X, Y_logit, weights, x_mean, x_std)
        W, intercept = self._solve_from_gram(*terms, self.cfg.alpha)
        return RidgeSRParams(x_mean, x_std, W, intercept)

    def fit(self, X: np.ndarray, Y: np.ndarray,
            weights: Optional[np.ndarray] = None) -> "RidgeSpectralSR":
        """X (N, Bx) S2 reflectance, Y (N, By) EMIT reflectance in (0, 1)
        (the logit transform happens inside, cell 20)."""
        self.params = self._fit_device(
            jnp.asarray(X, dtype=jnp.float32),
            jnp.asarray(Y, dtype=jnp.float32),
            None if weights is None else jnp.asarray(weights,
                                                     dtype=jnp.float32))
        return self

    # ---- inference ----

    @partial(jax.jit, static_argnums=(0,))
    def _predict_logit(self, params: RidgeSRParams, X: jax.Array) -> jax.Array:
        Xs = (X - params.x_mean) / params.x_std
        F = self.expand(Xs)
        return jnp.dot(F, params.W, preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST) + params.intercept

    def predict(self, X: np.ndarray) -> np.ndarray:
        """(N, Bx) -> (N, By) reflectance in [0, 1] (sigmoid of logits)."""
        assert self.params is not None, "fit() first"
        z = self._predict_logit(self.params, jnp.asarray(X, jnp.float32))
        return np.asarray(sigmoid(z))

    def predict_cube(self, X_bhw: np.ndarray,
                     nodata: Optional[float] = None,
                     batch_pixels: Optional[int] = None) -> np.ndarray:
        """(Bx, H, W) -> (By, H, W) in [0, 1]; invalid pixels are NaN —
        predict_cube_logit semantics (Spectral_matching cell 8)."""
        assert self.params is not None, "fit() first"
        batch = batch_pixels or self.cfg.batch_pixels
        b, h, w = X_bhw.shape
        X = np.asarray(X_bhw, dtype=np.float32).reshape(b, -1).T
        valid = np.isfinite(X).all(axis=1)
        if nodata is not None:
            valid &= ~np.isclose(X, nodata).any(axis=1)
        out = np.full((X.shape[0], self.n_outputs), np.nan, dtype=np.float32)
        idx = np.where(valid)[0]
        for start in range(0, len(idx), batch):
            sl = idx[start:start + batch]
            chunk = X[sl]
            pad = 0
            if len(sl) < batch and start > 0:
                # keep the jit shape stable across batches
                pad = batch - len(sl)
                chunk = np.pad(chunk, ((0, pad), (0, 0)))
            z = self._predict_logit(self.params,
                                    jnp.asarray(chunk, jnp.float32))
            y = np.asarray(sigmoid(z), dtype=np.float32)
            out[sl] = y[:len(sl)]
        return out.T.reshape(self.n_outputs, h, w)

    @partial(jax.jit, static_argnums=(0, 4))
    def _predict_quant_batches(self, params: RidgeSRParams, X: jax.Array,
                               valid: jax.Array, batch: int) -> jax.Array:
        """ONE device program for the whole cube: fori_loop over
        fixed-size pixel batches (standardise -> monomial expansion ->
        ridge matmul -> sigmoid -> u16 quantize), accumulating into a
        device-resident uint16 output. Replaces the host round-trip per
        200k-px batch of :meth:`predict_cube` for granule-scale
        products."""
        n, bx = X.shape
        by = self.n_outputs

        def body(i, out):
            x = jax.lax.dynamic_slice(X, (i * batch, 0), (batch, bx))
            v = jax.lax.dynamic_slice(valid, (i * batch,), (batch,))
            # HIGHEST: full float32 products. On the GPU, HIGH and
            # DEFAULT may run as TF32, whose ~1e-3 relative error on the
            # logit is several u16 steps after the sigmoid (dy/dz is up
            # to 2500 steps per unit logit)
            z = jnp.dot(
                self.expand((x - params.x_mean) / params.x_std),
                params.W, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST) + params.intercept
            y = sigmoid(z)
            q = jnp.clip(jnp.rint(y * 10000.0), 0.0, 65534.0).astype(
                jnp.uint16)
            q = jnp.where(v[:, None], q, jnp.uint16(65535))
            return jax.lax.dynamic_update_slice(out, q, (i * batch, 0))

        out0 = jnp.full((n, by), 65535, dtype=jnp.uint16)
        return jax.lax.fori_loop(0, n // batch, body, out0)

    def predict_cube_u16(self, X_bhw, nodata: Optional[float] = None,
                         batch_pixels: Optional[int] = None) -> np.ndarray:
        """(Bx, H, W) -> (By, H, W) uint16 x10000 (nodata 65535, the
        tiles_helpers quantization convention) computed in ONE device
        program — the granule-scale 10 m product path (Spectral_matching
        cell 8 at full scale without per-batch host round-trips)."""
        assert self.params is not None, "fit() first"
        batch = batch_pixels or self.cfg.batch_pixels
        b, h, w = X_bhw.shape
        n = h * w
        X = np.asarray(X_bhw, dtype=np.float32).reshape(b, -1).T
        valid = np.isfinite(X).all(axis=1)
        if nodata is not None:
            valid &= ~np.isclose(X, nodata).any(axis=1)
        # X is a VIEW chain onto the caller's cube when it is already
        # f32 — nan_to_num must copy or we'd zero the caller's NaNs
        X = np.nan_to_num(X, copy=True)
        n_pad = -(-n // batch) * batch
        if n_pad != n:
            X = np.pad(X, ((0, n_pad - n), (0, 0)))
            valid = np.pad(valid, (0, n_pad - n))
        q = self._predict_quant_batches(self.params, jnp.asarray(X),
                                        jnp.asarray(valid), int(batch))
        return np.asarray(q)[:n].T.reshape(self.n_outputs, h, w)

    # ---- evaluation ----

    def evaluate(self, X: np.ndarray, Y_true: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-band (R^2, RMSE) in reflectance space on the given pixels
        (Spectral_matching cell 26)."""
        y_pred = self.predict(X)
        r2, rmse = r2_rmse_per_band(
            jnp.asarray(Y_true, jnp.float32), jnp.asarray(y_pred))
        return np.asarray(r2), np.asarray(rmse)


def save_params(path, model: "RidgeSpectralSR") -> None:
    """Persist a fitted model (config + parameters) as an .npz archive —
    the checkpointing the reference never had (SURVEY.md section 5)."""
    assert model.params is not None, "fit() first"
    p = model.params
    np.savez(
        path,
        x_mean=np.asarray(p.x_mean), x_std=np.asarray(p.x_std),
        W=np.asarray(p.W), intercept=np.asarray(p.intercept),
        n_inputs=model.n_inputs, n_outputs=model.n_outputs,
        degree=model.cfg.degree, alpha=model.cfg.alpha,
        logit_eps=model.cfg.logit_eps, include_bias=model.cfg.include_bias,
        batch_pixels=model.cfg.batch_pixels,
        n_emit_bands=model.cfg.n_emit_bands,
    )


def load_params(path) -> "RidgeSpectralSR":
    z = np.load(path)
    cfg = RidgeSRConfig(
        degree=int(z["degree"]), alpha=float(z["alpha"]),
        n_emit_bands=int(z["n_emit_bands"]),
        logit_eps=float(z["logit_eps"]),
        batch_pixels=int(z["batch_pixels"]),
        include_bias=bool(z["include_bias"]),
    )
    model = RidgeSpectralSR(int(z["n_inputs"]), int(z["n_outputs"]), cfg)
    model.params = RidgeSRParams(
        jnp.asarray(z["x_mean"]), jnp.asarray(z["x_std"]),
        jnp.asarray(z["W"]), jnp.asarray(z["intercept"]))
    return model
