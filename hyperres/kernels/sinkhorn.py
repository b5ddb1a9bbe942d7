"""Entropic optimal transport (Sinkhorn) on device.

Replaces POT's compiled ``ot.dist`` + ``ot.sinkhorn``
(s2_emit/color.py:100-104, s2_emit/poly_regression.py:52-56) with a
log-domain, fixed-shape implementation:

- the cost matrix is a single matmul (||x||^2 + ||y||^2 - 2 x.y),
- iterations run in a ``lax.while_loop`` with the same stopping rule as
  POT (marginal violation < stop_thr, checked every 10 iterations, capped
  at num_itermax),
- log-sum-exp stabilisation keeps f32 well-behaved where POT's
  linear-domain scaling relies on f64.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=())
def sqeuclidean_cdist(X: jax.Array, Y: jax.Array) -> jax.Array:
    """Pairwise squared Euclidean distances, (n, d) x (m, d) -> (n, m) —
    ot.dist(metric='sqeuclidean') equivalent, as one matmul."""
    xx = jnp.sum(X * X, axis=1, keepdims=True)
    yy = jnp.sum(Y * Y, axis=1, keepdims=True)
    cross = jnp.dot(X, Y.T, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    return jnp.maximum(xx + yy.T - 2.0 * cross, 0.0)


@partial(jax.jit, static_argnames=("num_itermax", "check_every"))
def sinkhorn_log(a: jax.Array, b: jax.Array, M: jax.Array, reg: float,
                 num_itermax: int = 300, stop_thr: float = 1e-6,
                 check_every: int = 10) -> Tuple[jax.Array, jax.Array]:
    """Log-domain Sinkhorn. Returns (P, err) where P is the transport plan
    with marginals ~(a, b) and err the final column-marginal violation."""
    log_a = jnp.log(a)
    log_b = jnp.log(b)
    Mr = -M / reg

    def lse_rows(f, g):
        # logsumexp over columns of Mr + f[:,None] + g[None,:]
        z = Mr + f[:, None] + g[None, :]
        return jax.scipy.special.logsumexp(z, axis=1)

    def lse_cols(f, g):
        z = Mr + f[:, None] + g[None, :]
        return jax.scipy.special.logsumexp(z, axis=0)

    def cond(state):
        i, f, g, err = state
        return (i < num_itermax) & (err > stop_thr)

    def body(state):
        i, f, g, _ = state

        def step(carry, _):
            f, g = carry
            f = f + log_a - lse_rows(f, g)
            g = g + log_b - lse_cols(f, g)
            return (f, g), None

        (f, g), _ = jax.lax.scan(step, (f, g), None, length=check_every)
        # marginal violation on columns (POT checks the b-marginal)
        col = jnp.exp(lse_cols(f, g))
        err = jnp.linalg.norm(col - b, ord=1)
        return i + check_every, f, g, err

    f0 = jnp.zeros_like(log_a)
    g0 = jnp.zeros_like(log_b)
    i, f, g, err = jax.lax.while_loop(
        cond, body, (jnp.asarray(0), f0, g0, jnp.asarray(jnp.inf)))
    P = jnp.exp(Mr + f[:, None] + g[None, :])
    return P, err


@jax.jit
def barycentric_map(P: jax.Array, Y: jax.Array) -> jax.Array:
    """Row-normalised barycentric projection (P @ Y) / rowsum —
    color.py:103-104."""
    row_sum = jnp.sum(P, axis=1, keepdims=True) + 1e-32
    return jnp.dot(P, Y, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST) / row_sum


@partial(jax.jit, static_argnames=("num_itermax", "debias"))
def ot_barycentric_targets(X: jax.Array, Y: jax.Array, reg: float = 0.05,
                           num_itermax: int = 300,
                           stop_thr: float = 1e-6,
                           wx: jax.Array | None = None,
                           wy: jax.Array | None = None,
                           debias: bool = False) -> jax.Array:
    """End-to-end: Sinkhorn between samples X (n, d) and Y (m, d), then
    barycentric targets for each X row (the shared core of ot_match_rgb /
    fit_ot_poly / fit_ot_affine). ``wx`` / ``wy`` are optional 0/1 slot
    weights from fixed-shape device sampling: zero-weight (padding) rows
    get a vanishing mass (and their values are zeroed so non-finite
    padding cannot poison the cost matrix), keeping the plan equal to the
    uniform plan over the real samples to f32 accuracy.

    ``debias=True`` applies the Sinkhorn-divergence shrinkage
    correction: entropic OT's barycentric map contracts targets toward
    Y's mean (the documented ~15 dB pipeline-vs-method PSNR gap is this
    blur, faithful to POT's behavior at the same reg). The debiased map
    subtracts the SELF-transport's contraction measured on X itself,
    T_debias(x) = T_XY(x) + (x - T_XX(x)) — exact to first order in
    reg, identity-preserving when Y = X; reference behavior stays the
    default (s2_emit/color.py:100-104 has no debiasing). Costs one
    extra (n, n) Sinkhorn."""
    n, m = X.shape[0], Y.shape[0]
    if wx is None:
        a = jnp.full((n,), 1.0 / n, dtype=jnp.float32)
    else:
        X = jnp.where(wx[:, None] > 0, X, 0.0)
        aw = jnp.maximum(wx.astype(jnp.float32), 1e-12)
        a = aw / jnp.sum(aw)
    if wy is None:
        b = jnp.full((m,), 1.0 / m, dtype=jnp.float32)
    else:
        Y = jnp.where(wy[:, None] > 0, Y, 0.0)
        bw = jnp.maximum(wy.astype(jnp.float32), 1e-12)
        b = bw / jnp.sum(bw)
    M = sqeuclidean_cdist(X, Y)
    P, _ = sinkhorn_log(a, b, M, reg, num_itermax=num_itermax,
                        stop_thr=stop_thr)
    T_xy = barycentric_map(P, Y)
    if not debias:
        return T_xy
    # self-transport at the same reg: its barycentric map measures the
    # entropic contraction on X's own geometry; adding (X - T_XX)
    # restores the spread the X->Y map lost to the same blur
    Mxx = sqeuclidean_cdist(X, X)
    Pxx, _ = sinkhorn_log(a, a, Mxx, reg, num_itermax=num_itermax,
                          stop_thr=stop_thr)
    T_xx = barycentric_map(Pxx, X)
    return T_xy + (X - T_xx)
