"""Masked pixel sampling for fusion fits.

The reference samples <= n valid pixels per side with
``np.random.default_rng(seed).choice(..., replace=False)``
(s2_emit/color.py:80-95). The host path reproduces that exactly (same
generator, same call pattern => identical samples for identical inputs);
the device path uses the Gumbel top-k trick for a fully-traced
fixed-shape sample without replacement.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def sample_valid_pixels_host(
    img: np.ndarray,
    mask: np.ndarray,
    n_samples: int,
    seed: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """(H, W, C) + (H, W) mask -> (ns, C) float64 sample, reference
    semantics: flatten masked pixels, drop non-finite rows, sample without
    replacement (color.py:80-95)."""
    rng = rng or np.random.default_rng(seed)
    X_all = img[mask].reshape(-1, img.shape[-1]).astype(np.float64)
    X_all = X_all[np.isfinite(X_all).all(axis=1)]
    if X_all.shape[0] == 0:
        return X_all
    ns = min(n_samples, X_all.shape[0])
    return X_all[rng.choice(X_all.shape[0], size=ns, replace=False)]


def sample_valid_pixels_device(
    img: jax.Array,
    mask: jax.Array,
    n_samples: int,
    key: jax.Array,
) -> Tuple[jax.Array, jax.Array]:
    """Fixed-shape device sampling: returns (sample (n_samples, C),
    weights (n_samples,)) where weights are 0 for slots beyond the number
    of valid pixels. Gumbel-top-k (exact ``lax.top_k``) gives a uniform
    sample without replacement among valid pixels."""
    c = img.shape[-1]
    flat = img.reshape(-1, c)
    # images smaller than the sample budget: take every pixel (the
    # reference's min(n, available) contract, color.py:91-95)
    n_samples = min(int(n_samples), flat.shape[0])
    valid = (mask.reshape(-1) & jnp.isfinite(flat).all(axis=-1))
    g = jax.random.gumbel(key, (flat.shape[0],))
    score = jnp.where(valid, g, -jnp.inf)
    _, idx = jax.lax.top_k(score, n_samples)
    take = jnp.take(flat, idx, axis=0)
    w = jnp.take(valid, idx).astype(jnp.float32)
    n_valid = jnp.sum(valid)
    w = w * (jnp.arange(n_samples) < n_valid)
    return take, w
