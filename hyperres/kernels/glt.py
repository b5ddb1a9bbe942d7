"""GLT orthorectification gather — the hottest op in the pipeline.

The reference gathers 32-band slabs through fancy indexing on the host
(EMIT_data/emit_proj.py:969-987, the gather itself at :982, canonical
semantics in emit_tools.py:153-181). Here the whole cube is gathered in
one vectorized XLA op over the HBM-resident cube: GLT -> flat row indices
once, a single ``take`` along the flattened raw-pixel axis (the spectral
axis stays minor, so each gather row is a contiguous 285-float read), and
a ``where`` for the nodata fill. No band chunking: chunking was a host-RAM
workaround, not a device constraint.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.constants import GLT_NODATA_VALUE, NO_DATA_VALUE


def prepare_glt(glt: np.ndarray, raw_shape_yx: Tuple[int, int]
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side precompute: 1-based GLT (H, W, 2) -> (flat_idx, valid).

    flat_idx is int32 (H, W) of 0-based row indices into the flattened
    (raw_h * raw_w) pixel axis (0 where invalid — masked later), valid is
    bool (H, W). Out-of-bounds entries are dropped like the reference
    (emit_proj.py:698-703)."""
    raw_h, raw_w = raw_shape_yx
    glt = np.asarray(glt)
    valid = np.all(glt != GLT_NODATA_VALUE, axis=-1)
    gx = glt[..., 0].astype(np.int64) - 1
    gy = glt[..., 1].astype(np.int64) - 1
    in_bounds = (gy >= 0) & (gy < raw_h) & (gx >= 0) & (gx < raw_w)
    valid = valid & in_bounds
    flat = np.where(valid, gy * raw_w + gx, 0).astype(np.int32)
    return flat, valid


@partial(jax.jit, static_argnames=("fill_value",))
def glt_gather(raw_hwb: jax.Array, flat_idx: jax.Array, valid: jax.Array,
               fill_value: float = NO_DATA_VALUE) -> jax.Array:
    """Device gather: raw (raw_h, raw_w, B) + flat_idx/valid (H, W)
    -> ortho (H, W, B)."""
    b = raw_hwb.shape[-1]
    flat_raw = raw_hwb.reshape(-1, b)
    gathered = jnp.take(flat_raw, flat_idx.reshape(-1), axis=0)
    gathered = gathered.reshape(flat_idx.shape + (b,))
    return jnp.where(valid[..., None], gathered,
                     jnp.asarray(fill_value, dtype=raw_hwb.dtype))


def orthorectify(raw_hwb, glt, fill_value: float = NO_DATA_VALUE):
    """Convenience: full reference-semantics ortho (host GLT prep +
    device gather). Accepts numpy or jax arrays."""
    flat, valid = prepare_glt(np.asarray(glt),
                              (raw_hwb.shape[0], raw_hwb.shape[1]))
    return glt_gather(jnp.asarray(raw_hwb), jnp.asarray(flat),
                      jnp.asarray(valid), fill_value=fill_value)
