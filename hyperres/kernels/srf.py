"""SRF band synthesis as a band-mixing matmul.

The reference computes, per S2 band, ``trapz(R * rsp, x=lambda) /
trapz(rsp, x=lambda)`` over the 285-band axis (s2_emit/synth.py:9-45).
Both integrals are linear in R, so the whole 13-band synthesis collapses
into one (H*W, B) @ (B, S) matmul — precompute the trapezoid weight
matrix once on the host, then a single MXU-friendly contraction on
device. The box-integral variant (demo notebook cell 58) produces a
weight matrix for the same kernel.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.constants import NO_DATA_VALUE

# {band: (lambda_nm, response)} — the reference's SRF dict contract
SRFDict = Dict[str, Tuple[np.ndarray, np.ndarray]]


def trapezoid_weights(x: np.ndarray) -> np.ndarray:
    """w such that trapz(y, x) == w @ y."""
    x = np.asarray(x, dtype=np.float64)
    w = np.zeros_like(x)
    dx = np.diff(x)
    w[:-1] += dx / 2.0
    w[1:] += dx / 2.0
    return w


def build_srf_weight_matrix(
    emit_wl: np.ndarray,
    srf: SRFDict,
    good_mask: Optional[np.ndarray] = None,
    bands: Optional[Sequence[str]] = None,
) -> Tuple[np.ndarray, List[str], np.ndarray]:
    """(B, S) float32 weight matrix W with ``synth = R @ W``, matching the
    reference integral exactly (synth.py:32-43): SRF interpolated onto the
    EMIT wavelengths (0 outside support), optional good-band mask, and
    normalisation by trapz of the interpolated response. Returns
    (W, band_names, band_valid) where band_valid[s] is False when the SRF
    misses the EMIT range (the reference returns None there)."""
    emit_wl = np.asarray(emit_wl, dtype=np.float64)
    tw = trapezoid_weights(emit_wl)
    names = list(bands) if bands is not None else list(srf.keys())
    cols = []
    valid = []
    for b in names:
        lam, rsp = srf[b]
        rsp_on = np.interp(emit_wl, lam, rsp, left=0.0, right=0.0)
        if good_mask is not None:
            rsp_on = rsp_on * np.asarray(good_mask, dtype=np.float64)
        if np.all(rsp_on == 0.0):
            cols.append(np.zeros_like(emit_wl))
            valid.append(False)
            continue
        den = float(tw @ rsp_on)
        cols.append(tw * rsp_on / (den + 1e-32))
        valid.append(True)
    W = np.stack(cols, axis=1).astype(np.float32)
    return W, names, np.asarray(valid, dtype=bool)


def build_box_weight_matrix(
    emit_wl: np.ndarray,
    box_table: Optional[Dict[str, Tuple[float, float]]] = None,
    good_mask: Optional[np.ndarray] = None,
    bands: Optional[Sequence[str]] = None,
) -> Tuple[np.ndarray, List[str], np.ndarray]:
    """Weight matrix for the rectangular band-pass variant
    (demo notebook cell 58): trapz over EMIT samples inside
    [centre - bw/2, centre + bw/2], normalised by (w[-1] - w[0]). Bands
    with < 2 samples in range are invalid (reference returns None)."""
    if box_table is None:
        from ..spectral.srf_tables import S2_BOX_TABLE
        box_table = S2_BOX_TABLE
    emit_wl = np.asarray(emit_wl, dtype=np.float64)
    names = list(bands) if bands is not None else list(box_table.keys())
    gm = (np.asarray(good_mask, dtype=bool) if good_mask is not None
          else np.ones_like(emit_wl, dtype=bool))
    cols = []
    valid = []
    for b in names:
        centre, bw = box_table[b]
        m = (emit_wl >= centre - bw / 2.0) & (emit_wl <= centre + bw / 2.0) & gm
        idx = np.where(m)[0]
        col = np.zeros_like(emit_wl)
        if len(idx) < 2:
            cols.append(col)
            valid.append(False)
            continue
        sub_w = trapezoid_weights(emit_wl[idx])
        den = emit_wl[idx][-1] - emit_wl[idx][0]
        col[idx] = sub_w / den
        cols.append(col)
        valid.append(True)
    W = np.stack(cols, axis=1).astype(np.float32)
    return W, names, np.asarray(valid, dtype=bool)


@partial(jax.jit, static_argnames=("fill_value", "fast"))
def srf_synthesize(cube_hwb: jax.Array, weights_bs: jax.Array,
                   valid_mask: Optional[jax.Array] = None,
                   fill_value: float = NO_DATA_VALUE,
                   fast: bool = False) -> jax.Array:
    """(H, W, B) x (B, S) -> (H, W, S) as one matmul. ``valid_mask``
    (H, W) optionally masks nodata pixels to ``fill_value``.

    ``fast=False`` forces full float32 products (``Precision.HIGHEST``)
    for parity with the NumPy trapz oracle; ``fast=True`` uses
    ``Precision.DEFAULT``, which on the GPU may run as TF32 (~1e-3
    relative) — the fused programs' choice, since the synthesized bands
    only feed the percentile stretch and the fit sample."""
    h, w, b = cube_hwb.shape
    flat = cube_hwb.reshape(-1, b)
    precision = (jax.lax.Precision.DEFAULT if fast
                 else jax.lax.Precision.HIGHEST)
    out = jnp.dot(flat, weights_bs, preferred_element_type=jnp.float32,
                  precision=precision)
    out = out.reshape(h, w, weights_bs.shape[1])
    if valid_mask is not None:
        out = jnp.where(valid_mask[..., None], out,
                        jnp.asarray(fill_value, dtype=out.dtype))
    return out


def pseudo_s2_srf_integral(
    R: np.ndarray,
    emit_w: np.ndarray,
    srf_dict: SRFDict,
    good_mask: Optional[np.ndarray] = None,
) -> Dict[str, Optional[np.ndarray]]:
    """Drop-in API parity with the reference (s2_emit/synth.py:9-45):
    returns {band: (H, W) array or None}, computed on device."""
    W, names, valid = build_srf_weight_matrix(emit_w, srf_dict, good_mask)
    synth = np.asarray(srf_synthesize(jnp.asarray(R, dtype=jnp.float32),
                                      jnp.asarray(W)))
    out: Dict[str, Optional[np.ndarray]] = {}
    for s, name in enumerate(names):
        out[name] = synth[..., s] if valid[s] else None
    return out


def pseudo_s2_rgb(pseudo_s2: Dict[str, Optional[np.ndarray]],
                  order=("B4", "B3", "B2")) -> np.ndarray:
    """(H, W, 3) RGB stack from the synthesis dict (synth.py:47-58)."""
    chans = []
    for b in order:
        x = pseudo_s2.get(b)
        if x is None:
            raise ValueError(f"Band {b} is None/missing in pseudo_s2.")
        chans.append(x)
    return np.stack(chans, axis=-1)
