"""Single-program fused device pipelines.

The reference runs its 4-phase fusion (SRF synth -> S2 downsample ->
shared stretch + OT/poly fit -> 10 m upsample + apply; demo notebook
cell 81 == s2_emit/poly_regression.py:97-172) as separate NumPy stages.
Round 1 of this framework kept that stage structure with host
round-trips between phases; the benchmark showed that folding the whole
thing into ONE jitted XLA program removes every host round trip between
phases (XLA manages all intermediate liveness, nothing crosses PCIe).

This module makes that single program the *library* path:

- :class:`FusedFusionPlan` — phases 1-4 of ``fuse_pair`` as one jitted
  program over an EMIT cube already on the 60 m grid. This is what
  ``run_pair_pipeline`` runs (its ortho stage streams chunks through
  the fold ingest and hands the device-resident UTM cube over, so the
  raw cube never needs to sit whole in HBM);
- :class:`FusedOrthoFusionPlan` — the full raw->fused granule program
  (GLT ortho + cubic warp + fusion) for callers holding the raw cube
  on device: ``bench.py`` times exactly this plan, and the driver
  dryrun GSPMD-partitions it over the device mesh.

Plans precompute every host-side matrix once (SRF trapz weights,
separable average/bilinear resampling matrices, warp index fields); the
jitted programs are module-level with hashable static configs, so all
plan instances with the same config + shapes share one compilation.

Numerical parity notes vs the phase-wise path (``pipeline.fuse_pair``):
identical stretch/OT/fit formulas, but pixel sampling for the OT fit
uses the fixed-shape device sampler (Gumbel top-k) instead of host
``np.random.default_rng.choice`` — coefficients agree statistically,
not bitwise (both are subsample estimators of the same transport map).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import OTConfig, PolyFusionConfig
from ..core.constants import NO_DATA_VALUE
from ..core.grid import Grid
from ..kernels.lstsq import (linear_fit_masked, polyfit,
                             polyval_channels, polyval_channels_cmajor)
from ..kernels.sinkhorn import ot_barycentric_targets
from ..kernels.srf import (
    build_box_weight_matrix, build_srf_weight_matrix, srf_synthesize,
)
from ..kernels.stats import shared_percentile_stretch
from ..kernels.warp import (
    orthowarp_taploop, orthowarp_two_pass, scanline_cstar,
    select_warp_backend, separable_fast_spec, separable_index_axes,
    separable_resample_fast, separable_resample_matmul,
    separable_weight_matrix, source_index_field,
)
from .sampling import sample_valid_pixels_device

FUSED_METHODS = ("ot_poly", "ot_affine", "linear", "histogram")


class FusedUnsupported(ValueError):
    """Raised when the fused single-program path cannot express the
    requested configuration (caller should fall back to the phase-wise
    path)."""


@dataclass(frozen=True)
class FusionStatics:
    """Hashable static configuration of the fused fusion program."""

    fusion_method: str
    degree: int
    min_pixels: int
    ot: OTConfig
    pmin: float
    pmax: float
    emit_nodata: float
    s2_nodata: Optional[float]
    lin_min_count: int
    return_intermediates: bool
    # integer-aligned fast resample specs (kernels.warp
    # separable_fast_spec): (row_spec, col_spec) or None -> the dense
    # weight-matrix matmul path. The S2-anchored grid contract makes
    # both production transfers (10 m -> 60 m average, 60 m -> 10 m
    # bilinear) exact integer-ratio operations, so these are normally
    # set and the W matrices stay 1x1 dummies.
    down_fast: Optional[tuple] = None
    up_fast: Optional[tuple] = None
    # phase-4 upsample/apply array layout: "cminor" keeps (H, W, C)
    # throughout; "cmajor" runs the upsample + epilogue channel-major
    # (C, H, W) via separable_resample_fast_cmajor, transposing once at
    # the end
    up_layout: str = "cminor"


@dataclass(frozen=True)
class WarpStatics:
    """Hashable static configuration of the fused orthowarp stage."""

    warp_kernel: str     # "two_pass" | "taploop"
    resampling: str      # "cubic" | "bilinear"
    row_chunks: int
    # banded window-sharing group of the two-pass warp; None: dense
    banded_group: Optional[int] = None

    @property
    def backend(self) -> str:
        return "dense" if self.banded_group is None else "banded"


def _affine_fit_weighted(X: jax.Array, Y: jax.Array,
                         w: Optional[jax.Array]) -> Tuple[jax.Array, jax.Array]:
    """Least-squares Y ~ X @ A + t with optional 0/1 row weights
    (color.py:106-109 semantics; weights exclude padded sample slots)."""
    n = X.shape[0]
    Xa = jnp.concatenate([X, jnp.ones((n, 1), dtype=X.dtype)], axis=1)
    if w is not None:
        sw = jnp.sqrt(jnp.maximum(w.astype(X.dtype), 0.0))[:, None]
        Xa = Xa * sw
        Y = Y * sw
    W, *_ = jnp.linalg.lstsq(Xa, Y)
    return W[:-1, :], W[-1, :]


def _phase2_s2_60(st: FusionStatics, s2rgb10_hwb, Wr60, Wc60):
    """Phase-2 downsample of the real 10 m S2 onto the EMIT grid (box
    average) — shared by the fusion core and the accuracy-audit target
    program so both see bit-identical values."""
    if st.down_fast is not None and st.up_layout == "cmajor":
        from ..kernels.warp import separable_resample_fast_cmajor
        return jnp.moveaxis(separable_resample_fast_cmajor(
            jnp.moveaxis(s2rgb10_hwb, -1, 0), st.down_fast[0],
            st.down_fast[1], nodata=st.s2_nodata, fill=jnp.nan), 0, -1)
    if st.down_fast is not None:
        return separable_resample_fast(
            s2rgb10_hwb, st.down_fast[0], st.down_fast[1],
            nodata=st.s2_nodata, fill=jnp.nan)
    return separable_resample_matmul(s2rgb10_hwb, Wr60, Wc60,
                                     nodata=st.s2_nodata,
                                     fill=jnp.nan)


def _fusion_core(st: FusionStatics, cube_hwb, s2rgb10_hwb, Wsrf, Wr60,
                 Wc60, Wr10, Wc10, key) -> Dict:
    """Traced body of the 4 fusion phases (fuse_pair semantics)."""
    # Phase 1: SRF band synthesis (B2, B3, B4 at 60 m) — one matmul
    synth = srf_synthesize(cube_hwb, Wsrf, fast=True)
    valid60 = (jnp.isfinite(synth).all(axis=-1)
               & (synth[..., 0] > 0)
               & (cube_hwb[..., 0] != st.emit_nodata))
    # Phase 2: real S2 RGB box-averaged onto the EMIT grid
    s2_60 = _phase2_s2_60(st, s2rgb10_hwb, Wr60, Wc60)
    valid60 = valid60 & jnp.isfinite(s2_60).all(axis=-1)
    n_valid = jnp.sum(valid60)
    # Phase 3: shared stretch (display order B4,B3,B2) + fit.
    # NOTE: the stretch lo/hi are deliberately NOT exported from the
    # timed program; accuracy audits recompute them bit-identically in
    # the separate _audit_target_program instead.
    emit_n = shared_percentile_stretch(synth[..., ::-1], valid60,
                                       st.pmin, st.pmax)
    s2_n = shared_percentile_stretch(s2_60[..., ::-1], valid60,
                                     st.pmin, st.pmax)
    c = emit_n.shape[-1]
    if st.fusion_method in ("ot_poly", "ot_affine"):
        k1, k2 = jax.random.split(key)
        Xs, wxs = sample_valid_pixels_device(emit_n, valid60,
                                             st.ot.n_samples, k1)
        Ys, wys = sample_valid_pixels_device(s2_n, valid60,
                                             st.ot.n_samples, k2)
        # zero the padded (weight-0) slots: when n_valid < n_samples the
        # padding rows are drawn from INVALID pixels and may be NaN —
        # inside the weighted fits NaN * 0 = NaN would poison the QR
        Xs = jnp.where(wxs[:, None] > 0, Xs, 0.0)
        Ys = jnp.where(wys[:, None] > 0, Ys, 0.0)
        Ybar = ot_barycentric_targets(
            Xs, Ys, reg=st.ot.reg, num_itermax=st.ot.num_itermax,
            stop_thr=st.ot.stop_thr, wx=wxs, wy=wys,
            debias=getattr(st.ot, "debias", False))
        if st.fusion_method == "ot_poly":
            fit = jnp.stack([polyfit(Xs[:, ch], Ybar[:, ch], st.degree,
                                     w=wxs) for ch in range(c)])
            ident = jnp.zeros((c, st.degree + 1), jnp.float32)
            ident = ident.at[:, -2].set(1.0)
            # identity fallback under min_pixels (poly_regression.py:38-41)
            params = jnp.where(n_valid >= st.min_pixels, fit, ident)

            def apply(x, m):
                return polyval_channels(params, x)
        else:
            A, t = _affine_fit_weighted(
                Xs, jnp.where(wxs[:, None] > 0, Ybar, 0.0), wxs)
            A = jnp.where(n_valid >= 2, A, jnp.eye(c, dtype=A.dtype))
            t = jnp.where(n_valid >= 2, t, jnp.zeros_like(t))
            params = jnp.concatenate([A, t[None, :]], axis=0)

            def apply(x, m):
                return x @ params[:-1] + params[-1]
    elif st.fusion_method == "histogram":
        # per-channel CDF transfer against the 60 m stretched reference
        # (color.py:36-63); the 10 m product ranks its own pixels but
        # maps into the SAME 60 m reference distribution the 60 m match
        # used — consistent normalization across resolutions
        from .histogram import _match_rgb_device

        params = jnp.zeros((c, 1), jnp.float32)  # non-parametric

        def apply(x, m):
            return _match_rgb_device(x, m, s2_n, valid60)
    elif st.fusion_method == "linear":
        flat_v = valid60.reshape(-1)
        abs_ = []
        for ch in range(c):
            x = emit_n[..., ch].reshape(-1)
            y = s2_n[..., ch].reshape(-1)
            vk = (flat_v & jnp.isfinite(x) & jnp.isfinite(y)
                  & (x > 0.0) & (y > 0.0))
            a_c, b_c = linear_fit_masked(x, y, vk,
                                         min_count=st.lin_min_count)
            abs_.append(jnp.stack([a_c, b_c]))
        params = jnp.stack(abs_)  # (C, 2): a, b per channel

        def apply(x, m):
            return x * params[:, 0] + params[:, 1]
    else:  # pragma: no cover - guarded in the plan constructor
        raise FusedUnsupported(st.fusion_method)

    matched60 = jnp.clip(
        jnp.where(valid60[..., None], apply(emit_n, valid60), emit_n),
        0.0, 1.0)
    # Phase 4: bilinear upsample of the stretched sim bands to 10 m,
    # apply the same mapping there. valid60-renormalised: invalid
    # sources (NaN swaths or sentinel nodata) contribute nothing instead
    # of poisoning (NaN) or skewing (sentinel) boundary pixels; zero
    # valid mass -> NaN -> masked
    if st.up_fast is not None and st.up_layout == "cmajor":
        from ..kernels.warp import separable_resample_fast_cmajor
        sim10_cm = separable_resample_fast_cmajor(
            jnp.moveaxis(emit_n, -1, 0), st.up_fast[0], st.up_fast[1],
            fill=jnp.nan, valid_mask=valid60)
        mask10 = jnp.isfinite(sim10_cm).all(axis=0)
        sim10 = jnp.moveaxis(sim10_cm, 0, -1)
        if st.fusion_method in ("ot_poly", "linear"):
            # channel-wise maps apply directly in channel-major form
            # (full lanes); affine/histogram mix channels -> fall back
            # to the (H, W, C) apply on the transposed array
            if st.fusion_method == "ot_poly":
                val = polyval_channels_cmajor(params,
                                              jnp.nan_to_num(sim10_cm))
            else:
                val = (jnp.nan_to_num(sim10_cm)
                       * params[:, 0][:, None, None]
                       + params[:, 1][:, None, None])
            mapped_cm = jnp.clip(val, 0.0, 1.0)
            fused = jnp.moveaxis(
                jnp.where(mask10[None], mapped_cm, jnp.nan), 0, -1)
        else:
            mapped10 = jnp.clip(apply(jnp.nan_to_num(sim10), mask10),
                                0.0, 1.0)
            fused = jnp.where(mask10[..., None], mapped10, jnp.nan)
    else:
        if st.up_fast is not None:
            sim10 = separable_resample_fast(emit_n, st.up_fast[0],
                                            st.up_fast[1], fill=jnp.nan,
                                            valid_mask=valid60)
        else:
            sim10 = separable_resample_matmul(emit_n, Wr10, Wc10,
                                              fill=jnp.nan,
                                              valid_mask=valid60)
        mask10 = jnp.isfinite(sim10).all(axis=-1)
        mapped10 = jnp.clip(apply(jnp.nan_to_num(sim10), mask10),
                            0.0, 1.0)
        fused = jnp.where(mask10[..., None], mapped10, jnp.nan)
    out = {"fused_10m": fused, "matched_60m": matched60,
           "coeffs": params, "n_valid_60m": n_valid}
    if st.return_intermediates:
        out["synth_60m"] = synth
        out["s2_60m"] = s2_60
    return out


@partial(jax.jit, static_argnames=("st",))
def _fusion_program(st: FusionStatics, cube_hwb, s2rgb10_hwb, Wsrf,
                    Wr60, Wc60, Wr10, Wc10, key) -> Dict:
    return _fusion_core(st, cube_hwb, s2rgb10_hwb, Wsrf, Wr60, Wc60,
                        Wr10, Wc10, key)


@partial(jax.jit, static_argnames=("st",))
def _audit_target_program(st: FusionStatics, cube_hwb, s2rgb10_hwb,
                          Wsrf, Wr60, Wc60, Wr10, Wc10) -> jax.Array:
    """Method-ideal 10 m product built from the real S2 alone: the same
    phase-2 downsample, the same shared stretch (recomputed here with
    the same valid60 mask so it is bit-identical to the plan's — the
    timed program deliberately does not export its stretch params), and
    the same phase-4 bilinear upsample. fused_10m carries only 60 m
    spatial content by construction (demo nb cell 81 upsamples the sim
    bands), so accuracy audits compare against THIS — the 60 m
    information bottleneck applied to the truth — not the raw 10 m
    field, whose ~1.5% bilinear-interpolation residual is the method's,
    not the pipeline's. ``cube_hwb`` is the (warped) EMIT cube the plan
    consumed — e.g. ``out["utm_cube"]`` from FusedOrthoFusionPlan."""
    synth = srf_synthesize(cube_hwb, Wsrf, fast=True)
    valid60 = (jnp.isfinite(synth).all(axis=-1)
               & (synth[..., 0] > 0)
               & (cube_hwb[..., 0] != st.emit_nodata))
    s2_60 = _phase2_s2_60(st, s2rgb10_hwb, Wr60, Wc60)
    valid60 = valid60 & jnp.isfinite(s2_60).all(axis=-1)
    s2_n = shared_percentile_stretch(s2_60[..., ::-1], valid60,
                                     st.pmin, st.pmax)
    if st.up_fast is not None:
        return separable_resample_fast(s2_n, st.up_fast[0],
                                       st.up_fast[1], fill=jnp.nan,
                                       valid_mask=valid60)
    return separable_resample_matmul(s2_n, Wr10, Wc10, fill=jnp.nan,
                                     valid_mask=valid60)


@partial(jax.jit, static_argnames=("st", "warp"))
def _orthofusion_program(st: FusionStatics, warp: WarpStatics, raw_hwb,
                         flat_idx, valid, wr, wc, cstar, Wsrf, Wr60,
                         Wc60, Wr10, Wc10, s2rgb10_hwb, key) -> Dict:
    """GLT ortho + S2-anchored warp + the 4 fusion phases, one program."""
    if warp.warp_kernel == "two_pass":
        utm_cube = orthowarp_two_pass(
            raw_hwb, flat_idx, valid, wr, wc, cstar,
            method=warp.resampling, fill=NO_DATA_VALUE,
            banded_group=warp.banded_group)
    else:
        utm_cube = orthowarp_taploop(
            raw_hwb, flat_idx, valid, wr, wc, method=warp.resampling,
            fill=NO_DATA_VALUE, row_chunks=warp.row_chunks)
    out = _fusion_core(st, utm_cube, s2rgb10_hwb, Wsrf, Wr60, Wc60,
                       Wr10, Wc10, key)
    out["utm_cube"] = utm_cube
    return out


def _fusion_matrices(
    emit_grid: Grid,
    s2_grid: Grid,
    wavelengths: np.ndarray,
    good_mask: Optional[np.ndarray],
    platform: str,
    synth_method: str,
    bands: Sequence[str] = ("B2", "B3", "B4"),
    srf=None,
):
    """Host precompute shared by both plans: SRF weight matrix + the four
    separable resampling matrices between the 60 m and 10 m grids.
    ``srf`` overrides the resolver with an explicit ``{band: (nm, resp)}``
    table (measured curves, or perturbed ones for sensitivity studies)."""
    # local imports: avoids package cycle
    from ..spectral import load_srf, warn_if_parametric_srf

    if synth_method == "box":
        Wsrf, names, _ = build_box_weight_matrix(
            wavelengths, bands=list(bands), good_mask=good_mask)
    elif synth_method == "srf":
        if srf is None:
            warn_if_parametric_srf(platform, context="fusion")
            srf = load_srf(platform, bands=list(bands))
        Wsrf, names, _ = build_srf_weight_matrix(wavelengths, srf,
                                                 good_mask)
    else:
        raise FusedUnsupported(f"synth_method {synth_method!r}")

    sep_down = separable_index_axes(s2_grid, emit_grid)   # s2 -> emit 60 m
    sep_up = separable_index_axes(emit_grid, s2_grid)     # emit -> s2 10 m
    if sep_down is None or sep_up is None:
        raise FusedUnsupported(
            "fused path needs same-CRS axis-aligned grids "
            f"(emit crs {emit_grid.crs}, s2 crs {s2_grid.crs})")

    # f64 index axes for fast-spec detection (the f32 matrix-builder
    # inputs carry ~1e-3 px rounding at 10 m grid sizes, enough to
    # blur an exact phase pattern)
    def _axes64(src, dst):
        xs, ys = dst.pixel_center_coords()
        cols, _ = src.colrow_of(xs, src.y0)
        _, rows = src.colrow_of(src.x0, ys)
        return np.asarray(rows, np.float64), np.asarray(cols, np.float64)

    d64 = _axes64(s2_grid, emit_grid)
    u64 = _axes64(emit_grid, s2_grid)
    down_fast_r = separable_fast_spec(d64[0], s2_grid.height, "average",
                                      scale=emit_grid.dy / s2_grid.dy)
    down_fast_c = separable_fast_spec(d64[1], s2_grid.width, "average",
                                      scale=emit_grid.dx / s2_grid.dx)
    up_fast_r = separable_fast_spec(u64[0], emit_grid.height, "bilinear")
    up_fast_c = separable_fast_spec(u64[1], emit_grid.width, "bilinear")
    down_fast = ((down_fast_r, down_fast_c)
                 if down_fast_r is not None and down_fast_c is not None
                 else None)
    up_fast = ((up_fast_r, up_fast_c)
               if up_fast_r is not None and up_fast_c is not None
               else None)

    dummy = np.zeros((1, 1), np.float32)
    if down_fast is None:
        Wr60 = separable_weight_matrix(sep_down[0], s2_grid.height,
                                       "average",
                                       scale=emit_grid.dy / s2_grid.dy)
        Wc60 = separable_weight_matrix(sep_down[1], s2_grid.width,
                                       "average",
                                       scale=emit_grid.dx / s2_grid.dx)
    else:
        Wr60, Wc60 = dummy, dummy
    if up_fast is None:
        Wr10 = separable_weight_matrix(sep_up[0], emit_grid.height,
                                       "bilinear")
        Wc10 = separable_weight_matrix(sep_up[1], emit_grid.width,
                                       "bilinear")
    else:
        Wr10, Wc10 = dummy, dummy
    return (jnp.asarray(np.asarray(Wsrf, np.float32)), names,
            jnp.asarray(Wr60), jnp.asarray(Wc60),
            jnp.asarray(Wr10), jnp.asarray(Wc10), down_fast, up_fast)


class FusedFusionPlan:
    """Phases 1-4 of ``fuse_pair`` as one jitted device program.

    Build once per (grid pair, wavelength grid, config); call per scene.
    Inputs may be host numpy or device arrays (a device-resident EMIT
    cube from the ortho stage is consumed without a host round-trip).
    """

    def __init__(
        self,
        emit_grid: Grid,
        s2_grid: Grid,
        wavelengths: np.ndarray,
        good_mask: Optional[np.ndarray] = None,
        *,
        platform: str = "S2A",
        synth_method: str = "srf",
        fusion_method: str = "ot_poly",
        config: PolyFusionConfig = PolyFusionConfig(),
        s2_nodata: Optional[float] = None,
        s2_scale: Optional[float] = None,
        lin_min_count: int = 50,
        return_intermediates: bool = False,
        up_layout: str = "auto",
        srf=None,
    ):
        if fusion_method not in FUSED_METHODS:
            raise FusedUnsupported(
                f"fusion_method {fusion_method!r} has no fused program "
                f"(supported: {FUSED_METHODS})")
        if up_layout == "auto":
            # (H, W, C) throughout; the channel-major variant is kept for
            # an A/B on the card (parity pinned by
            # test_up_layout_cmajor_matches_cminor)
            up_layout = "cminor"
        self.emit_grid = emit_grid
        self.s2_grid = s2_grid
        self.fusion_method = fusion_method
        self.config = config
        self.s2_scale = s2_scale
        (self._Wsrf, self.band_names, self._Wr60, self._Wc60,
         self._Wr10, self._Wc10, down_fast, up_fast) = _fusion_matrices(
            emit_grid, s2_grid, np.asarray(wavelengths), good_mask,
            platform, synth_method, srf=srf)
        nod = s2_nodata
        if nod is not None and s2_scale is not None:
            nod = float(nod) * float(s2_scale)
        self.statics = FusionStatics(
            fusion_method=fusion_method, degree=config.degree,
            min_pixels=config.min_pixels, ot=config.ot,
            pmin=float(config.stretch_percentiles[0]),
            pmax=float(config.stretch_percentiles[1]),
            emit_nodata=NO_DATA_VALUE,
            s2_nodata=None if nod is None else float(nod),
            lin_min_count=lin_min_count,
            return_intermediates=return_intermediates,
            down_fast=down_fast, up_fast=up_fast,
            up_layout=up_layout)

    def prepare_s2(self, s2_stack_bhw: np.ndarray,
                   rgb_band_idx: Tuple[int, int, int] = (0, 1, 2)):
        """(B, H10, W10) stack -> scaled (H10, W10, 3) B2,B3,B4 input."""
        rgb = jnp.stack([jnp.asarray(s2_stack_bhw[i], jnp.float32)
                         for i in rgb_band_idx], axis=-1)
        if self.s2_scale is not None:
            rgb = rgb * jnp.float32(self.s2_scale)
        return rgb

    def __call__(self, emit_cube_hwb, s2_rgb10_hwb, key=None) -> Dict:
        if key is None:
            key = jax.random.PRNGKey(self.config.ot.seed)
        return _fusion_program(
            self.statics, jnp.asarray(emit_cube_hwb, jnp.float32),
            jnp.asarray(s2_rgb10_hwb, jnp.float32), self._Wsrf,
            self._Wr60, self._Wc60, self._Wr10, self._Wc10, key)

    def s2_reference_10m(self, emit_cube_hwb, s2_rgb10_hwb):
        """Accuracy-audit target (see :func:`_audit_target_program`):
        pass the SAME (warped) EMIT cube and 10 m S2 the plan consumed
        so the recomputed stretch/mask are bit-identical to the plan's
        internal ones."""
        cube = jnp.asarray(emit_cube_hwb, jnp.float32)
        s2 = jnp.asarray(s2_rgb10_hwb, jnp.float32)
        if (getattr(self, "_compiled_audit", None) is not None
                and self._compiled_audit_shapes == (cube.shape, s2.shape)):
            return self._compiled_audit(cube, s2, self._Wsrf,
                                        self._Wr60, self._Wc60,
                                        self._Wr10, self._Wc10)
        return _audit_target_program(
            self.statics, cube, s2, self._Wsrf,
            self._Wr60, self._Wc60, self._Wr10, self._Wc10)


class FusedOrthoFusionPlan:
    """The full granule program: GLT ortho + cubic warp onto the
    S2-anchored UTM grid + the 4 fusion phases, as ONE jitted program
    (``bench.py``'s pipeline as a library API; reference call stack:
    emit_proj.nc_to_envi -> demo cell 81).

    Outputs both the 285-band UTM DATA cube (for product writers) and
    the fused 10 m RGB.
    """

    def __init__(
        self,
        ortho_grid: Grid,
        utm_grid: Grid,
        s2_grid: Grid,
        raw_shape_yx: Tuple[int, int],
        glt: np.ndarray,
        wavelengths: np.ndarray,
        good_mask: Optional[np.ndarray] = None,
        *,
        platform: str = "S2A",
        synth_method: str = "srf",
        fusion_method: str = "ot_poly",
        config: PolyFusionConfig = PolyFusionConfig(),
        s2_nodata: Optional[float] = None,
        s2_scale: Optional[float] = None,
        warp_kernel: str = "auto",
        resampling: str = "cubic",
        orthowarp_row_chunks: int = 64,
        return_intermediates: bool = False,
        up_layout: str = "auto",
        srf=None,
    ):
        from ..kernels.glt import prepare_glt

        self.utm_grid = utm_grid
        self.s2_grid = s2_grid
        flat_idx, valid = prepare_glt(np.asarray(glt), raw_shape_yx)
        self._flat = jnp.asarray(flat_idx)
        self._valid = jnp.asarray(valid)
        wr, wc = source_index_field(ortho_grid, utm_grid)
        self._wr = jnp.asarray(wr)
        self._wc = jnp.asarray(wc)
        # warp_kernel: "auto" (banded two-pass where the geometry allows,
        # dense two-pass otherwise), "banded", "two_pass" (dense) or
        # "taploop"
        cstar_np = (scanline_cstar(wr, wc, ortho_grid.height)
                    if warp_kernel in ("two_pass", "auto", "banded")
                    else None)
        banded_group = None
        if warp_kernel in ("auto", "banded"):
            _, banded_group = select_warp_backend(cstar_np, wr, warp_kernel)
            warp_kernel = "two_pass"
        self.warp_statics = WarpStatics(
            warp_kernel=warp_kernel, resampling=resampling,
            row_chunks=orthowarp_row_chunks, banded_group=banded_group)
        self._cstar = (jnp.asarray(cstar_np) if cstar_np is not None
                       else jnp.zeros((1, 1), jnp.float32))
        self._fusion = FusedFusionPlan(
            utm_grid, s2_grid, wavelengths, good_mask,
            platform=platform, synth_method=synth_method,
            fusion_method=fusion_method, config=config,
            s2_nodata=s2_nodata, s2_scale=s2_scale,
            return_intermediates=return_intermediates,
            up_layout=up_layout, srf=srf)

    @property
    def statics(self) -> FusionStatics:
        return self._fusion.statics

    def prepare_s2(self, s2_stack_bhw: np.ndarray,
                   rgb_band_idx: Tuple[int, int, int] = (0, 1, 2)):
        return self._fusion.prepare_s2(s2_stack_bhw, rgb_band_idx)

    def s2_reference_10m(self, utm_cube_hwb, s2_rgb10_hwb):
        """Audit target from a plan call's ``out["utm_cube"]`` + the
        same prepared 10 m S2 input."""
        return self._fusion.s2_reference_10m(utm_cube_hwb,
                                             s2_rgb10_hwb)

    def precompile(self, raw_shape_hwb, s2_shape_hw3,
                   audit: bool = True):
        """AOT-compile the full program (and optionally the accuracy
        audit target) from SHAPES alone — no granule bytes, no HBM
        allocation. Needs only the plan's host-precomputed matrices, so
        it can run on a background thread CONCURRENTLY with the input
        ingest stream (cold-start wall = max(compile, ingest) instead
        of their sum). Compiles go through
        the persistent compilation cache, so a warm repeat process
        pays only the executable load. Subsequent ``__call__`` /
        ``s2_reference_10m`` with matching shapes dispatch to the AOT
        executables (same math, same statics — and one stable cache
        key across processes instead of the dispatch path's
        layout-sensitive variant). Returns the compiled main program
        (for ``memory_analysis()`` and the like)."""
        f = self._fusion
        raw_sds = jax.ShapeDtypeStruct(tuple(raw_shape_hwb), jnp.float32)
        s2_sds = jax.ShapeDtypeStruct(tuple(s2_shape_hw3), jnp.float32)
        key_sds = jax.ShapeDtypeStruct((2,), jnp.uint32)
        self._compiled = _orthofusion_program.lower(
            f.statics, self.warp_statics, raw_sds, self._flat,
            self._valid, self._wr, self._wc, self._cstar, f._Wsrf,
            f._Wr60, f._Wc60, f._Wr10, f._Wc10, s2_sds,
            key_sds).compile()
        self._compiled_shapes = (tuple(raw_shape_hwb),
                                 tuple(s2_shape_hw3))
        if audit:
            utm_sds = jax.ShapeDtypeStruct(
                (self.utm_grid.height, self.utm_grid.width,
                 raw_shape_hwb[-1]), jnp.float32)
            f._compiled_audit = _audit_target_program.lower(
                f.statics, utm_sds, s2_sds, f._Wsrf, f._Wr60, f._Wc60,
                f._Wr10, f._Wc10).compile()
            f._compiled_audit_shapes = (utm_sds.shape, tuple(s2_shape_hw3))
        return self._compiled

    def __call__(self, raw_hwb, s2_rgb10_hwb, key=None) -> Dict:
        if key is None:
            key = jax.random.PRNGKey(self._fusion.config.ot.seed)
        f = self._fusion
        raw = jnp.asarray(raw_hwb, jnp.float32)
        s2 = jnp.asarray(s2_rgb10_hwb, jnp.float32)
        if (getattr(self, "_compiled", None) is not None
                and self._compiled_shapes == (raw.shape, s2.shape)):
            return self._compiled(
                raw, self._flat, self._valid, self._wr, self._wc,
                self._cstar, f._Wsrf, f._Wr60, f._Wc60, f._Wr10,
                f._Wc10, s2, jnp.asarray(key, jnp.uint32))
        return _orthofusion_program(
            f.statics, self.warp_statics, raw, self._flat, self._valid,
            self._wr, self._wc, self._cstar, f._Wsrf, f._Wr60, f._Wc60,
            f._Wr10, f._Wc10, s2, key)
