"""Benchmark: full EMIT granule ortho + SRF synthesis + OT/poly fusion
to 10 m on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", ...} where value is
the end-to-end device pipeline wall-clock (after compilation, min of
runs), beside the device it ran on (platform, device_kind,
device_count, the card's name and power limit). It exits non-zero off
a GPU: there is no CPU fallback.

The timed program is the SHIPPED library pipeline —
``hyperres.fusion.fused.FusedOrthoFusionPlan`` — not a bench-private
twin: GLT ortho + cubic warp onto the S2-anchored UTM grid, SRF
synthesis, real-S2 average downsample to 60 m (phase 2), validity
intersection, shared stretch, Sinkhorn OT (5000x5000, reg 0.05) with
weighted degree-4 polynomial fit, bilinear upsample + apply at 10 m.
``tests/test_bench_workload.py`` runs this same workload builder at
reduced scale in CI and checks it against the phase-wise reference
path.

Scene: synthetic full-granule scale (raw 1242x1280x285, the implied
real EMIT granule size, SURVEY.md section 6) generated in memory,
including the real 10 m Sentinel-2 RGB input (uint16 DN, the production
wire format) that phase 2 consumes.

Environment knobs: HYPERRES_BENCH_SCALE (default 1.0) scales the raw
granule dims for quick smoke runs; HYPERRES_BENCH_WARP ("auto" default:
banded two-pass where the geometry allows, dense otherwise; also
"banded", "two_pass", "taploop"); HYPERRES_BENCH_RUNS (default 3,
min-of-N); HYPERRES_BENCH_TRANSFER (u16 default | u12 | f32 raw-cube
ingest); HYPERRES_BENCH_PSNR_GATE / HYPERRES_BENCH_SAM_GATE /
HYPERRES_BENCH_METHOD_PSNR_GATE tune the accuracy gates (defaults
45 dB / 0.01 rad / 28 dB).
"""

import json
import os
import pickle
import sys
import time

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


# bump when the scene generator changes so stale caches don't survive
_SCENE_VERSION = 1
_SCENE_KEYS = ("raw", "s2_dn", "wavelengths", "good_mask", "spectra",
               "ortho_grid", "utm60", "s2_grid", "glt")


def _scene_cache_path(scale: float, seed: int) -> str:
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     ".benchcache")
    return os.path.join(d, f"scene_v{_SCENE_VERSION}_s{scale}_r{seed}.pkl")


def _load_scene(scale: float, seed: int):
    p = _scene_cache_path(scale, seed)
    if not os.path.exists(p):
        return None
    try:
        with open(p, "rb") as f:
            sc = pickle.load(f)
        return sc if all(k in sc for k in _SCENE_KEYS) else None
    except Exception:
        return None


def _save_scene(scale: float, seed: int, scene: dict) -> None:
    p = _scene_cache_path(scale, seed)
    try:
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p + ".tmp", "wb") as f:
            pickle.dump(scene, f, protocol=5)
        os.replace(p + ".tmp", p)
    except Exception as e:  # cache is best-effort (disk pressure etc.)
        log(f"scene cache write skipped: {e}")


def build_workload(scale: float = 1.0, warp_kernel: str = "two_pass",
                   seed: int = 0, config=None, scene_cache: bool = False):
    """Synthesize the full-granule bench scene and build the SHIPPED
    pipeline plan over it.

    Returns a dict with the plan (FusedOrthoFusionPlan), the host raw
    cube, the 10 m S2 RGB stack as uint16 DN (scale 1e-4, nodata 65535
    — the reference's download format, s2_data/s2_utils.py:505-614),
    and the three grids. Importable by CI tests so the benched program
    and the tested program are the same object.

    ``scene_cache=True`` memoizes the (deterministic) generated scene
    under ``.benchcache/`` — scene synthesis is minutes of single-core
    host NumPy at full scale, pure waste on repeat runs.
    """
    from hyperres.core.config import OTConfig, PolyFusionConfig

    if config is None and os.environ.get("HYPERRES_BENCH_OT_DEBIAS"):
        # A/B knob for the Sinkhorn-divergence shrinkage correction
        # (reference parity stays the default)
        config = PolyFusionConfig(ot=OTConfig(debias=True))
    scene = _load_scene(scale, seed) if scene_cache else None
    if scene is None:
        scene = _generate_scene(scale, seed)
        if scene_cache:
            _save_scene(scale, seed, scene)
    return dict(scene, plan=plan_for_scene(scene, warp_kernel, config))


def plan_for_scene(scene: dict, warp_kernel: str = "two_pass",
                   config=None):
    """The shipped FusedOrthoFusionPlan over a bench scene (another
    warp kernel over the same scene needs no new scene)."""
    from hyperres.core.config import PolyFusionConfig
    from hyperres.fusion.fused import FusedOrthoFusionPlan

    raw_h, raw_w = scene["raw"].shape[:2]
    return FusedOrthoFusionPlan(
        scene["ortho_grid"], scene["utm60"], scene["s2_grid"],
        (raw_h, raw_w), scene["glt"], scene["wavelengths"],
        scene["good_mask"], s2_nodata=65535.0, s2_scale=1e-4,
        warp_kernel=warp_kernel,
        up_layout=os.environ.get("HYPERRES_BENCH_UP_LAYOUT", "auto"),
        config=config if config is not None else PolyFusionConfig())


def scene_geometry(scale: float = 1.0) -> dict:
    """The bench scene's swath geometry alone (no cube, no S2 pixels):
    the raw dims, the geographic ortho grid, its 1-based GLT, the 10 m
    S2 grid covering the swath and the S2-anchored UTM 60 m grid, plus
    the UTM coordinates of every raw pixel (``rx``, ``ry``)."""
    from hyperres.core.crs import CRS
    from hyperres.core.grid import Grid, s2_anchored_target_grid

    raw_h = max(64, int(1242 * scale))
    raw_w = max(64, int(1280 * scale))
    utm = CRS.utm(33, True)
    # swath geometry like the scene factory, sized to the raw dims
    cx, cy = 450000.0, 5770000.0
    th = np.radians(13.0)

    rows, cols = np.meshgrid(np.arange(raw_h), np.arange(raw_w),
                             indexing="ij")
    u = (cols - raw_w / 2.0) * 60.0
    v = -(rows - raw_h / 2.0) * 60.0
    rx = cx + u * np.cos(th) - v * np.sin(th)
    ry = cy + u * np.sin(th) + v * np.cos(th)

    lon, lat = utm.to_geographic(rx, ry)
    res_x = 60.0 / 111320.0 / np.cos(np.radians(float(lat.mean())))
    res_y = 60.0 / 111320.0
    lon0 = float(lon.min()) - res_x
    lat0 = float(lat.max()) + res_y
    ow = int(np.ceil((float(lon.max()) + res_x - lon0) / res_x))
    oh = int(np.ceil((lat0 - (float(lat.min()) - res_y)) / res_y))
    ortho_grid = Grid(CRS.geographic(), lon0, lat0, res_x, res_y, ow, oh)

    # GLT (1-based) for the ortho grid
    oxs, oys = ortho_grid.pixel_center_coords()
    olon, olat = np.meshgrid(oxs, oys)
    oux, ouy = utm.from_geographic(olon, olat)
    du = (oux - cx) * np.cos(th) + (ouy - cy) * np.sin(th)
    dv = -(oux - cx) * np.sin(th) + (ouy - cy) * np.cos(th)
    ci = np.round(du / 60.0 + raw_w / 2.0).astype(np.int64)
    ri = np.round(-dv / 60.0 + raw_h / 2.0).astype(np.int64)
    inside = (ri >= 0) & (ri < raw_h) & (ci >= 0) & (ci < raw_w)
    glt = np.zeros((oh, ow, 2), dtype=np.int32)
    glt[..., 0] = np.where(inside, ci + 1, 0)
    glt[..., 1] = np.where(inside, ri + 1, 0)

    # S2 grid covering the swath (10 m, origin on the 60 m lattice)
    sw_l = float(oux.min())
    sw_t = float(ouy.max())
    s2_x0 = np.floor(sw_l / 60.0) * 60.0
    s2_y0 = np.ceil(sw_t / 60.0) * 60.0
    s2_w = int((float(oux.max()) - s2_x0) // 10.0)
    s2_h = int((s2_y0 - float(ouy.min())) // 10.0)
    s2_grid = Grid(utm, s2_x0, s2_y0, 10.0, 10.0, s2_w, s2_h)
    utm60 = s2_anchored_target_grid(ortho_grid, s2_grid, 60.0, 60.0)
    return {"raw_shape": (raw_h, raw_w), "rx": rx, "ry": ry,
            "ortho_grid": ortho_grid, "glt": glt, "s2_grid": s2_grid,
            "utm60": utm60}


def _generate_scene(scale: float, seed: int) -> dict:
    from hyperres.kernels.srf import build_srf_weight_matrix
    from hyperres.spectral import builtin_srf
    from hyperres.testing import scenes

    rng = np.random.default_rng(seed)
    geo = scene_geometry(scale)
    raw_h, raw_w = geo["raw_shape"]
    s2_grid = geo["s2_grid"]
    s2_h, s2_w = s2_grid.height, s2_grid.width
    n_bands = 285

    wl, good = scenes.emit_wavelength_grid(n_bands)
    spectra = scenes.endmember_spectra(wl)

    # f32 accumulation: the f64 matmul product + full-cube f64 noise +
    # their sum would peak ~11 GB host RSS at full scale
    a = scenes.abundance_maps(geo["rx"], geo["ry"]).astype(np.float32)
    raw = a @ spectra.astype(np.float32)
    del a
    noise = rng.standard_normal(size=(raw_h, raw_w, n_bands),
                                dtype=np.float32)
    noise *= np.float32(0.002)
    raw += noise
    del noise
    np.clip(raw, 0.005, 0.95, out=raw)

    # real S2 RGB at 10 m (B2, B3, B4): the world convolved with the
    # S2 SRFs, delivered as uint16 DN at scale 1e-4 — the format the
    # production pipeline ingests. The world's abundance fields are
    # band-limited below 0.9 cycles/km (period >= 1.1 km), so sampling
    # them on a 30 m lattice and bilinearly refining to 10 m is exact to
    # visual/statistical purposes and ~9x cheaper than evaluating 85 Mpx
    # of sinusoids (full-scale setup was minutes-dominated by this).
    srf3 = builtin_srf("S2A", bands=["B2", "B3", "B4"])
    W3, _, _ = build_srf_weight_matrix(wl, srf3, good)
    band_spec = (spectra @ np.asarray(W3)).astype(np.float32)  # (K, 3)
    f = 3  # 30 m coarse lattice in 10 m pixel units
    cj = np.arange(0, s2_w + f, f)
    ci = np.arange(0, s2_h + f, f)
    cX = s2_grid.x0 + (cj + 0.5) * s2_grid.dx
    cY = s2_grid.y0 - (ci + 0.5) * s2_grid.dy
    CX, CY = np.meshgrid(cX, cY)
    a_c = scenes.abundance_maps(CX, CY).astype(np.float32)
    rgb_c = np.clip(a_c @ band_spec, 0.0, 1.0)  # (Ci, Cj, 3)
    jj = np.arange(s2_w, dtype=np.float64) / f
    j0 = np.floor(jj).astype(np.int64)
    tj = (jj - j0).astype(np.float32)[None, :, None]
    ii = np.arange(s2_h, dtype=np.float64) / f
    i0 = np.floor(ii).astype(np.int64)
    ti = (ii - i0).astype(np.float32)[:, None, None]
    rows_interp = (rgb_c[i0] * (1.0 - ti) + rgb_c[i0 + 1] * ti)
    rgb10 = (rows_interp[:, j0] * (1.0 - tj)
             + rows_interp[:, j0 + 1] * tj)
    s2_dn = np.moveaxis(
        np.clip(np.rint(rgb10 * 10000.0), 0, 65534), -1, 0
    ).astype(np.uint16)
    del rgb_c, rows_interp, rgb10

    return {
        "raw": raw,
        "s2_dn": s2_dn,
        "wavelengths": wl,
        "good_mask": good,
        "spectra": spectra,
        "ortho_grid": geo["ortho_grid"],
        "utm60": geo["utm60"],
        "s2_grid": s2_grid,
        "glt": geo["glt"],
    }


_METRIC_NAME = "emit_granule_ortho_srf_fusion_to_10m"


def accuracy_metrics(fused, target, coeffs):
    """Device-side accuracy of one plan output against the method-ideal
    target (``plan.s2_reference_10m``): returns (finite fraction, max
    value, pipeline PSNR, method PSNR, SAM) as device scalars.

    - pipeline PSNR/SAM: fused vs the FITTED coeffs applied to the
      target — the OT+poly map is shared so it cancels, isolating
      ortho/SRF/ingest/upsample correctness.
    - method PSNR: fused vs the target directly — includes the
      entropic-Sinkhorn shrinkage inherent to the reference's
      OT(reg=0.05)+poly method; a broken fit that the pipeline tier
      cannot see (it cancels the map) drops this far below its gate.
    (Raw 10 m truth is NOT the target: fused_10m carries only 60 m
    spatial content by construction — demo nb cell 81 upsamples the sim
    bands — so that comparison measures the method's bilinear
    smoothing, not pipeline health.)"""
    import jax.numpy as jnp

    from hyperres.kernels.lstsq import polyval_channels
    from hyperres.kernels.stats import erode_mask

    vf = jnp.isfinite(fused).all(axis=-1)
    valid = vf & jnp.isfinite(target).all(axis=-1)
    e = erode_mask(valid, 2)
    n = jnp.maximum(jnp.sum(e), 1)
    mapped = jnp.clip(polyval_channels(coeffs, jnp.nan_to_num(target)),
                      0.0, 1.0)

    def psnr_vs(ref):
        diff = jnp.where(e[..., None], fused - ref, 0.0)
        mse = jnp.sum(diff * diff) / (n * fused.shape[-1])
        return 10.0 * jnp.log10(1.0 / mse)

    num = jnp.sum(fused * mapped, axis=-1)
    den = (jnp.linalg.norm(fused, axis=-1)
           * jnp.linalg.norm(mapped, axis=-1) + 1e-12)
    ang = jnp.arccos(jnp.clip(num / den, -1.0, 1.0))
    sam = jnp.sum(jnp.where(e, ang, 0.0)) / n
    return (vf.mean(), jnp.nanmax(fused), psnr_vs(mapped),
            psnr_vs(target), sam)


def accuracy_gates() -> dict:
    """The bench's accuracy gates (env-tunable, see the module doc)."""
    return {
        "psnr_db": float(os.environ.get("HYPERRES_BENCH_PSNR_GATE",
                                        "45.0")),
        "sam_rad": float(os.environ.get("HYPERRES_BENCH_SAM_GATE",
                                        "0.01")),
        "method_psnr_db": float(os.environ.get(
            "HYPERRES_BENCH_METHOD_PSNR_GATE", "28.0")),
        "finite_frac": 0.3,
    }


def gates_pass(acc, gates: dict) -> bool:
    """``acc`` as returned (and converted to floats) from
    :func:`accuracy_metrics`."""
    finite_frac, fmax, psnr_db, method_psnr_db, sam_rad = acc
    return (finite_frac > gates["finite_frac"] and fmax <= 1.0
            and psnr_db >= gates["psnr_db"]
            and sam_rad <= gates["sam_rad"]
            and method_psnr_db >= gates["method_psnr_db"])


def main():
    t_setup0 = time.perf_counter()
    import threading

    import jax

    from hyperres.utils import (enable_compilation_cache, query_gpus,
                                require_gpu)

    devs = require_gpu()
    smi_line, smi = query_gpus()
    gpu_name, power_limit_w = smi[0]
    log(f"devices: {devs}; nvidia-smi: {smi_line}")

    # count persistent-compilation-cache traffic (requests vs hits) so
    # the JSON says whether this run compiled or loaded its programs
    cache_events = {"requests": 0, "hits": 0}

    def _cache_listener(event, **kw):
        if event == "/jax/compilation_cache/compile_requests_use_cache":
            cache_events["requests"] += 1
        elif event == "/jax/compilation_cache/cache_hits":
            cache_events["hits"] += 1

    jax.monitoring.register_event_listener(_cache_listener)
    log(f"compile cache: {enable_compilation_cache()}")

    scale = float(os.environ.get("HYPERRES_BENCH_SCALE", "1.0"))
    warp_kernel = os.environ.get("HYPERRES_BENCH_WARP", "auto")

    log(f"generating scene + plan (scale {scale}) ...")
    wk = build_workload(scale, warp_kernel, scene_cache=True)
    plan = wk["plan"]
    raw = wk["raw"]
    utm60 = wk["utm60"]
    s2_grid = wk["s2_grid"]
    log(f"raw {raw.shape}; UTM 60 m grid: {utm60.height}x{utm60.width}; "
        f"10 m grid: {s2_grid.height}x{s2_grid.width}")
    t_setup = time.perf_counter() - t_setup0
    log(f"setup done in {t_setup:.1f}s")

    # ------- compile (background thread) overlapped with ingest -------
    # the AOT precompile needs only SHAPES + the plan's host matrices,
    # no granule bytes — so the cold-start wall is max(compile, ingest)
    # instead of their serial sum
    import jax.numpy as jnp

    h10, w10 = s2_grid.height, s2_grid.width
    acc_jit = jax.jit(accuracy_metrics)
    comp = {"t": None, "err": None, "acc": None}

    def _bg_compile():
        try:
            t0 = time.perf_counter()
            plan.precompile(raw.shape, (h10, w10, 3))
            sds = jax.ShapeDtypeStruct((h10, w10, 3), jnp.float32)
            csds = jax.ShapeDtypeStruct(
                (3, plan.statics.degree + 1), jnp.float32)
            comp["acc"] = acc_jit.lower(sds, sds, csds).compile()
            comp["t"] = time.perf_counter() - t0
        except Exception as e:  # re-raised after join
            comp["err"] = e

    t_par0 = time.perf_counter()
    log("compiling in background; uploading inputs ...")
    bg = threading.Thread(target=_bg_compile, daemon=True)
    bg.start()

    # ---------------- ingest (production transfer path) ----------------
    t_up0 = time.perf_counter()
    # raw cube: chunked per-band-affine u16 quantization overlapped with
    # host->device transfer and device-side assembly (hyperres.io.ingest
    # — the same path orthorectify_granule uses)
    transfer = os.environ.get("HYPERRES_BENCH_TRANSFER", "u16")
    from hyperres.io.ingest import stream_cube_to_device
    raw_j = stream_cube_to_device(
        lambda b0, b1: raw[..., b0:b1], raw.shape, transfer=transfer,
        chunk_bands=32, depth=3)
    raw_j.block_until_ready()
    t_raw_ingest = time.perf_counter() - t_up0
    log(f"raw cube streamed in {t_raw_ingest:.2f}s ({transfer})")
    # S2 RGB stack: already uint16 DN on the wire (the production disk /
    # download format); scaled to reflectance on device by prepare_s2
    t_s2_0 = time.perf_counter()
    s2_dn_j = jax.device_put(wk["s2_dn"])
    s2rgb_j = plan.prepare_s2(s2_dn_j)
    jax.block_until_ready(s2rgb_j)
    s2_dn_j.delete()
    t_s2_ingest = time.perf_counter() - t_s2_0
    t_ingest = time.perf_counter() - t_up0
    log(f"upload done in {t_ingest:.2f}s (u16 S2 stack "
        f"{t_s2_ingest:.2f}s)")

    bg.join()
    if comp["err"] is not None:
        raise comp["err"]
    t_compile = comp["t"]
    t_cold = time.perf_counter() - t_par0   # = max(compile, ingest) + eps
    log(f"background compile done in {t_compile:.2f}s (cache: "
        f"{cache_events['hits']}/{cache_events['requests']} hits; "
        f"cold start to data+programs ready: {t_cold:.2f}s)")

    def release(out):
        for leaf in jax.tree_util.tree_leaves(out):
            leaf.delete()

    log("warmup run ...")
    t_c0 = time.perf_counter()
    out = plan(raw_j, s2rgb_j, key=jax.random.PRNGKey(0))
    jax.block_until_ready(out)
    t_warmup = time.perf_counter() - t_c0
    release(out)
    log(f"warmup run: {t_warmup:.2f}s")

    n_runs = max(1, int(os.environ.get("HYPERRES_BENCH_RUNS", "3")))
    times = []
    acc = None
    for i in range(n_runs):
        t0 = time.perf_counter()
        out = plan(raw_j, s2rgb_j, key=jax.random.PRNGKey(i + 1))
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
        if i == n_runs - 1:
            target = plan.s2_reference_10m(out["utm_cube"], s2rgb_j)
            acc = [float(x) for x in comp["acc"](
                out["fused_10m"], target, out["coeffs"])]
            target.delete()
        release(out)
    elapsed = min(times)
    log(f"runs: {times}")

    gates = accuracy_gates()
    ok = gates_pass(acc, gates)
    finite_frac, _, psnr_db, method_psnr_db, sam_rad = acc
    log(f"accuracy vs method-ideal target: pipeline PSNR {psnr_db} dB "
        f"(gate >= {gates['psnr_db']}), SAM {sam_rad} rad "
        f"(gate <= {gates['sam_rad']}); method PSNR {method_psnr_db} dB "
        f"(gate >= {gates['method_psnr_db']}); finite frac "
        f"{finite_frac}")

    result = {
        "metric": _METRIC_NAME,
        "value": elapsed,
        "unit": "seconds",
        "runs_s": times,
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        "gpu_name": gpu_name,
        "power_limit_w": power_limit_w,
        "peak_bytes_in_use": devs[0].memory_stats().get(
            "peak_bytes_in_use"),
        "psnr_db": psnr_db,
        "sam_rad": sam_rad,
        "method_psnr_db": method_psnr_db,
        # host->device ingest of the inputs (streamed, u16-quantized by
        # default; raw cube + 10 m S2 stack) and the ingest-inclusive
        # wall clock for a fresh granule pair
        "ingest_s": t_ingest,
        "ingest_inclusive_s": t_ingest + elapsed,
        "transfer": transfer,
        # one-time costs: compile_s is the BACKGROUND AOT compile wall
        # (overlapped with ingest — cold_start_s is the time until data
        # and programs are both ready)
        "compile_s": t_compile,
        "warmup_s": t_warmup,
        "cold_start_s": t_cold,
        "cache_hits": cache_events["hits"],
        "cache_requests": cache_events["requests"],
        "setup_s": t_setup,
        "engine": "FusedOrthoFusionPlan",
        "warp_kernel": warp_kernel,
        "warp_backend": plan.warp_statics.backend,
    }
    if not ok:
        result["status"] = "accuracy_gate_failed"
        print(json.dumps(result), flush=True)
        log("FATAL: accuracy gate failed")
        raise SystemExit(4)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
