"""Smoke test of the granule pipeline on the GPU, at full granule size.

Run from the repository root on a machine with a card:

    python chip_smoke.py              # one card: the main path
    python chip_smoke.py --devices 4  # four cards: the multi-card programs

One card runs, in one process and through the entry points a user
calls: the full-granule ``FusedOrthoFusionPlan`` (raw 1242x1280x285 ->
9140x9309x3) under the bench's accuracy gates, timed with the banded
and with the dense two-pass warp; the banded warp against the dense
reference at full width; the spectral-SR product path against a
float64 NumPy evaluation; and ``run_pair_pipeline`` with coregistration
on a synthetic pair. Four cards run the scene-parallel batch, the
data-parallel ridge fit and the row-sharded two-pass warp, each against
its one-card result.

Inputs are generated from ``--seed``. Every phase prints its result; a
failed phase makes the exit code non-zero. The card's name and power
limit (nvidia-smi) come on the line before the last, and the last line
is one JSON object, printed only when every phase passed:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Without a GPU the script exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

#: reflectance tolerance of the warp comparisons: the step of the u16
#: (x10000) reflectance product
WARP_TOL = 1e-4
#: destination pixels whose interpolation weight mass (the warped
#: validity channel) is below this are not compared: at the swath edge
#: the product is a ratio of two small sums, where the float32 rounding
#: of either is amplified tenfold or more (their count is printed)
MIN_WEIGHT_MASS = 0.1
#: raw granule scale of the bench scene (1.0 = 1242 x 1280 x 285)
GRANULE_SCALE = 1.0
#: side of the square cube the SR product phase predicts (2048^2 = 4 Mpx)
SR_SIDE = 2048


def log(msg) -> None:
    print(msg, flush=True)


def _timed(fn, n: int = 3):
    """Run ``fn`` (which must block on its result) n times; return
    (per-run seconds, last result)."""
    times, out = [], None
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return times, out


def _peak_bytes(dev) -> int:
    """Peak device bytes the process's arrays have held (-1 where the
    backend keeps no statistics)."""
    return int((dev.memory_stats() or {}).get("peak_bytes_in_use", -1))


def _release(tree) -> None:
    import jax

    for leaf in jax.tree_util.tree_leaves(tree):
        leaf.delete()


# ---------------------------------------------------------------------------
# Warp comparisons shared by the one-card and four-card phases
# ---------------------------------------------------------------------------

def _weight_mass(flat_idx, valid, rows, cstar):
    """The dense reference's warped validity (interpolation weight mass)
    per destination pixel, (Hd, Wd)."""
    import jax
    import jax.numpy as jnp

    from hyperres.kernels.warp import _two_pass_core

    @jax.jit
    def run(valid, rows, cstar):
        v = valid.astype(jnp.float32)[..., None]
        return _two_pass_core(v, rows, cstar, "cubic", 64, 64,
                              jax.lax.Precision.HIGHEST)[..., 0]

    return run(jnp.asarray(valid), jnp.asarray(rows), jnp.asarray(cstar))


def _compare_warps(a, b, mass, fill=-9999.0):
    """Max |a - b| over destination pixels valid in both and with weight
    mass >= MIN_WEIGHT_MASS; also the count of pixels whose nodata
    status differs."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(a, b, mass):
        va = (a != fill).all(-1)
        vb = (b != fill).all(-1)
        ok = va & vb & (jnp.abs(mass) >= MIN_WEIGHT_MASS)
        err = jnp.max(jnp.where(ok[..., None], jnp.abs(a - b), 0.0))
        return err, jnp.sum(va != vb), jnp.sum(ok), jnp.sum(va & vb)

    err, n_mismatch, n_cmp, n_both = run(a, b, mass)
    log(f"  compared {int(n_cmp)} of the {int(n_both)} pixels valid in "
        f"both (weight mass >= {MIN_WEIGHT_MASS})")
    return float(err), int(n_mismatch), int(n_cmp)


# ---------------------------------------------------------------------------
# One-card phases
# ---------------------------------------------------------------------------

def phase_device(devices=None) -> dict:
    """Require a GPU and print what it is; returns the card record."""
    import jax

    from hyperres.utils import query_gpus, require_gpu

    devs = require_gpu(devices)
    smi_line, smi = query_gpus()
    log(f"device_kind: {devs[0].device_kind}; device count: {len(devs)}; "
        f"jax {jax.__version__}")
    log(f"nvidia-smi: {smi_line}")
    return {"devices": devs, "smi_line": smi_line, "name": smi[0][0],
            "power_limit_w": smi[0][1]}


def phase_main_path(ctx: dict) -> None:
    """Full-granule FusedOrthoFusionPlan: compile, u16 ingest, 3 timed
    runs under the bench's accuracy gates; then the same with the dense
    warp for the end-to-end banded-vs-dense comparison."""
    import jax

    import bench
    from hyperres.io.ingest import stream_cube_to_device

    dev = ctx["card"]["devices"][0]
    t0 = time.perf_counter()
    wk = bench.build_workload(GRANULE_SCALE, "auto", seed=ctx["seed"])
    plan, raw = wk["plan"], wk["raw"]
    s2g = wk["s2_grid"]
    log(f"scene + plan built in {time.perf_counter() - t0:.1f} s: raw "
        f"{raw.shape}, UTM {wk['utm60'].height}x{wk['utm60'].width}, "
        f"10 m {s2g.height}x{s2g.width}, warp backend "
        f"{plan.warp_statics.backend} (group "
        f"{plan.warp_statics.banded_group})")
    s2_shape = (s2g.height, s2g.width, 3)
    t0 = time.perf_counter()
    compiled = plan.precompile(raw.shape, s2_shape)
    log(f"precompile: {time.perf_counter() - t0:.1f} s")
    log(f"memory_analysis: {compiled.memory_analysis()}")

    t0 = time.perf_counter()
    raw_j = stream_cube_to_device(
        lambda b0, b1: raw[..., b0:b1], raw.shape, transfer="u16",
        chunk_bands=32, depth=3)
    s2 = plan.prepare_s2(jax.device_put(wk["s2_dn"]))
    jax.block_until_ready((raw_j, s2))
    log(f"u16 ingest: {time.perf_counter() - t0:.2f} s")

    def run(p):
        def once():
            out = p(raw_j, s2, key=jax.random.PRNGKey(ctx["seed"]))
            return jax.block_until_ready(out)
        _release(once())  # first execution: excluded from the times
        return _timed(once)

    times, out = run(plan)
    target = plan.s2_reference_10m(out["utm_cube"], s2)
    acc = [float(x) for x in jax.jit(bench.accuracy_metrics)(
        out["fused_10m"], target, out["coeffs"])]
    _release((out, target))
    gates = bench.accuracy_gates()
    finite_frac, fmax, psnr_db, method_psnr_db, sam_rad = acc
    log(f"full granule ({plan.warp_statics.backend} warp): runs {times} s;"
        f" fused {s2_shape}; pipeline PSNR {psnr_db} dB (>= "
        f"{gates['psnr_db']}), SAM {sam_rad} rad (<= {gates['sam_rad']}),"
        f" method PSNR {method_psnr_db} dB (>= "
        f"{gates['method_psnr_db']}), finite fraction {finite_frac}, "
        f"max {fmax}; peak_bytes_in_use after this plan and the accuracy "
        f"check {_peak_bytes(dev)}; card {ctx['card']['smi_line']}")
    if not bench.gates_pass(acc, gates):
        raise AssertionError(f"accuracy gates failed: {acc} vs {gates}")

    dense = bench.plan_for_scene(wk, "two_pass")
    dense.precompile(raw.shape, s2_shape, audit=False)
    d_times, d_out = run(dense)
    _release(d_out)
    log(f"end to end: {plan.warp_statics.backend} warp min "
        f"{min(times)} s, dense warp min {min(d_times)} s (runs "
        f"{d_times}); peak_bytes_in_use after both plans "
        f"{_peak_bytes(dev)}")
    ctx.update(wk=wk, raw_j=raw_j, plan=plan)


def phase_warp(ctx: dict) -> None:
    """The banded warp against the dense reference at full granule width
    (precision "highest" on both), pre-division and as a product; then
    warp-only times of both backends, the banded one both as a loop of
    64-row (column) blocks and as one dot_general per pass."""
    import jax
    import jax.numpy as jnp

    from hyperres.kernels.warp import (
        _two_pass_core, banded_two_pass, orthowarp_two_pass,
        select_warp_backend,
    )

    plan, raw_j = ctx["plan"], ctx["raw_j"]
    flat, valid, wr, wc, cstar = (plan._flat, plan._valid, plan._wr,
                                  plan._wc, plan._cstar)
    _, group = select_warp_backend(np.asarray(cstar), np.asarray(wr),
                                   "banded")
    b = raw_j.shape[-1]

    @jax.jit
    def src_ext_of(raw, flat, valid):
        v = jnp.take(raw.reshape(-1, b), flat.reshape(-1),
                     axis=0).reshape(flat.shape + (b,))
        vf = valid.astype(jnp.float32)[..., None]
        return jnp.concatenate([v * vf, vf], axis=-1)

    src_ext = src_ext_of(raw_j, flat, valid)
    dense_ext = jax.jit(_two_pass_core, static_argnums=(3, 4, 5, 6))(
        src_ext, wr, cstar, "cubic", 64, 64, jax.lax.Precision.HIGHEST)
    band_ext = jax.jit(banded_two_pass, static_argnums=(3, 4, 5))(
        src_ext, wr, cstar, "cubic", "highest", group)
    err_ext = float(jnp.max(jnp.abs(band_ext - dense_ext)))
    _release((src_ext, dense_ext, band_ext))

    def warp(g=None, block=64):
        def once():
            return orthowarp_two_pass(
                raw_j, flat, valid, wr, wc, cstar, banded_group=g,
                block_rows_src=block, block_rows_dst=block
            ).block_until_ready()
        once().delete()
        return _timed(once)

    # a block spanning both passes' loop axes: one dot_general per pass
    whole = -(-max(flat.shape[0], wr.shape[1]) // group) * group
    t_band, out_band = warp(group)
    t_dense, out_dense = warp()
    mass = _weight_mass(flat, valid, wr, cstar)
    err, n_mismatch, n_cmp = _compare_warps(out_band, out_dense, mass)
    _release(out_dense)
    t_whole, out_whole = warp(group, whole)
    err_whole = float(jnp.max(jnp.abs(out_whole - out_band)))
    _release((out_band, out_whole, mass))
    log(f"warp at {tuple(wr.shape)}x{b}, group {group}, precision "
        f"highest: pre-division max-abs {err_ext}; product max-abs "
        f"{err} over {n_cmp} pixels (weight mass >= {MIN_WEIGHT_MASS}), "
        f"nodata mismatches {n_mismatch}; banded runs {t_band} s, dense "
        f"runs {t_dense} s; banded as one dot_general per pass (block "
        f"{whole}) runs {t_whole} s, max-abs {err_whole} vs the 64-block "
        f"loop; peak_bytes_in_use {_peak_bytes(ctx['card']['devices'][0])}")
    if not (err_ext <= WARP_TOL and err <= WARP_TOL
            and err_whole <= WARP_TOL):
        raise AssertionError(f"banded vs dense warp: {err_ext}, {err}, "
                             f"{err_whole} > {WARP_TOL}")


def sr_oracle_u16(params, X: np.ndarray, degree: int) -> np.ndarray:
    """Float64 NumPy evaluation of a fitted RidgeSpectralSR on pixels X
    (N, Bx): standardise, monomials from the exponent table, ridge
    matmul, sigmoid, x10000 u16 quantisation. (N, By) int64."""
    from hyperres.kernels.lstsq import poly_feature_exponents

    mean = np.asarray(params.x_mean, np.float64)
    std = np.asarray(params.x_std, np.float64)
    W = np.asarray(params.W, np.float64)
    c = np.asarray(params.intercept, np.float64)
    xs = (np.asarray(X, np.float64) - mean) / std
    exps = poly_feature_exponents(X.shape[1], degree)
    F = np.prod(xs[:, None, :] ** exps[None, :, :], axis=-1)
    y = 1.0 / (1.0 + np.exp(-(F @ W + c)))
    return np.clip(np.rint(y * 10000.0), 0, 65534).astype(np.int64)


def fit_sr_model(n_outputs: int, n_train: int, seed: int):
    """A degree-3 RidgeSpectralSR(10 -> n_outputs) fitted on seeded
    synthetic pixels (the ``__graft_entry__.entry`` model)."""
    from hyperres.core.config import RidgeSRConfig
    from hyperres.fusion import RidgeSpectralSR

    rng = np.random.default_rng(seed)
    model = RidgeSpectralSR(10, n_outputs, RidgeSRConfig(degree=3))
    X = rng.random((n_train, 10)).astype(np.float32)
    Y = np.clip(0.2 + 0.4 * X[:, :1] + 0.05 * rng.random((n_train,
                                                          n_outputs)),
                0.01, 0.99).astype(np.float32)
    return model.fit(X, Y)


def phase_sr_predict(ctx: dict) -> None:
    """predict_cube_u16 at the production model width on a 4 Mpx cube
    against float64 NumPy on a sampled pixel subset."""
    rng = np.random.default_rng(ctx["seed"])
    model = fit_sr_model(285, 200_000, ctx["seed"])
    h = w = SR_SIDE
    cube = rng.random((10, h, w)).astype(np.float32)
    cube[:, 7, 11] = np.nan                       # one nodata pixel
    times, q = _timed(lambda: model.predict_cube_u16(cube), n=2)
    flat = cube.reshape(10, -1).T
    idx = rng.choice(h * w, 8192, replace=False)
    idx = idx[np.isfinite(flat[idx]).all(1)]
    want = sr_oracle_u16(model.params, flat[idx], 3)
    got = q.reshape(q.shape[0], -1)[:, idx].T.astype(np.int64)
    err = int(np.abs(got - want).max())
    log(f"SR predict (10 -> 285, degree 3, {h * w} px): runs {times} s "
        f"(first includes compile); matmul precision HIGHEST (full "
        f"float32); max step error vs float64 {err} over {idx.size} "
        f"sampled pixels")
    if err > 1 or q[:, 7, 11].min() != 65535:
        raise AssertionError(f"SR predict: {err} u16 steps off float64 "
                             "or nodata pixel not 65535")


def phase_pair_pipeline(ctx: dict) -> None:
    """run_pair_pipeline with coregistration on a synthetic pair: the
    readers, coregistration, tiling, SR training and writers on the
    card."""
    from hyperres.core.config import CoregConfig, TilingConfig
    from hyperres.pipeline import run_pair_pipeline
    from hyperres.testing.scenes import make_scene

    with tempfile.TemporaryDirectory() as td:
        sc = make_scene(Path(td) / "scene", raw_shape=(96, 112),
                        s2_size=720, seed=ctx["seed"])
        t0 = time.perf_counter()
        res = run_pair_pipeline(
            sc.emit_nc_path, sc.s2_tif_path, Path(td) / "out",
            coregister=True,
            coreg_config=CoregConfig(window_size=(256, 256),
                                     grid_res=120, max_points=9,
                                     min_reliability=20, max_shift=8.0),
            tiling_config=TilingConfig(emit_tile_size=16,
                                       max_black_frac=0.1),
            max_tiles=4)
        r2 = float(res.sr_metrics["r2_mean"])
        log(f"run_pair_pipeline: {time.perf_counter() - t0:.1f} s; "
            f"report {res.report_path.exists()}; tiles {len(res.tiles)};"
            f" coreg {res.info['coreg'] is not None}; SR r2_mean {r2}")
        if not (res.report_path.exists() and np.isfinite(r2)):
            raise AssertionError("pair pipeline: no report or r2 not "
                                 "finite")


# ---------------------------------------------------------------------------
# Four-card phases
# ---------------------------------------------------------------------------

def phase_batch(ctx: dict) -> None:
    """BatchPairDriver over 4 synthetic pairs on 4 cards against the
    same pairs run on one card."""
    import jax.numpy as jnp

    from hyperres.batch import BatchPairDriver, PairJob
    from hyperres.core.config import TilingConfig
    from hyperres.io.tiff import TiffReader
    from hyperres.pipeline import run_pair_pipeline
    from hyperres.testing.scenes import make_scene

    devs = ctx["card"]["devices"][:4]
    tiling = TilingConfig(emit_tile_size=16, max_black_frac=0.5)

    def runner(job, pair_dir):
        # where this thread's unplaced arrays land (the driver pins it)
        home = str(next(iter(jnp.zeros(()).devices())))
        res = run_pair_pipeline(job.emit_nc_path, job.s2_stack_tif,
                                pair_dir, tiling_config=tiling,
                                sr_config=None)
        return {"fused_tif": str(res.fused_tif), "home": home}

    def fused(manifest, pid):
        with TiffReader(manifest[pid]["outputs"]["fused_tif"]) as r:
            return r.read()

    with tempfile.TemporaryDirectory() as td:
        root = Path(td)
        jobs = []
        for i in range(4):
            sc = make_scene(root / f"pair{i}", raw_shape=(48, 52),
                            n_bands=48, s2_size=360, seed=ctx["seed"] + i)
            jobs.append(PairJob(f"pair{i}", str(sc.emit_nc_path),
                                str(sc.s2_tif_path)))
        t0 = time.perf_counter()
        one = BatchPairDriver(root / "one", sr_config=None,
                              runner=runner).run(jobs, devices=devs[:1])
        t_one = time.perf_counter() - t0
        t0 = time.perf_counter()
        four = BatchPairDriver(root / "four", sr_config=None,
                               runner=runner).run(jobs, devices=devs)
        t_four = time.perf_counter() - t0
        status = {j.pair_id: (one[j.pair_id]["status"],
                              four[j.pair_id]["status"]) for j in jobs}
        used = {four[j.pair_id]["attempts"][-1]["device"] for j in jobs}
        homes_ok = all(four[j.pair_id]["outputs"]["home"]
                       == four[j.pair_id]["attempts"][-1]["device"]
                       for j in jobs if four[j.pair_id]["status"] == "done")
        errs = [float(np.nanmax(np.abs(
            fused(one, j.pair_id).astype(np.float64)
            - fused(four, j.pair_id)))) for j in jobs
            if "done" == status[j.pair_id][0] == status[j.pair_id][1]]
    log(f"batch of toy pairs, compile included, one-card run first (not"
        f" a throughput): one card {t_one:.1f} s, four cards "
        f"{t_four:.1f} s; "
        f"status {status}; devices {sorted(used)}; arrays on their "
        f"pair's device {homes_ok}; fused max-abs vs one card {errs}")
    if not (all(s == ("done", "done") for s in status.values())
            and len(used) == 4 and homes_ok and max(errs) <= WARP_TOL):
        raise AssertionError("scene-parallel batch failed its checks")


def phase_ridge_fit(ctx: dict) -> None:
    """data_parallel_ridge_fit on a 4-card mesh against the one-device
    fit of the same pixels (the SR product width: 10 -> 32 bands)."""
    from hyperres.core.config import RidgeSRConfig
    from hyperres.fusion import RidgeSpectralSR
    from hyperres.parallel import data_parallel_ridge_fit, make_mesh

    rng = np.random.default_rng(ctx["seed"])
    n = 4 * 65536
    X = rng.random((n, 10)).astype(np.float32)
    Y = np.clip(0.1 + 0.5 * X[:, 2:3] + 0.1 * rng.random((n, 32)),
                0.01, 0.99).astype(np.float32)
    single = RidgeSpectralSR(10, 32, RidgeSRConfig(degree=3)).fit(X, Y)
    model = RidgeSpectralSR(10, 32, RidgeSRConfig(degree=3))
    mesh = make_mesh((4,), ("data",),
                     devices=ctx["card"]["devices"][:4])
    model.params = data_parallel_ridge_fit(model, X, Y, mesh)
    probe = X[:4096]
    err = float(np.abs(model.predict(probe) - single.predict(probe)).max())
    log(f"data-parallel ridge fit ({n} px, 4 cards): predictions max-abs "
        f"{err} vs one device")
    if err > WARP_TOL:
        raise AssertionError(f"ridge fit: {err} > {WARP_TOL}")


def phase_sharded_warp(ctx: dict) -> None:
    """sharded_orthowarp_two_pass, row-sharded over 4 cards at full
    granule geometry, against the one-device dense warp."""
    import jax
    import jax.numpy as jnp

    import bench
    from hyperres.kernels.glt import prepare_glt
    from hyperres.kernels.warp import (
        orthowarp_two_pass, scanline_cstar, source_index_field,
    )
    from hyperres.parallel import make_mesh, sharded_orthowarp_two_pass

    n = 4
    geo = bench.scene_geometry(GRANULE_SCALE)
    raw_h, raw_w = geo["raw_shape"]
    raw = np.random.default_rng(ctx["seed"]).random(
        (raw_h, raw_w, 285), dtype=np.float32)
    glt = geo["glt"]
    ho = glt.shape[0] - glt.shape[0] % n
    flat, valid = prepare_glt(glt[:ho], (raw_h, raw_w))
    rows, cols = source_index_field(geo["ortho_grid"], geo["utm60"])
    hd = rows.shape[0] - rows.shape[0] % n
    rows, cols = rows[:hd], cols[:hd]
    cstar = scanline_cstar(rows, cols, ho)
    ho_l, hd_l = ho // n, hd // n
    need = max(max(i * ho_l - np.floor(rows[i * hd_l:(i + 1) * hd_l].min()
                                       - 2.0),
                   np.ceil(rows[i * hd_l:(i + 1) * hd_l].max() + 2.0)
                   - (i + 1) * ho_l) for i in range(n))
    halo = int(min(ho_l, max(8, need + 1)))
    mesh = make_mesh((n,), ("data",), devices=ctx["card"]["devices"][:n])
    t0 = time.perf_counter()
    got = sharded_orthowarp_two_pass(raw, flat, valid, rows, cols, cstar,
                                     mesh, halo=halo)
    got = jax.device_put(got.block_until_ready(),
                         ctx["card"]["devices"][0])
    t_sh = time.perf_counter() - t0
    args = [jnp.asarray(x) for x in (raw, flat, valid, rows, cols, cstar)]
    t0 = time.perf_counter()
    ref = orthowarp_two_pass(*args).block_until_ready()
    t_one = time.perf_counter() - t0
    mass = _weight_mass(flat, valid, rows, cstar)
    err, n_mismatch, n_cmp = _compare_warps(got, ref, mass)
    log(f"row-sharded warp {rows.shape}x285 on {n} cards (halo {halo}): "
        f"max-abs {err} over {n_cmp} pixels, nodata mismatches "
        f"{n_mismatch}; first call incl. compile: sharded {t_sh:.1f} s,"
        f" one device {t_one:.1f} s")
    if err > WARP_TOL:
        raise AssertionError(f"sharded warp: {err} > {WARP_TOL}")


PHASES_ONE = (("main_path", phase_main_path), ("warp", phase_warp),
              ("sr_predict", phase_sr_predict),
              ("pair_pipeline", phase_pair_pipeline))
PHASES_FOUR = (("batch", phase_batch), ("ridge_fit", phase_ridge_fit),
               ("sharded_warp", phase_sharded_warp))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="1: the one-card main path; 4: only the "
                         "multi-card phases")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    try:
        card = phase_device()
    except (RuntimeError, OSError, ImportError) as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    devs = card["devices"]
    if len(devs) < args.devices:
        print(f"chip_smoke: {args.devices} cards asked, {len(devs)} "
              "present", file=sys.stderr)
        return 1

    from hyperres.utils import enable_compilation_cache

    log(f"compile cache: {enable_compilation_cache()}")
    ctx = {"card": card, "seed": args.seed}
    failed = []
    for name, phase in (PHASES_FOUR if args.devices == 4 else PHASES_ONE):
        log(f"== {name}")
        t0 = time.perf_counter()
        try:
            phase(ctx)
        except Exception:  # recorded; the run still exits non-zero
            traceback.print_exc()
            failed.append(name)
        log(f"== {name}: {'FAIL' if name in failed else 'pass'} in "
            f"{time.perf_counter() - t0:.1f} s")
    log(f"card: {card['smi_line']}")
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
