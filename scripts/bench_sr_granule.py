"""Granule-scale spectral-SR 10 m product benchmark: run the
``predict_cube_u16`` device program at the full 9140x9309x(10 -> 32)
scale on one device and report px/s + end-to-end seconds.

The workload is Spectral_matching.ipynb cells 8/27 at real scale: a
degree-3 ridge model mapping 10 S2 bands to 32 EMIT bands in logit
space, evaluated over every valid 10 m pixel and quantized to the u16
product convention — as ONE device program (fori_loop over fixed
200k-px batches; no per-batch host round-trip).

Usage: python scripts/bench_sr_granule.py [--scale 1.0]
Prints a JSON summary line.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--batch", type=int, default=200_000)
    ap.add_argument("--params", default=None,
                    help="npz checkpoint: load the fitted model if the "
                         "file exists, else fit and save (skips the "
                         "minutes-scale remote fit compile on reruns)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from hyperres.utils import enable_compilation_cache
    enable_compilation_cache()

    from hyperres.core.config import RidgeSRConfig
    from hyperres.fusion import RidgeSpectralSR

    h = max(64, int(9140 * args.scale))
    w = max(64, int(9309 * args.scale))
    bx, by = 10, 32
    log(f"devices: {jax.devices()}")
    log(f"scene: {bx} bands x {h}x{w} -> {by} bands "
        f"({h * w / 1e6:.1f} Mpx)")

    rng = np.random.default_rng(0)
    # train on synthetic correlated data (the model's numerics, not its
    # skill, are under test)
    Xt = rng.random((200_000, bx)).astype(np.float32)
    Yt = np.clip(0.15 + 0.5 * Xt[:, :1] + 0.2 * Xt[:, 1:2]
                 + 0.05 * rng.random((200_000, by)), 0.01,
                 0.99).astype(np.float32)
    from hyperres.fusion.ridge_sr import load_params, save_params
    t0 = time.perf_counter()
    if args.params and Path(args.params).exists():
        model = load_params(args.params)
        t_fit = 0.0
        log(f"loaded params from {args.params}")
    else:
        model = RidgeSpectralSR(
            bx, by, RidgeSRConfig(degree=3, batch_pixels=args.batch))
        model.fit(Xt, Yt)
        jax.block_until_ready(model.params.W)
        t_fit = time.perf_counter() - t0
        if args.params:
            save_params(args.params, model)
    log(f"fit (200k px, degree 3): {t_fit:.3f}s; "
        f"{model.params.W.shape[0]} features")

    # full-scale 10 m input (host f32): each pipeline leg timed once
    n = h * w
    n_pad = -(-n // args.batch) * args.batch
    t0 = time.perf_counter()
    X = rng.random((n_pad, bx), dtype=np.float32)
    valid = np.ones(n_pad, dtype=bool)
    valid[: n // 20] = False  # a nodata swath stripe
    t_prep = time.perf_counter() - t0
    log(f"host input ({X.nbytes / 1e9:.2f} GB): {t_prep:.1f}s")

    t0 = time.perf_counter()
    Xj = jax.device_put(X)
    vj = jax.device_put(valid)
    jax.block_until_ready((Xj, vj))
    t_upload = time.perf_counter() - t0
    log(f"upload: {t_upload:.1f}s")

    log("compiling + warmup ...")
    t0 = time.perf_counter()
    qd = model._predict_quant_batches(model.params, Xj, vj, args.batch)
    qd.block_until_ready()
    t_compile = time.perf_counter() - t0
    log(f"warmup incl. compile: {t_compile:.1f}s")
    qd.delete()

    t0 = time.perf_counter()
    qd = model._predict_quant_batches(model.params, Xj, vj, args.batch)
    qd.block_until_ready()
    t_dev = time.perf_counter() - t0
    log(f"device program: {t_dev:.3f}s")

    # readback in fixed-size row blocks (equal-shaped slices compile
    # their slice program once)
    t0 = time.perf_counter()
    blk = args.batch
    parts = []
    for r0 in range(0, n_pad, blk):
        parts.append(np.asarray(
            jax.lax.dynamic_slice(qd, (r0, 0), (blk, by))))
        if r0 == 0:
            log(f"  first {parts[0].nbytes / 1e6:.0f} MB block: "
                f"{time.perf_counter() - t0:.1f}s")
    q_host = np.concatenate(parts)
    t_read = time.perf_counter() - t0
    log(f"readback ({q_host.nbytes / 1e9:.2f} GB u16): {t_read:.1f}s")

    n_valid = int((q_host[:n] != 65535).all(1).sum())
    e2e = t_prep + t_upload + t_dev + t_read
    out = {
        "metric": "spectral_sr_10m_product",
        "mpx": round(n / 1e6, 2),
        "bands_in": bx,
        "bands_out": by,
        "fit_s": round(t_fit, 3),
        "compile_s": round(t_compile, 2),
        "device_program_s": round(t_dev, 4),
        "device_px_per_s": round(n / t_dev),
        "upload_s": round(t_upload, 2),
        "readback_s": round(t_read, 2),
        "e2e_s": round(e2e, 2),
        "e2e_px_per_s": round(n / e2e),
        "valid_px": n_valid,
        "batch": args.batch,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
