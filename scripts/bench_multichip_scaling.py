"""Multi-device SPMD overhead/scaling sweep on a virtual CPU mesh.

Runs the production SPMD programs — the sharded two-pass scanline
orthowarp, the data-parallel ridge training step, and (n >= 4) the
2-axis row x band warp+SRF program — at a FIXED total problem size over
1/2/4/8 virtual CPU devices and reports:

- post-compile wall-clock per step (partition efficiency
  = t(1) / t(n): 1.0 means the decomposition adds zero overhead at
  constant work on this single-core host),
- COLLECTIVE BYTES per step, extracted from the compiled HLO
  (all-reduce / all-gather / collective-permute / reduce-scatter
  output bytes summed) — the structural cost that would ride the
  device interconnect (NVLink between GPUs) on real hardware.

Read the result for what it measures: virtual CPU devices share the
host's cores and add no compute, so the curve isolates the COST of the
SPMD decomposition (partitioning + halo exchange + psum) at constant
work. It is not a device measurement: ``chip_smoke.py --devices 4`` runs
the same programs on four GPUs.
Flat time across mesh sizes means the decomposition itself is cheap and
real multi-chip speedup is bounded by hardware, not by the program
structure. Correctness of the decompositions is covered by
tests/test_tiling_parallel.py and the driver dryrun.

Each mesh size runs in a fresh subprocess pinned to
``JAX_PLATFORMS=cpu`` (the virtual device count must be configured
before the backend starts), so no child ever opens a GPU.

Usage: python scripts/bench_multichip_scaling.py [--json out.json]
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import os, re, sys, time
n = int(sys.argv[1])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + f" --xla_force_host_platform_device_count={n}")
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", n)
import numpy as np
import jax.numpy as jnp
from hyperres.core.config import RidgeSRConfig
from hyperres.fusion import RidgeSpectralSR
from hyperres.kernels.glt import prepare_glt
from hyperres.kernels.warp import scanline_cstar
from hyperres.parallel import (make_mesh, sharded_orthowarp_two_pass,
                               sharded_orthowarp_srf_2d)
from hyperres.parallel.ops import data_parallel_ridge_fit

rng = np.random.default_rng(0)
mesh = make_mesh((n,), ("data",), devices=jax.devices()[:n])

_DTYPE_BYTES = {"f32": 4, "f16": 2, "bf16": 2, "f64": 8, "s32": 4,
                "u32": 4, "s8": 1, "u8": 1, "pred": 1, "u16": 2,
                "s16": 2}
_COLL = re.compile(
    r"= (\w+)\[([\d,]*)\][^=]*?"
    r"(all-reduce|all-gather|collective-permute|reduce-scatter)")

def collective_bytes(jitted, *args):
    txt = jitted.lower(*args).compile().as_text()
    total, counts = 0, {}
    for dt, shape, op in _COLL.findall(txt):
        elems = 1
        for d in shape.split(","):
            if d:
                elems *= int(d)
        total += elems * _DTYPE_BYTES.get(dt, 4)
        counts[op] = counts.get(op, 0) + 1
    return total, counts

def timeit(fn, reps=3):
    fn()  # compile + warm
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps

# ---- sharded two-pass orthowarp: fixed total 384x384x16 ----
ho = wo = hd = wd = 384
hr, wr, nb = 256, 260, 16
glt = np.zeros((ho, wo, 2), np.int32)
glt[..., 0] = rng.integers(1, wr + 1, (ho, wo))
glt[..., 1] = rng.integers(1, hr + 1, (ho, wo))
flat_idx, vmask = prepare_glt(glt, (hr, wr))
raw = rng.random((hr, wr, nb), dtype=np.float64).astype(np.float32)
r = np.arange(hd, dtype=np.float32)[:, None]
j = np.arange(wd, dtype=np.float32)[None, :]
wrows = (r * (ho / hd) + 0.002 * j) + 0 * j
wcols = (j * (wo / wd) + 0.001 * r) + 0 * r
cstar = scanline_cstar(wrows, wcols, ho)
fi, vm = jnp.asarray(flat_idx), jnp.asarray(vmask)
rawd = jnp.asarray(raw)
wrd, wcd, csd = jnp.asarray(wrows), jnp.asarray(wcols), jnp.asarray(cstar)

def warp_step():
    out = sharded_orthowarp_two_pass(rawd, fi, vm, wrd, wcd, csd, mesh,
                                     halo=48)
    jax.block_until_ready(out)

t_warp = timeit(warp_step)
warp_jit = jax.jit(lambda: sharded_orthowarp_two_pass(
    raw, flat_idx, vmask, wrows, wcols, cstar, mesh, halo=48))
warp_cb, warp_ops = collective_bytes(warp_jit)

# ---- data-parallel ridge fit: fixed total 65536 x 10 -> 32 ----
N, bx, by = 1 << 16, 10, 32
X = rng.random((N, bx), dtype=np.float64).astype(np.float32)
Y = np.clip(0.2 + 0.4 * X[:, :1] + 0.1
            * rng.random((N, by)).astype(np.float32), 0.01, 0.99)
model = RidgeSpectralSR(bx, by, RidgeSRConfig(degree=3))
Xd, Yd = jnp.asarray(X), jnp.asarray(Y)

def fit_step():
    params = data_parallel_ridge_fit(model, Xd, Yd, mesh)
    jax.block_until_ready(params.W)

t_fit = timeit(fit_step)
fit_jit = jax.jit(
    lambda: data_parallel_ridge_fit(model, Xd, Yd, mesh).W)
fit_cb, fit_ops = collective_bytes(fit_jit)

rec = {"n_devices": n, "orthowarp_s": round(t_warp, 4),
       "orthowarp_collective_bytes": warp_cb,
       "orthowarp_collectives": warp_ops,
       "ridge_fit_s": round(t_fit, 4),
       "ridge_fit_collective_bytes": fit_cb,
       "ridge_fit_collectives": fit_ops}

# ---- 2-axis (row x band) warp + SRF: fixed total, n >= 4 ----
if n >= 4:
    mesh2 = make_mesh((n // 2, 2), ("row", "band"),
                      devices=jax.devices()[:n])
    Wsrf = rng.random((nb, 3), dtype=np.float64).astype(np.float32)

    def warp2_step():
        out = sharded_orthowarp_srf_2d(rawd, fi, vm, wrd, wcd, csd,
                                       jnp.asarray(Wsrf), mesh2,
                                       halo=96)
        jax.block_until_ready(out)

    rec["warp_srf_2d_s"] = round(timeit(warp2_step), 4)
    w2_jit = jax.jit(lambda: sharded_orthowarp_srf_2d(
        raw, flat_idx, vmask, wrows, wcols, cstar, Wsrf, mesh2,
        halo=96))
    cb2, ops2 = collective_bytes(w2_jit)
    rec["warp_srf_2d_collective_bytes"] = cb2
    rec["warp_srf_2d_collectives"] = ops2

print(__import__('json').dumps(rec))
"""


def main():
    results = []
    for n in (1, 2, 4, 8):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        out = subprocess.run([sys.executable, "-c", CHILD, str(n)],
                             capture_output=True, text=True, env=env,
                             cwd=REPO, timeout=1200)
        if out.returncode != 0:
            print(f"n={n} FAILED:\n{out.stderr[-2000:]}", file=sys.stderr)
            continue
        line = out.stdout.strip().splitlines()[-1]
        rec = json.loads(line)
        results.append(rec)
        print(line)
    if "--json" in sys.argv:
        dst = sys.argv[sys.argv.index("--json") + 1]
        with open(dst, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
