"""Full-scale production-path run on the device: real granule-sized
scene written to disk, then the complete run_pair_pipeline with all
file products (ENVI cube, GeoTIFFs, tiles, report).

Usage: python scripts/run_production_fullscale.py [OUT_DIR]
(default: hyperres_prod_run under the temp directory)."""

import sys
import tempfile
import time
from pathlib import Path


def main():
    out = Path(sys.argv[1] if len(sys.argv) > 1
               else Path(tempfile.gettempdir()) / "hyperres_prod_run")
    from hyperres.core.config import TilingConfig
    from hyperres.pipeline import run_pair_pipeline
    from hyperres.testing.scenes import make_scene

    t0 = time.perf_counter()
    print("writing full-scale scene (granule + S2 stack) ...", flush=True)
    scene = make_scene(out / "scene", raw_shape=(1242, 1280), n_bands=285,
                       s2_size=2048, compress_granule=False)
    print(f"scene written in {time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    res = run_pair_pipeline(
        scene.emit_nc_path, scene.s2_tif_path, out / "run",
        tiling_config=TilingConfig(max_black_frac=0.05),
        max_tiles=4, train_sr=True)
    print(f"pipeline total {time.perf_counter() - t0:.1f}s", flush=True)
    print("stage ledger:", res.ortho_info.get("stages"), flush=True)
    print("fusion stages:", res.fusion.info["stages"], flush=True)
    print("tiles:", len(res.tiles),
          "SR R2:", (res.sr_metrics or {}).get("r2_mean"), flush=True)
    print(res.report_path.read_text(), flush=True)


if __name__ == "__main__":
    main()
