"""Command-line interface.

The reference has no CLI at all (SURVEY.md section 0 — orchestration
lives in notebooks); hyperres exposes the pipeline stages as
subcommands:

  python -m hyperres ortho  EMIT.nc OUT_DIR --s2 S2.tif [--loc] [--obs OBS.nc]
  python -m hyperres fuse   EMIT.nc S2_STACK.tif OUT_DIR [...]
  python -m hyperres tiles  EMIT.tif S2.tif OUT_DIR [--tile-size N] [--scale K]
  python -m hyperres coreg  --emit-ref E.tif --s2 S2.tif --nc EMIT.nc --out OUT.tif
  python -m hyperres scene  OUT_DIR [--raw H W] [--bands N] [--s2-size N]
  python -m hyperres batch  JOBS.json OUT_DIR [--retries N] [--no-resume]
  python -m hyperres srf    SOURCE.xlsx|.csv [--platform S2A] [--fetch]
  python -m hyperres verify-granule EMIT.nc S2_STACK.tif OUT_DIR
  python -m hyperres info   RASTER [RASTER ...]
  python -m hyperres quicklook RASTER OUT.html [--max-size N] [--max-bands N]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _cmd_ortho(args) -> int:
    from .core.config import OrthoConfig
    from .ortho import orthorectify_granule

    res = orthorectify_granule(
        args.granule, args.out_dir, args.s2,
        obs_file=args.obs, mask_file=args.mask, export_loc=args.loc,
        config=OrthoConfig(overwrite=args.overwrite,
                           save_geotiffs=not args.no_geotiffs,
                           warp_kernel=args.warp_kernel,
                           apply_band_mask=args.band_mask),
        save_info_path=Path(args.out_dir) / "ortho_info.json")
    print(json.dumps({"data_envi_bin": str(res.data_envi_bin),
                      "outputs": res.info.get("outputs", {}),
                      "mask": res.info.get("mask"),
                      "stages": res.info.get("stages", {})}, indent=2))
    return 0


def _cmd_fuse(args) -> int:
    from .core.config import PolyFusionConfig, TilingConfig
    from .pipeline import run_pair_pipeline

    res = run_pair_pipeline(
        args.granule, args.s2_stack, args.out_dir,
        mask_file=args.mask,
        fusion_config=PolyFusionConfig(degree=args.degree),
        tiling_config=TilingConfig(emit_tile_size=args.tile_size,
                                   max_black_frac=args.max_black_frac),
        coregister=args.coreg,
        max_tiles=args.max_tiles,
        train_sr=not args.no_sr,
        predict_sr_cube=args.sr_cube)
    print(json.dumps({
        "fused_tif": str(res.fused_tif),
        "report": str(res.report_path),
        "n_tiles": len(res.tiles),
        "sr_r2_mean": (res.sr_metrics or {}).get("r2_mean"),
        "total_seconds": res.info.get("total_seconds"),
    }, indent=2))
    return 0


def _cmd_tiles(args) -> int:
    from .tiling import find_valid_paired_tiles, save_tile_pair

    tiles = find_valid_paired_tiles(
        args.emit, args.s2, emit_tile_size=args.tile_size,
        scale=args.scale, max_black_frac=args.max_black_frac,
        max_tiles=args.max_tiles)
    outputs = []
    for t in tiles:
        eo, so = save_tile_pair(args.emit, args.s2, t, args.out_dir)
        outputs.append({"idx": t["idx"], "emit": str(eo), "s2": str(so),
                        "emit_black_frac": t["emit_black_frac"]})
    print(json.dumps({"n_tiles": len(tiles), "tiles": outputs}, indent=2))
    return 0


def _cmd_coreg(args) -> int:
    from .coreg import coregister_s2_to_emit

    out = coregister_s2_to_emit(
        emit_ref_tif=args.emit_ref, s2_tgt_tif=args.s2,
        emit_nc_path=args.nc, out_s2_tif=args.out)
    print(json.dumps(out, indent=2, default=str))
    return 0 if out["final"].get("success") else 1


def _cmd_scene(args) -> int:
    from .testing.scenes import make_scene

    scene = make_scene(args.out_dir, raw_shape=tuple(args.raw),
                       n_bands=args.bands, s2_size=args.s2_size)
    print(json.dumps({"emit_nc": str(scene.emit_nc_path),
                      "s2_tif": str(scene.s2_tif_path)}, indent=2))
    return 0


def _cmd_batch(args) -> int:
    import json as _json

    from .batch import BatchPairDriver, PairJob

    jobs_doc = _json.loads(Path(args.jobs).read_text())
    jobs = [PairJob(j["pair_id"], j["emit_nc_path"], j["s2_stack_tif"],
                    j.get("meta", {})) for j in jobs_doc]
    driver = BatchPairDriver(args.out_dir, max_retries=args.retries)
    manifest = driver.run(jobs, resume=not args.no_resume)
    print(_json.dumps({"summary": driver.summary(),
                       "manifest": str(driver.manifest_path)}, indent=2))
    return 0 if driver.summary().get("failed", 0) == 0 else 1


def _cmd_verify_granule(args) -> int:
    """One-command real-granule parity: shipped fast path vs the
    reference-semantics exact path (see hyperres.verify)."""
    from .verify import verify_granule

    res = verify_granule(
        args.granule, args.s2_stack, args.out_dir,
        mask_file=args.mask, s2_scale=args.s2_scale,
        cube_psnr_gate=args.cube_psnr_gate,
        fused_psnr_gate=args.fused_psnr_gate,
        pipeline_psnr_gate=args.pipeline_psnr_gate)
    print(json.dumps({"report": str(res.report_path),
                      "json": str(res.json_path),
                      "gates": res.metrics["gates"],
                      "passed": res.passed}, indent=2))
    return 0 if res.passed else 1


def _cmd_info(args) -> int:
    from .viz import print_raster_geometry

    for path in args.rasters:
        print_raster_geometry(path)
    return 0


def _cmd_quicklook(args) -> int:
    """Single-file interactive HTML viewer (band browser + RGB composite
    + click-to-spectrum) for a granule (.nc), ENVI product (.hdr) or
    GeoTIFF stack — the EMIT_experiments.ipynb hvplot exploration
    surface without a notebook/server."""
    from .viz.interactive import quicklook_from_product

    out = quicklook_from_product(
        args.raster, args.out, max_size=args.max_size,
        max_bands=args.max_bands)
    print(out)
    return 0


def _cmd_srf(args) -> int:
    """Import the measured Sentinel-2 SRF tables (workbook xlsx or a CSV
    sheet export) into the cache load_srf consults; --fetch downloads
    the official Copernicus workbook first (network required)."""
    from .spectral.srf_cache import (
        COPERNICUS_SRF_URL, fetch_srf_workbook, import_srf_tables,
        user_cache_dir,
    )

    src = args.src
    if args.fetch:
        url = args.url or COPERNICUS_SRF_URL
        src = user_cache_dir() / "S2-SRF.xlsx"
        print(f"fetching {url} -> {src}")
        fetch_srf_workbook(src, url=url)
    if src is None:
        print("error: provide a source file or --fetch")
        return 2
    out = {}
    for platform in args.platforms:
        path = import_srf_tables(src, platform=platform, dest=args.dest)
        out[platform] = str(path)
    print(json.dumps({"imported": out}, indent=2))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="hyperres",
        description="EMIT x Sentinel-2 fusion framework")
    sub = p.add_subparsers(dest="command", required=True)

    o = sub.add_parser("ortho", help="orthorectify a granule onto an "
                                     "S2-anchored UTM grid")
    o.add_argument("granule")
    o.add_argument("out_dir")
    o.add_argument("--s2", required=True, help="S2 template GeoTIFF")
    o.add_argument("--obs", default=None)
    o.add_argument("--mask", default=None,
                   help="EMIT L2A mask granule: apply its quality mask "
                        "(cloud/cirrus/spacecraft flags) to the cube")
    o.add_argument("--band-mask", action="store_true",
                   help="also apply the packed per-pixel band mask")
    o.add_argument("--loc", action="store_true")
    o.add_argument("--overwrite", action="store_true")
    o.add_argument("--no-geotiffs", action="store_true")
    o.add_argument("--warp-kernel", choices=["two_pass", "taploop"],
                   default="two_pass",
                   help="two_pass: scanline matmuls (fast); "
                        "taploop: exact per-tap gathers")
    o.set_defaults(fn=_cmd_ortho)

    f = sub.add_parser("fuse", help="full pair pipeline")
    f.add_argument("granule")
    f.add_argument("s2_stack")
    f.add_argument("out_dir")
    f.add_argument("--mask", default=None,
                   help="EMIT L2A mask granule applied before fusion")
    f.add_argument("--degree", type=int, default=4)
    f.add_argument("--tile-size", type=int, default=100)
    f.add_argument("--max-black-frac", type=float, default=0.0)
    f.add_argument("--max-tiles", type=int, default=None)
    f.add_argument("--no-sr", action="store_true")
    f.add_argument("--coreg", action="store_true",
                   help="coregister the S2 stack to the EMIT reference "
                        "before fusion")
    f.add_argument("--sr-cube", action="store_true",
                   help="also predict and archive the full 10 m "
                        "spectral-SR cube")
    f.set_defaults(fn=_cmd_fuse)

    t = sub.add_parser("tiles", help="paired tiling")
    t.add_argument("emit")
    t.add_argument("s2")
    t.add_argument("out_dir")
    t.add_argument("--tile-size", type=int, default=100)
    t.add_argument("--scale", type=int, default=6)
    t.add_argument("--max-black-frac", type=float, default=0.0)
    t.add_argument("--max-tiles", type=int, default=None)
    t.set_defaults(fn=_cmd_tiles)

    c = sub.add_parser("coreg", help="coregister S2 to EMIT")
    c.add_argument("--emit-ref", required=True)
    c.add_argument("--s2", required=True)
    c.add_argument("--nc", required=True)
    c.add_argument("--out", required=True)
    c.set_defaults(fn=_cmd_coreg)

    s = sub.add_parser("scene", help="fabricate a synthetic demo scene")
    s.add_argument("out_dir")
    s.add_argument("--raw", type=int, nargs=2, default=[96, 112])
    s.add_argument("--bands", type=int, default=64)
    s.add_argument("--s2-size", type=int, default=420)
    s.set_defaults(fn=_cmd_scene)

    b = sub.add_parser("batch", help="run the pair pipeline over a JSON "
                                     "job list (resumable)")
    b.add_argument("jobs", help="JSON list of {pair_id, emit_nc_path, "
                                "s2_stack_tif}")
    b.add_argument("out_dir")
    b.add_argument("--retries", type=int, default=1)
    b.add_argument("--no-resume", action="store_true")
    b.set_defaults(fn=_cmd_batch)

    r = sub.add_parser("srf", help="import measured Sentinel-2 SRF "
                                   "tables for offline use")
    r.add_argument("src", nargs="?", default=None,
                   help="SRF workbook .xlsx or CSV sheet export")
    r.add_argument("--fetch", action="store_true",
                   help="download the official Copernicus workbook first")
    r.add_argument("--url", default=None,
                   help="override the workbook URL for --fetch (e.g. an "
                        "institutional mirror)")
    r.add_argument("--platforms", nargs="+", default=["S2A", "S2B"])
    r.add_argument("--dest", default="user",
                   help="'user' cache, 'package' data dir, or a directory")
    r.set_defaults(fn=_cmd_srf)

    v = sub.add_parser("verify-granule",
                       help="shipped-vs-exact parity harness on one "
                            "EMIT/S2 pair (markdown + JSON report)")
    v.add_argument("granule", help="EMIT L2A_RFL .nc")
    v.add_argument("s2_stack", help="Sentinel-2 10 m stack GeoTIFF")
    v.add_argument("out_dir")
    v.add_argument("--mask", default=None, help="EMIT L2A_MASK .nc")
    v.add_argument("--s2-scale", type=float, default=1e-4)
    v.add_argument("--cube-psnr-gate", type=float, default=40.0)
    v.add_argument("--fused-psnr-gate", type=float, default=40.0)
    v.add_argument("--pipeline-psnr-gate", type=float, default=40.0)
    v.set_defaults(fn=_cmd_verify_granule)

    i = sub.add_parser("info", help="raster geometry summaries")
    i.add_argument("rasters", nargs="+")
    i.set_defaults(fn=_cmd_info)

    q = sub.add_parser("quicklook", help="interactive single-file HTML "
                       "cube viewer (band browser, RGB, spectra)")
    q.add_argument("raster", help=".nc granule, ENVI .hdr, or GeoTIFF")
    q.add_argument("out", help="output .html path")
    q.add_argument("--max-size", type=int, default=640)
    q.add_argument("--max-bands", type=int, default=96)
    q.set_defaults(fn=_cmd_quicklook)
    return p


def main(argv=None) -> int:
    from .utils import enable_compilation_cache
    enable_compilation_cache()  # persistent XLA cache: repeat CLI runs
    #                             load their programs instead of compiling
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
