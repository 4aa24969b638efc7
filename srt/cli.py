"""Command-line renderer: ``python -m srt.cli --scene cornell ...``.

Replaces the reference's recompile-to-configure globals
(``Raytracing_n.cpp:33-45``: resolution/spp/depth/sceneid are compile-time
constants and the output path is a hardcoded ``ofstream``) with a proper
CLI over the scene library. Writes the reference-compatible ASCII ``P3``
PPM (``Raytracing_n.cpp:886``) or PNG, picked by the output extension.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import warnings


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="srt", description="wavefront path tracer")
    ap.add_argument("--scene", default="cornell_boxes",
                    help="scene name or alias (see --list-scenes)")
    ap.add_argument("--list-scenes", action="store_true")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=0, help="default: square")
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--max-depth", type=int, default=16)
    ap.add_argument("--rr-start", type=int, default=1 << 30,
                    help="bounce index where Russian roulette starts "
                         "(default: off, reference parity)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="out.png", help=".png or .ppm")
    ap.add_argument("--max-tex", type=int, default=None,
                    help="downsample image textures to <= N px")
    ap.add_argument("--divs", type=int, default=None,
                    help="teapot tessellation override")
    ap.add_argument("--sample-chunk", type=int, default=8)
    ap.add_argument("--metrics", action="store_true",
                    help="print a JSON metrics line to stderr")
    ap.add_argument("--engine", default="regen", choices=["regen", "scan"],
                    help="regen = persistent wavefront with path "
                         "regeneration (fastest); scan = fixed "
                         "scan-over-bounces (differentiable path)")
    ap.add_argument("--checkpoint", default=None, metavar="FILE",
                    help="checkpoint radiance sums to FILE and resume from "
                         "it if present (scan engine)")
    ap.add_argument("--checkpoint-every", type=int, default=64,
                    metavar="SPP", help="spp between checkpoints")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a jax.profiler trace of the render to DIR")
    ap.add_argument("--ref-parity", action="store_true",
                    help="reproduce the reference's as-implemented "
                         "estimator (GOLDEN.md) instead of the "
                         "physically-correct one")
    ap.add_argument("--wavefront", type=int, default=1 << 16,
                    help="regen engine persistent-wavefront lanes")
    ap.add_argument("--pdf-floor", type=float, default=1e-9,
                    help="mixture-pdf cutoff (1e-4 suppresses fireflies)")
    ap.add_argument("--no-compile-cache", action="store_true")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from srt.scene.library import SCENES, get_scene
    if args.list_scenes:
        for name in SCENES:
            print(name)
        return 0

    from srt import RenderConfig, render
    from srt.io.image import write_png, write_ppm
    from srt.render import film

    height = args.height or args.width
    kw = {}
    if args.max_tex is not None:
        kw["max_tex"] = args.max_tex
    if args.divs is not None:
        kw["divs"] = args.divs
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        scene, camera, info = get_scene(args.scene,
                                        aspect=args.width / height, **kw)
    for w in caught:
        print(f"warning: {w.message}", file=sys.stderr)

    if not args.no_compile_cache:
        from srt.utils.cache import enable as enable_cache
        enable_cache()

    config = RenderConfig(width=args.width, height=height, spp=args.spp,
                          max_depth=args.max_depth, rr_start=args.rr_start,
                          seed=args.seed, sample_chunk=args.sample_chunk,
                          ref_parity=args.ref_parity,
                          wavefront=args.wavefront,
                          pdf_floor=args.pdf_floor)

    import contextlib

    import jax
    import numpy as np

    if args.profile:
        prof = jax.profiler.trace(args.profile)
    else:
        prof = contextlib.nullcontext()

    m = None
    t0 = time.time()
    with prof:
        if args.checkpoint:
            from srt.utils.checkpoint import render_resumable
            img = render_resumable(scene, camera, config, args.checkpoint,
                                   ckpt_every_spp=args.checkpoint_every)
        elif args.engine == "regen":
            from srt.render.regen import render_regen
            out = render_regen(scene, camera, config, metrics=args.metrics)
            img = out[0] if args.metrics else out
            m = out[1] if args.metrics else None
        else:
            out = render(scene, camera, config, metrics=args.metrics)
            img = out[0] if args.metrics else out
            m = out[1] if args.metrics else None
        img = jax.block_until_ready(img)
    wall = time.time() - t0
    img_np = np.asarray(img)
    tonemapped = np.asarray(film.tonemap(img))
    if args.out.lower().endswith(".ppm"):
        write_ppm(args.out, tonemapped)
    else:
        write_png(args.out, tonemapped)

    nan = int(np.isnan(img_np).sum())
    rays = args.width * height * args.spp
    print(f"{args.scene}: {args.width}x{height} spp={args.spp} "
          f"depth<={args.max_depth} in {wall:.1f}s "
          f"({rays / wall:,.0f} primary rays/s) -> {args.out}",
          file=sys.stderr)
    if args.metrics:
        line = {
            "scene": args.scene, "engine": args.engine,
            "wall_s": round(wall, 3),
            "primary_rays_per_sec": round(rays / wall, 1),
            "nan_pixels": nan, "mean": float(img_np.mean()),
            "skipped_assets": info.get("skipped", []),
        }
        if m is not None:
            line.update(m.to_dict())
        print(json.dumps(line), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
