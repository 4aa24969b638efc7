"""Golden-image PSNR harness (BASELINE row 2).

Renders a reference scene at the goldens' 500x500 resolution and compares
against the reference's checked-in PPMs (``/root/reference/results/``,
SURVEY §4 — the reference's only verification artifacts). Also writes our
own golden alongside for regression tracking.

Usage:
    python tools/golden.py [--scene soldier_scene] [--spp 128]
        [--golden /root/reference/results/20200630_soldier_sky4_floor.ppm]
        [--out-dir goldens/] [--engine regen]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_GOLDEN = "/root/reference/results/20200630_soldier_sky4_floor.ppm"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="soldier_scene")
    ap.add_argument("--spp", type=int, default=128)
    ap.add_argument("--size", type=int, default=500)
    ap.add_argument("--max-depth", type=int, default=50)
    ap.add_argument("--golden", default=DEFAULT_GOLDEN)
    ap.add_argument("--out-dir", default="goldens")
    ap.add_argument("--engine", default="regen", choices=["regen", "scan"])
    ap.add_argument("--downsample", type=int, default=4)
    ap.add_argument("--ref-parity", action="store_true",
                    help="reproduce reference behaviors that shape its "
                         "goldens: first-mesh-only model loading and the "
                         "as-implemented Beckmann/Oren-Nayar estimator")
    ap.add_argument("--pdf-floor", type=float, default=1e-9,
                    help="mixture-pdf cutoff; 1e-4 suppresses fireflies")
    ap.add_argument("--seq-stale", action="store_true",
                    help="thread-faithful parity: render each pixel's "
                         "samples sequentially (scan engine), carrying "
                         "the heap-slot stale across samples like the "
                         "reference's per-thread ns loop")
    ap.add_argument("--parity-no-stale", action="store_true",
                    help="diagnostic: zero the heap-slot reads (pairs "
                         "with the zero-init C++ A/B build)")
    ap.add_argument("--save-linear", action="store_true",
                    help="also save the pre-tonemap linear radiance .npy")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out-name", default=None,
                    help="override the output ppm filename")
    args = ap.parse_args()

    from srt.utils.cache import enable as enable_cache
    enable_cache()

    import numpy as np

    from srt.io.image import read_ppm, write_ppm
    from srt.render import film
    from srt.render.api import RenderConfig, render
    from srt.render.regen import render_regen
    from srt.scene.library import get_scene
    from srt.utils.compare import golden_psnr

    kw = {"first_mesh_only": True} if args.ref_parity else {}
    scene, camera, info = get_scene(args.scene, aspect=1.0, **kw)
    if info.get("skipped"):
        print(f"WARNING: assets skipped: {info['skipped']}", file=sys.stderr)

    cfg = RenderConfig(width=args.size, height=args.size, spp=args.spp,
                       max_depth=args.max_depth, rr_start=1 << 30,
                       pdf_floor=args.pdf_floor,
                       ref_parity=args.ref_parity, seed=args.seed,
                       seq_stale=args.seq_stale,
                       parity_no_stale=args.parity_no_stale)
    fn = render_regen if args.engine == "regen" and not args.seq_stale \
        else render
    t0 = time.time()
    img = np.asarray(fn(scene, camera, cfg))
    wall = time.time() - t0
    tm = np.asarray(film.tonemap(img))

    os.makedirs(args.out_dir, exist_ok=True)
    name = args.out_name or f"{args.scene}_{args.size}.ppm"
    ours_path = os.path.join(args.out_dir, name)
    write_ppm(ours_path, tm)
    if args.save_linear:
        # pre-tonemap float radiance: chunk averaging must happen in
        # UNCLAMPED linear space — a firefly that saturates one chunk's
        # 8-bit tonemap loses energy the golden's single high-spp
        # accumulation keeps (the round-5 low-roughness-row residual)
        np.save(ours_path.replace(".ppm", "_lin.npy"), img)

    result = {"scene": args.scene, "spp": args.spp, "size": args.size,
              "pdf_floor": args.pdf_floor,
              "max_depth": args.max_depth, "wall_s": round(wall, 1),
              "ours": ours_path}
    if args.golden and os.path.exists(args.golden):
        gold = read_ppm(args.golden)
        result["golden"] = args.golden
        result.update(golden_psnr(tm, gold, downsample=args.downsample))
    else:
        print(f"golden {args.golden} not found; render-only run",
              file=sys.stderr)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
