"""Region-isolated golden A/B for the soldier scene (GOLDEN.md follow-up).

Segments the 500x500 frame geometrically (pinhole projection of the floor
plane and the soldier's bounds) and reports per-region mean RGB of the
tonemapped render vs the reference golden, for a set of floor variants
(see ``soldier_scene``'s ``floor_variant`` knob). This is the harness for
root-causing the floor's brightness gap: each variant isolates one
hypothesis (glass coat, Oren-Nayar vs Lambert, box vs rect floor).

Usage:
    python tools/regions.py [--spp 64] [--variants ref nocoat lambert]
        [--no-soldier] [--ref-parity]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GOLDEN = "/root/reference/results/20200630_soldier_sky4_floor.ppm"


def masks(size: int):
    """(floor, sky, soldier) boolean masks from the scene's camera geometry.

    Pinhole rays (aperture ignored — bokeh only blurs region *edges*, which
    we erode away): camera at (300,500,-800) looking at (300,278,200),
    vfov 40, square aspect (Raytracing_n.cpp:587-592).
    """
    import numpy as np

    lookfrom = np.array([300.0, 500.0, -800.0])
    lookat = np.array([300.0, 278.0, 200.0])
    vup = np.array([0.0, 1.0, 0.0])
    vfov = 40.0
    half_h = np.tan(np.radians(vfov) / 2)
    w = lookfrom - lookat
    w /= np.linalg.norm(w)
    u = np.cross(vup, w)
    u /= np.linalg.norm(u)
    v = np.cross(w, u)

    js, is_ = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    # row j of the image is t = (size-1-j)/size of the film plane.
    s = (is_ + 0.5) / size
    t = ((size - 1 - js) + 0.5) / size
    d = ((2 * s - 1)[..., None] * half_h * u
         + (2 * t - 1)[..., None] * half_h * v - w)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    # Floor plane y = 0.1, bounded to the boxes' [0,600]^2 footprint.
    dy = d[..., 1]
    tt = (0.1 - lookfrom[1]) / np.where(np.abs(dy) < 1e-9, 1e-9, dy)
    p = lookfrom + tt[..., None] * d
    floor = (dy < 0) & (p[..., 0] >= 0) & (p[..., 0] <= 600) \
        & (p[..., 2] >= 0) & (p[..., 2] <= 600)
    sky = ~floor

    # Soldier bounds: mesh scaled x8, rotated 180, at (250,0,300) — covers
    # roughly x in [150,400], y in [0,420], z in [230,380]. Project the box
    # by sampling: a pixel is "soldier" if its ray passes within the box.
    lo = np.array([140.0, -10.0, 220.0])
    hi = np.array([410.0, 430.0, 390.0])
    inv = 1.0 / np.where(np.abs(d) < 1e-9, 1e-9, d)
    t0 = (lo - lookfrom) * inv
    t1 = (hi - lookfrom) * inv
    tn = np.minimum(t0, t1).max(-1)
    tf = np.maximum(t0, t1).min(-1)
    soldier = (tf > np.maximum(tn, 0))

    # Erode region borders (bokeh mixes them): drop pixels within 3 px of a
    # mask edge.
    def erode(m, it=3):
        for _ in range(it):
            m = (m & np.roll(m, 1, 0) & np.roll(m, -1, 0)
                 & np.roll(m, 1, 1) & np.roll(m, -1, 1))
        return m

    floor_clean = erode(floor & ~soldier)
    sky_clean = erode(sky & ~soldier)
    return floor_clean, sky_clean, soldier


def region_stats(img_u8, floor, sky, soldier):
    import numpy as np
    a = np.asarray(img_u8, np.float64)
    return {
        "floor_rgb": [round(x, 2) for x in a[floor].mean(0)],
        "sky_rgb": [round(x, 2) for x in a[sky].mean(0)],
        "soldier_rgb": [round(x, 2) for x in a[soldier].mean(0)],
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--size", type=int, default=500)
    ap.add_argument("--max-depth", type=int, default=50)
    ap.add_argument("--variants", nargs="+", default=["ref"])
    ap.add_argument("--no-soldier", action="store_true")
    ap.add_argument("--ref-parity", action="store_true")
    ap.add_argument("--golden", default=GOLDEN)
    args = ap.parse_args()

    import numpy as np

    from srt.utils.cache import enable as enable_cache
    enable_cache()
    from srt.io.image import read_ppm, write_ppm
    from srt.render import film
    from srt.render.api import RenderConfig
    from srt.render.regen import render_regen
    from srt.scene.library import get_scene

    floor, sky, soldier = masks(args.size)
    out = {"spp": args.spp, "size": args.size,
           "regions": {"floor_px": int(floor.sum()),
                       "sky_px": int(sky.sum()),
                       "soldier_px": int(soldier.sum())}}

    if os.path.exists(args.golden):
        gold = read_ppm(args.golden)
        out["golden"] = region_stats(gold, floor, sky, soldier)

    cfg = RenderConfig(width=args.size, height=args.size, spp=args.spp,
                       max_depth=args.max_depth, rr_start=1 << 30,
                       ref_parity=args.ref_parity)
    for variant in args.variants:
        scene, camera, info = get_scene(
            "soldier_scene", aspect=1.0, floor_variant=variant,
            no_soldier=args.no_soldier,
            first_mesh_only=args.ref_parity)
        img = np.asarray(render_regen(scene, camera, cfg))
        tm = np.clip(np.asarray(film.tonemap(img)) * 255.99, 0, 255)
        out[variant] = region_stats(tm, floor, sky, soldier)
        path = f"goldens/regions_{variant}{'_ns' if args.no_soldier else ''}.ppm"
        os.makedirs("goldens", exist_ok=True)
        write_ppm(path, tm / 255.0)
        out[variant]["ppm"] = path
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
