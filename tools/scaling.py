"""Scaling-efficiency harness (BASELINE row 4, VERDICT r2 item 7).

Measures rays/s of the sharded render path vs device count. On a host
with several GPUs it sweeps the real cards; on a virtual CPU mesh
(``XLA_FLAGS=--xla_force_host_platform_device_count=N JAX_PLATFORMS=cpu``)
the *semantics* and the code path (``dist/sharding.render_sharded``: pixel
axis sharded, scene replicated) are the same, and the timings measure
overhead structure only.

Usage (set the device count before jax imports):
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python tools/scaling.py [--scene cornell_boxes] [--width 128]
        [--spp 8] [--devices 1 2 4 8]

Prints one JSON line: per-device-count rays/s + efficiency vs linear.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="cornell_boxes")
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--max-depth", type=int, default=8)
    ap.add_argument("--devices", type=int, nargs="+", default=None,
                    help="device counts to sweep (default: 1,2,4,..,all)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    from srt.utils.cache import enable as enable_cache
    enable_cache()

    import jax
    import numpy as np

    from srt.dist.sharding import make_mesh, render_sharded
    from srt.render.api import RenderConfig
    from srt.scene.library import get_scene

    n_avail = len(jax.devices())
    counts = args.devices
    if counts is None:
        counts, c = [], 1
        while c <= n_avail:
            counts.append(c)
            c *= 2
    counts = [c for c in counts if c <= n_avail]

    scene, camera, _ = get_scene(args.scene, aspect=1.0)
    cfg = RenderConfig(width=args.width, height=args.width, spp=args.spp,
                       max_depth=args.max_depth, rr_start=1 << 30,
                       sample_chunk=args.spp)
    primary = args.width * args.width * args.spp

    rows = {}
    img1 = None
    for c in counts:
        mesh = make_mesh(c)
        # warmup/compile
        img = np.asarray(jax.block_until_ready(
            render_sharded(scene, camera, cfg, mesh)))
        if img1 is None:
            img1 = img
        else:
            # 1-device vs N-device bit-identity (pure counter RNG)
            bit_exact = bool(np.array_equal(img1, img))
        t0 = time.time()
        for r in range(args.reps):
            img = render_sharded(
                scene, camera,
                RenderConfig(**{**cfg.__dict__, "seed": r + 1}), mesh)
        jax.block_until_ready(img)
        dt = (time.time() - t0) / args.reps
        rows[c] = {"rays_per_sec": round(primary / dt, 1),
                   "wall_s": round(dt, 3)}
        if c != counts[0]:
            rows[c]["bit_exact_vs_1dev"] = bit_exact
        print(f"[scaling] {c} dev: {rows[c]}", file=sys.stderr, flush=True)

    base = rows[counts[0]]["rays_per_sec"] / counts[0]
    for c in counts:
        rows[c]["efficiency_vs_linear"] = round(
            rows[c]["rays_per_sec"] / (base * c), 3)

    print(json.dumps({
        "metric": "scaling_rays_per_sec",
        "scene": args.scene, "width": args.width, "spp": args.spp,
        "platform": jax.devices()[0].platform,
        "devices": rows,
    }), flush=True)


if __name__ == "__main__":
    main()
