"""Benchmark harness: prints ONE JSON line with rays/s vs the reference.

Headline metric: primary rays per second on the reference's own default
workload — the ``ball_scenes`` scene it ships as ``sceneid = 2``
(``Raytracing_n.cpp:43``) at reference depth (maxDepth 50,
``Raytracing_n.cpp:42``). ``vs_baseline`` is a cross-machine note, not a
target: it divides by the reference C++ renderer's CPU timing on an
earlier host (``BASELINE_MEASURED.json``; the upstream repo publishes no
numbers). Every result names its device: JAX's platform, device kind and
count, and the card's ``nvidia-smi`` name and power limit.

Usage: ``python bench.py [--scene ball_scenes] [--width 512] [--spp 16]``.
All diagnostics go to stderr; stdout carries exactly one JSON line. Any
failure (scene, engine, the triangle cell) exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "BASELINE_MEASURED.json")) as f:
    REF = json.load(f)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="ball_scenes")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=0, help="0 = square")
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--max-depth", type=int, default=50,
                    help="reference parity: maxDepth 50")
    ap.add_argument("--min-seconds", type=float, default=3.0)
    ap.add_argument("--sample-chunk", type=int, default=8)
    ap.add_argument("--engine", default="regen",
                    choices=["regen", "scan", "both"],
                    help="regen = persistent wavefront with path "
                         "regeneration; scan = fixed lax.scan over bounces "
                         "(BASELINE row 1's megakernel-vs-wavefront "
                         "comparison); both = time both, report the faster")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a jax.profiler trace of one rep to DIR")
    ap.add_argument("--matrix", action="store_true",
                    help="also sweep every renderable scene (triangle-heavy "
                         "ones included) at a smaller size and report "
                         "per-scene rays/s + path-vertices/s")
    ap.add_argument("--matrix-width", type=int, default=256)
    ap.add_argument("--matrix-spp", type=int, default=8)
    ap.add_argument("--matrix-out", default=None, metavar="FILE",
                    help="also write the matrix joined against the "
                         "per-scene C++ baseline (BASELINE_CPP.json) as "
                         "a machine-checkable JSON artifact")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the persistent XLA compilation cache")
    ap.add_argument("--wavefront", type=int, default=1 << 16,
                    help="regen wavefront lanes")
    args = ap.parse_args()
    height = args.height or args.width

    warnings.simplefilter("ignore")
    import jax
    import numpy as np

    if not args.no_cache:
        from srt.utils.cache import enable as enable_cache
        enable_cache()

    from srt import RenderConfig, render
    from srt.render.regen import render_regen
    from srt.scene.library import get_scene
    from srt.utils.device import device_info

    device = device_info()
    log(f"device: {device}")

    scene_name = args.scene
    scene, camera, info = get_scene(scene_name, aspect=args.width / height)

    config = RenderConfig(width=args.width, height=height, spp=args.spp,
                          max_depth=args.max_depth,
                          rr_start=1 << 30,  # reference parity: no roulette
                          sample_chunk=args.sample_chunk,
                          pixel_chunk=1 << 20,
                          wavefront=args.wavefront)

    engines = {"regen": render_regen, "scan": render}
    run_engines = list(engines) if args.engine == "both" else [args.engine]

    warmups = {}

    def timed(engine_name):
        """(reps, total_s, img) for one engine, each rep timed to
        block_until_ready."""
        fn = engines[engine_name]
        t0 = time.time()
        img = jax.block_until_ready(fn(scene, camera, config))
        warmups[engine_name] = round(time.time() - t0, 1)
        log(f"[{engine_name}] warmup (compile + render): "
            f"{warmups[engine_name]}s")
        reps, total = 0, 0.0
        while total < args.min_seconds and reps < 50:
            cfg = RenderConfig(**{**config.__dict__, "seed": reps + 1})
            t0 = time.time()
            img = jax.block_until_ready(fn(scene, camera, cfg))
            dt = time.time() - t0
            total += dt
            reps += 1
            log(f"[{engine_name}] rep {reps}: {dt:.2f}s")
        return reps, total, np.asarray(img)

    results = {name: timed(name) for name in run_engines}
    best = min(results, key=lambda n: results[n][1] / results[n][0])
    reps, total, img_np = results[best]

    if args.profile:
        with jax.profiler.trace(args.profile):
            jax.block_until_ready(engines[best](scene, camera, config))
        log(f"profiler trace written to {args.profile}")
    nan = int(np.isnan(img_np).sum())
    log(f"{reps} rep(s), {total:.2f}s total, mean={img_np.mean():.4f}, "
        f"nan={nan}")

    primary = args.width * height * args.spp

    def primary_for(r):
        return primary * r[0] / r[1]

    rays_per_sec = primary * reps / total
    ref_rps = float(REF.get("primary_rays_per_sec", 935137))
    result = {
        "metric": "primary_rays_per_sec",
        "value": round(rays_per_sec, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_sec / ref_rps, 3),
        "baseline_rays_per_sec": ref_rps,
        "scene": scene_name,
        "engine": best,
        "engines": {n: {"reps": r[0], "wall_s": round(r[1], 3),
                        "rays_per_sec":
                        round(primary_for(r), 1)}
                    for n, r in results.items()},
        "config": {"width": args.width, "height": height, "spp": args.spp,
                   "max_depth": args.max_depth, "reps": reps},
        "device": device,
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "wall_s": round(total, 3),
        "warmup_s": warmups,
        "nan_pixels": nan,
    }

    # One triangle-mesh scene in the artifact too (the headline scene
    # exercises the fused sphere/rect bounce; the procedural teapots add
    # the triangle BVH traversal).
    if scene_name == "ball_scenes":
        tri_scene, tri_cam, _ = get_scene("teapot_scene", aspect=1.0)
        tri_cfg = RenderConfig(width=256, height=256, spp=8,
                               max_depth=args.max_depth, rr_start=1 << 30,
                               wavefront=args.wavefront)
        jax.block_until_ready(render_regen(tri_scene, tri_cam, tri_cfg))
        t0 = time.time()
        tri_img = jax.block_until_ready(
            render_regen(tri_scene, tri_cam, tri_cfg))
        tri_dt = time.time() - t0
        result["tri_scene"] = {
            "scene": "teapot_scene", "n_tris": int(tri_scene.n_tris),
            "width": 256, "spp": 8,
            "rays_per_sec": round(256 * 256 * 8 / tri_dt, 1),
            "nan_pixels": int(np.isnan(np.asarray(tri_img)).sum())}
        log(f"[tri] teapot_scene: {result['tri_scene']}")

    if args.matrix:
        result["matrix"] = scene_matrix(args, log)
        if args.matrix_out:
            _write_matrix_artifact(args, result["matrix"], device, log)

    print(json.dumps(result), flush=True)


def _write_matrix_artifact(args, matrix, device, log):
    """Join the measured matrix with BASELINE_CPP.json -> one JSON file
    (scene -> srt rays/s, C++ rays/s, ratio) so 'beats the C++ on
    every measurable scene' is machine-checkable, not prose."""
    import datetime
    here = os.path.dirname(os.path.abspath(__file__))
    cpp = {}
    alias = {"ball_orennayar": "ball_orennayar_scenes"}
    try:
        with open(os.path.join(here, "BASELINE_CPP.json")) as f:
            for row in json.load(f)["scenes"]:
                cpp[alias.get(row["scene"], row["scene"])] = row
    except Exception as e:
        log(f"[matrix-out] no C++ baseline: {e}")
    joined = {}
    for name, entry in matrix.items():
        row = {"srt_rays_per_sec": entry.get("primary_rays_per_sec"),
               "path_vertices_per_sec": entry.get("path_vertices_per_sec"),
               "error": entry.get("error")}
        c = cpp.get(name)
        if c is not None:
            cps = c.get("rays_per_sec") or c.get("rays_per_sec_upper_bound")
            row["cpp_rays_per_sec"] = cps
            row["cpp_note"] = c.get("error")
            if cps and row["srt_rays_per_sec"]:
                row["vs_cpp"] = round(row["srt_rays_per_sec"] / cps, 2)
        joined[name] = {k: v for k, v in row.items() if v is not None}
    artifact = {
        "what": f"per-scene srt ({device['count']} x {device['kind']}, "
                f"{device['card']}) vs reference C++ "
                "(BASELINE_CPP.json, CPU of an earlier host), same workload",
        "device": device,
        "workload": {"width": args.matrix_width, "height": args.matrix_width,
                     "spp": args.matrix_spp, "max_depth": args.max_depth},
        "date": datetime.date.today().isoformat(),
        "scenes": joined,
    }
    with open(args.matrix_out, "w") as f:
        json.dump(artifact, f, indent=1)
    log(f"[matrix-out] wrote {args.matrix_out}")


def scene_matrix(args, log):
    """Per-scene regen throughput sweep (VERDICT r2 item 3): every scene the
    assets allow, triangle-heavy ones included, with path-vertices/s (the
    honest work metric — primary rays/s hides depth differences)."""
    import numpy as np

    from srt.render.regen import render_regen
    from srt.render.api import RenderConfig
    from srt.scene.library import get_scene, list_scenes

    w = args.matrix_width
    out = {}
    for name in list_scenes():
        try:
            scene, camera, info = get_scene(name, aspect=1.0)
        except Exception as e:
            out[name] = {"error": f"{type(e).__name__}: {e}"}
            continue
        if info.get("skipped"):
            out[name] = {"skipped_assets": info["skipped"]}
        cfg = RenderConfig(width=w, height=w, spp=args.matrix_spp,
                           max_depth=args.max_depth, rr_start=1 << 30)
        try:
            t0 = time.time()
            img, m = render_regen(scene, camera, cfg, metrics=True)
            img = np.asarray(img)
            warm = time.time() - t0
            t0 = time.time()
            img, m = render_regen(scene, camera,
                                  RenderConfig(**{**cfg.__dict__,
                                                  "seed": 1}), metrics=True)
            img = np.asarray(img)
            dt = time.time() - t0
            entry = out.setdefault(name, {})
            entry.update({
                "n_tris": int(scene.n_tris),
                "primary_rays_per_sec": round(w * w * args.matrix_spp / dt, 1),
                "path_vertices_per_sec": round(m.path_vertices / dt, 1),
                "wall_s": round(dt, 2), "warmup_s": round(warm, 1),
                "nan_pixels": int(np.isnan(img).sum()),
                "mean": round(float(img.mean()), 4),
            })
            log(f"[matrix] {name}: {entry}")
        except Exception as e:
            out.setdefault(name, {})["error"] = f"{type(e).__name__}: {e}"
            log(f"[matrix] {name} FAILED: {e}")
    return out


if __name__ == "__main__":
    main()
