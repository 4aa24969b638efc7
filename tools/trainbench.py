"""Differentiable-path throughput benchmark (VERDICT r2 item 4).

Times one inverse-rendering train step (forward + backward + optimizer)
with each differentiable engine:

* ``scan``  — the lockstep ``lax.scan`` integrator (every lane marches all
  ``max_depth`` bounces; round-2 measured 104k rays/s at depth 50);
* ``regen`` — the reverse-differentiable regeneration engine
  (``render/regen_scan.py``): persistent wavefront + static step budget.

Prints one JSON line with rays/s per engine and the speedup.

Usage: python tools/trainbench.py [--width 128] [--spp 4] [--max-depth 50]
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
    ap.add_argument("--scene", default="ball_scenes")
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--max-depth", type=int, default=50)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--engines", nargs="+", default=["regen", "scan"])
    # defaults: the step budget tuned for the kernel-backward path on the
    # earlier accelerator; not yet re-swept on the GPU (ROADMAP §1 item 6)
    ap.add_argument("--wavefront", type=int, default=1 << 14)
    ap.add_argument("--depth-budget", type=float, default=4.0)
    ap.add_argument("--drain", type=int, default=12)
    ap.add_argument("--unroll", type=int, default=16,
                    help="bounces per scanned (and, for the pure-XLA "
                         "bounce, checkpointed) step (regen engine)")
    args = ap.parse_args()

    from srt.utils.cache import enable as enable_cache
    enable_cache()

    import jax
    import numpy as np
    import optax

    from srt.diff.inverse import make_train_step
    from srt.scene.library import get_scene
    from srt.utils.device import device_info

    scene, camera, _ = get_scene(args.scene, aspect=1.0)
    w = args.width
    rays = w * w * args.spp

    target = np.full((w, w, 3), 0.3, np.float32)
    optimizer = optax.adam(1e-2)
    out = {"metric": "train_step_rays_per_sec", "scene": args.scene,
           "width": w, "spp": args.spp, "max_depth": args.max_depth,
           "device": device_info(), "engines": {}}

    for engine in args.engines:
        params = {"tex_color": scene.tex_color}
        opt_state = optimizer.init(params)
        ekw = (dict(wavefront=args.wavefront,
                    depth_budget=args.depth_budget, drain=args.drain,
                    unroll=args.unroll)
               if engine == "regen" else None)
        step = make_train_step(scene, camera, optimizer, width=w, height=w,
                               spp=args.spp, max_depth=args.max_depth,
                               engine=engine, engine_kw=ekw)
        t0 = time.time()
        params, opt_state, loss = jax.block_until_ready(
            step(params, opt_state, target, 0))
        warm = time.time() - t0
        t0 = time.time()
        for r in range(args.reps):
            params, opt_state, loss = jax.block_until_ready(
                step(params, opt_state, target, r + 1))
        dt = (time.time() - t0) / args.reps
        loss = float(loss)
        out["engines"][engine] = {
            "rays_per_sec": round(rays / dt, 1),
            "step_wall_s": round(dt, 3), "warmup_s": round(warm, 1),
            "loss": round(loss, 5)}
        print(f"[trainbench] {engine}: {out['engines'][engine]}",
              file=sys.stderr, flush=True)

    if len(out["engines"]) == 2 and all(
            e in out["engines"] for e in ("regen", "scan")):
        out["speedup_regen_vs_scan"] = round(
            out["engines"]["regen"]["rays_per_sec"]
            / out["engines"]["scan"]["rays_per_sec"], 2)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
