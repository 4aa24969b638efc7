"""Per-phase timing: raygen / intersect / media / shade split (SURVEY §5).

Times each pipeline phase in isolation on a fixed wavefront by jitting
progressively larger prefixes of one bounce and differencing:

  raygen           camera.rays for W lanes
  + intersect      intersect_scene (spheres/rects + triangle BVH)
  + full bounce    bounce_step (adds media, emission, NEE mixture, shading)

These are the XLA reference paths (kernels off). Each prefix is timed to
``block_until_ready``. Prints one JSON line.

Usage: python tools/phases.py [--scene ball_scenes] [--lanes 65536]
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
    ap.add_argument("--lanes", type=int, default=1 << 16)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--loop", type=int, default=0, metavar="K",
                    help="also time each phase inside a K-iteration "
                         "lax.scan (one host sync total) — the "
                         "steady-state cost, free of per-dispatch "
                         "overhead")
    args = ap.parse_args()

    from srt.utils.cache import enable as enable_cache
    enable_cache()

    import jax
    import jax.numpy as jnp

    from srt.core.rng import RaySampler
    from srt.render.integrator import bounce_step
    from srt.render.intersect import intersect_scene
    from srt.scene.ir import SceneFlags
    from srt.scene.library import get_scene

    scene, camera, _ = get_scene(args.scene, aspect=1.0)
    flags = SceneFlags.of(scene)
    n = args.lanes
    pix = jnp.arange(n, dtype=jnp.int32) % (512 * 512)
    samp = jnp.zeros((n,), jnp.int32)
    sampler = RaySampler.create(0, pix, samp)

    @jax.jit
    def raygen(seed):
        s = RaySampler.create(seed, pix, samp)
        u = (pix % 512).astype(jnp.float32) / 512
        v = (pix // 512).astype(jnp.float32) / 512
        return camera.rays(u, v, s.uniform(32), s.uniform(33),
                           s.uniform(34))

    rays0 = raygen(0)

    @jax.jit
    def isect(scene, rays):
        h = intersect_scene(scene, rays, 1e-3, 3.0e38, flags)
        return h.t, h.mat

    @jax.jit
    def bounce(scene, rays, salt):
        st = dict(o=rays.origin, d=rays.direction, time=rays.time,
                  beta=jnp.ones((n, 3), jnp.float32),
                  radiance=jnp.zeros((n, 3), jnp.float32),
                  alive=jnp.ones((n,), bool), salt=salt,
                  depth=jnp.zeros((n,), jnp.int32))
        out = bounce_step(scene, st, 50, 1 << 30, flags)
        return out["radiance"], out["beta"], out["d"]

    def timeit(fn, *a):
        jax.block_until_ready(fn(*a))  # compile+warm
        t0 = time.time()
        for _ in range(args.reps):
            out = fn(*a)
        jax.block_until_ready(out)
        return (time.time() - t0) / args.reps

    t_raygen = timeit(raygen, 1)
    t_isect = timeit(isect, scene, rays0)
    t_bounce = timeit(bounce, scene, rays0, sampler.salt)

    out = {
        "metric": "phase_seconds_per_wavefront",
        "scene": args.scene, "lanes": n,
        "device": jax.devices()[0].device_kind,
        "raygen_s": round(t_raygen, 5),
        "intersect_s": round(t_isect, 5),
        "bounce_s": round(t_bounce, 5),
        "shade_s(est bounce - intersect)": round(t_bounce - t_isect, 5),
        "lanes_per_sec_bounce": round(n / t_bounce, 1),
    }

    if args.loop:
        k = args.loop

        @jax.jit
        def isect_loop(scene, rays):
            def body(c, _):
                h = intersect_scene(
                    scene, rays._replace(
                        origin=rays.origin + c[:, None] * 1e-6),
                    1e-3, 3.0e38, flags)
                return c + h.t * 0.0 + 1.0, None
            c, _ = jax.lax.scan(body, jnp.zeros((n,), jnp.float32),
                                None, length=k)
            return c

        @jax.jit
        def bounce_loop(scene, rays, salt):
            st = dict(o=rays.origin, d=rays.direction, time=rays.time,
                      beta=jnp.ones((n, 3), jnp.float32),
                      radiance=jnp.zeros((n, 3), jnp.float32),
                      alive=jnp.ones((n,), bool), salt=salt,
                      depth=jnp.zeros((n,), jnp.int32))

            def body(st, _):
                nxt = bounce_step(scene, st, 1 << 30, 1 << 30, flags)
                nxt["alive"] = jnp.ones((n,), bool)  # keep lanes hot
                return nxt, None
            st, _ = jax.lax.scan(body, st, None, length=k)
            return st["radiance"]

        t_il = timeit(isect_loop, scene, rays0) / k
        t_bl = timeit(bounce_loop, scene, rays0, sampler.salt) / k
        out["loop_k"] = k
        out["loop_intersect_s"] = round(t_il, 6)
        out["loop_bounce_s"] = round(t_bl, 6)
        out["loop_shade_s"] = round(t_bl - t_il, 6)
        out["loop_lanes_per_sec_bounce"] = round(n / t_bl, 1)

        # Shading sub-phases, same in-loop method: each shading component
        # iterated K times with a data dependence to defeat CSE.
        from srt.materials import materials as mats
        from srt.render import lights as lg

        mat_ids = jnp.zeros((n,), jnp.int32)
        normal = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32),
                          (n, 1))
        uv = jnp.zeros((n, 2), jnp.float32)

        def sub_loop(fn):
            @jax.jit
            def run(scene, rays, salt):
                s = RaySampler(salt=salt)

                def body(c, i):
                    r = fn(scene, rays, s.fold(i), c)
                    return c + r * 1e-12, None
                c, _ = jax.lax.scan(body, jnp.zeros((n,), jnp.float32),
                                    jnp.arange(k), length=k)
                return c
            return run

        def f_sample(scene, rays, s, c):
            wi = mats.sample_bsdf(scene, mat_ids, normal, rays.direction,
                                  s.uniform(14) + c * 0, s.uniform(15),
                                  flags)
            return wi[:, 0]

        def f_pdf(scene, rays, s, c):
            wi = rays.direction * jnp.asarray([1.0, 1.0, -1.0])
            return mats.bsdf_pdf(scene, mat_ids, normal, rays.direction,
                                 wi + c[:, None] * 1e-12, flags)

        def f_weight(scene, rays, s, c):
            wi = rays.direction * jnp.asarray([1.0, 1.0, -1.0])
            w = mats.bsdf_weight(scene, mat_ids, uv, rays.origin, normal,
                                 rays.direction, wi + c[:, None] * 1e-12,
                                 flags)
            return w[:, 0]

        def f_lights(scene, rays, s, c):
            if scene.n_lights == 0:
                return c
            wi = lg.sample_lights(scene, rays.origin + c[:, None] * 1e-12,
                                  s.uniform(13), s.uniform(14),
                                  s.uniform(15))
            return lg.lights_pdf(scene, rays.origin, wi)

        def f_rng(scene, rays, s, c):
            acc = c
            for dim in range(8, 20):
                acc = acc + s.uniform(dim)
            return acc

        for name, fn in [("sample_bsdf", f_sample), ("bsdf_pdf", f_pdf),
                         ("bsdf_weight", f_weight), ("lights", f_lights),
                         ("rng12", f_rng)]:
            out[f"loop_{name}_s"] = round(
                timeit(sub_loop(fn), scene, rays0, sampler.salt) / k, 6)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
