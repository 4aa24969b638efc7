#!/usr/bin/env python3
"""Smoke run of the path tracer on one NVIDIA GPU (``--four``: four GPUs).

Drives the three paths users run, through the entry points they call, at
the reference's own sizes, and checks every hand-written kernel against
its plain XLA reference:

1. kernels — the fused bounce (``pallas/bounce.py``) and the per-ray
   triangle traversal (``pallas/intersect.py``), each compiled for the
   card and compared with ``integrator.bounce_step`` /
   ``intersect.tris_winner``; the train step's gradient (kernel forward,
   XLA backward) against central finite differences;
2. forward render — ``ball_scenes`` 1000x1000, 50 spp, depth 50 through
   ``render_regen`` (the reference default, ``Raytracing_n.cpp:33,39-42``),
   checked against a 16-spp render on the XLA bounce;
3. heavy mesh — ``teapot_scene(divs=100)`` (1.28M triangles) 512x512,
   4 spp, depth 50;
4. train step — ``make_train_step`` on ``ball_scenes`` (tex_color) and on
   ``fog_scene`` (Beckmann mat_params), 5 steps each;
5. CLI — ``srt.cli.main`` on ``cornell_boxes`` 256x256, 16 spp.

``--four`` runs only the four-GPU path: a sharded 1000x1000 16-spp render
and one sharded train step, each compared with the same work on one GPU.

Every phase runs in this one process (a second JAX process could not get
the card's memory). The script refuses to run without a GPU, exits
non-zero if any phase fails, and prints as its last line
``{"ok": true, "device": {...}}``. Usage::

    python chip_smoke.py            # one GPU, phases 1-5
    python chip_smoke.py --four     # four GPUs, sharded render + train step
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import sys
import time
import traceback

# --- tolerances (each with its reason; PERF.md repeats them) --------------
# Fused bounce vs bounce_step, per bounce on identical input state. The two
# programs compute the same estimator with the same RNG slots, but the card
# runs Triton's and XLA's own fma contraction and transcendentals; a
# last-bit difference can flip a knife-edge branch (the Beckmann VNDF
# ``cosThetaI > 0.9999`` split, a Russian-roulette or grazing-hit test) on
# a sliver of lanes, which then resamples that lane's path.
BOUNCE_ALIVE_AGREE = 0.999     # alive and depth equal on >= 99.9% of lanes
BOUNCE_RTOL = 1e-4             # radiance/beta relative agreement ...
BOUNCE_ATOL = 1e-6             # ... with an absolute floor for ~0 values,
BOUNCE_CLOSE_FRAC = 0.999      # on >= 99.9% of the lanes that agree
# Traversal kernel vs intersect_tris: same traversal order and formulas;
# fma contraction moves t by ulps, which can flip the winner between two
# triangles at (nearly) equal t (shared edges of the 1.28M-triangle mesh).
TRI_ID_AGREE = 0.999
TRI_T_RTOL = 1e-5
# The train step's gradient vs central finite differences of the same loss
# (same random stream on both sides, so FD is exact up to O(eps^2) and
# float32 rounding of the loss).
FD_EPS = 3e-3        # crosses no sampler knife edge at this size
FD_RTOL = 0.05
FD_ATOL = 2e-4
# Forward render vs the 16-spp XLA-bounce render: per-pixel difference of
# two unbiased estimates of the same image; its mean over independent
# pixels must lie within FWD_Z standard errors of zero.
FWD_Z = 5.0
# Sharded (4 GPU) vs single-GPU. The render's first reference is the same
# program on one GPU over pixel chunks of the shard size, so it is
# expected bit-identical (counter RNG, deterministic sums). Its second is
# render_sharded on one GPU, one chunk of all pixels. On one card alone,
# render() with quarter-image chunks reads 0.24% brighter than with one
# chunk (21 paired standard errors), in the kernel and the XLA path alike,
# while one chunk agrees with render_regen to 1e-9. The same chunk-size
# shift therefore separates the sharded image from the one-chunk one, and
# a paired z-test cannot pass. Its image mean is held to twice that shift
# instead: a lost or doubled strip moves it by >= 20%, and the bit-identity
# above catches a misplaced one.
SHARD_MEAN_RTOL = 5e-3
# The train step's one-GPU reference runs one queue of all pixels: a
# last-bit difference flips knife-edge sampler branches on a sliver of
# paths, and each flip resamples its path. On the card its loss read 0.09%
# and its largest gradient difference 0.33% of the largest gradient entry
# away, and one flipped firefly path moves a 4-spp loss by several per
# cent, so the limits are set at about ten times those readings.
SHARD_LOSS_RTOL = 1e-2
SHARD_GRAD_TOL = 3e-2          # of the largest gradient entry


class Log:
    """Prints ``[phase] key=value ...`` lines, each tagged with the card."""

    def __init__(self, card: str, out=sys.stdout):
        self.card = card
        self.out = out
        self.records: dict = {}

    def __call__(self, phase: str, **kv) -> None:
        self.records.setdefault(phase, {}).update(kv)
        body = " ".join(f"{k}={v}" for k, v in kv.items())
        print(f"[{phase}] {body} | card: {self.card}", file=self.out,
              flush=True)


def _sync(x):
    import jax
    return jax.block_until_ready(x)


def _compile(log, phase, name, fn, *args):
    """AOT-compile ``fn(*args)``; log compile seconds and memory analysis."""
    import jax
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    mem = compiled.memory_analysis()
    log(phase, **{f"{name}_compile_s": round(time.perf_counter() - t0, 3),
                  f"{name}_memory": _mem_str(mem)})
    return compiled


def _mem_str(mem) -> str:
    if mem is None:
        return "n/a"
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return ",".join(f"{k.split('_size')[0]}:{getattr(mem, k, 'n/a')}"
                    for k in keys)


def _time_call(fn, *args, reps: int = 5) -> float:
    """Mean seconds per call of a compiled ``fn``, warm, to
    block_until_ready."""
    _sync(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / reps


@functools.cache
def _scene(name: str, **kw):
    """Library scene, built once per process (the 1.28M-triangle teapot's
    BVH build is host work shared by two phases)."""
    from srt.scene.library import get_scene
    return get_scene(name, aspect=1.0, **kw)


def _peak_bytes() -> int | str:
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use", "n/a")


# ---------------------------------------------------------------------------
# phase 1: kernels vs their references
# ---------------------------------------------------------------------------

def _camera_state(scene, cam, side: int, seed: int = 0):
    """Fresh wavefront state: one camera ray per pixel of a side^2 film."""
    import jax.numpy as jnp

    from srt.core.rng import RaySampler
    n = side * side
    pix = jnp.arange(n, dtype=jnp.int32)
    sampler = RaySampler.create(seed, pix, jnp.zeros(n, jnp.int32))
    s = ((pix % side).astype(jnp.float32) + 0.5) / side
    t = ((pix // side).astype(jnp.float32) + 0.5) / side
    rays = cam.rays(s, t, sampler.uniform(32), sampler.uniform(33),
                    sampler.uniform(34))
    return dict(o=rays.origin, d=rays.direction, time=rays.time,
                beta=jnp.ones((n, 3), jnp.float32),
                radiance=jnp.zeros((n, 3), jnp.float32),
                alive=jnp.ones(n, bool), salt=sampler.salt,
                depth=jnp.zeros(n, jnp.int32))


def check_bounce(log, mode: str, side: int = 256, bounces: int = 4,
                 close_frac: float = BOUNCE_CLOSE_FRAC):
    """Fused bounce vs ``bounce_step`` on ``ball_scenes``: ``side``^2 lanes,
    ``bounces`` successive bounces of real state (each compared on the
    same input, then advanced along the XLA trajectory)."""
    import numpy as np

    from srt.pallas.bounce import fused_bounce
    from srt.render.integrator import bounce_step
    from srt.scene.ir import SceneFlags

    scene, cam, _ = _scene("ball_scenes")
    flags = SceneFlags.of(scene)
    state = _camera_state(scene, cam, side)
    step_x = _compile(log, "kernels", "bounce_xla", functools.partial(
        bounce_step, max_depth=50, rr_start=1 << 30, flags=flags),
        scene, state)
    step_k = _compile(log, "kernels", "bounce_kernel", functools.partial(
        fused_bounce, max_depth=50, rr_start=1 << 30, flags=flags,
        mode=mode), scene, state)
    failures = []
    for b in range(bounces):
        a = step_x(scene, state)
        k = step_k(scene, state)
        agree = ((np.asarray(a["alive"]) == np.asarray(k["alive"]))
                 & (np.asarray(a["depth"]) == np.asarray(k["depth"])))
        both_alive = agree & np.asarray(a["alive"])
        fr = float(agree.mean())
        stats = {"lanes": int(agree.size), "alive_depth_agree": fr}
        for key in ("radiance", "beta"):
            x, y = np.asarray(a[key]), np.asarray(k[key])
            ok = np.all(np.abs(x - y) <= BOUNCE_ATOL + BOUNCE_RTOL
                        * np.abs(x), axis=-1)
            # beta of dead lanes is don't-care state
            lanes = agree if key == "radiance" else both_alive
            stats[f"{key}_close"] = float(ok[lanes].mean()) \
                if lanes.any() else 1.0
        log("kernels", **{f"bounce{b}_{k_}": v for k_, v in stats.items()})
        if fr < BOUNCE_ALIVE_AGREE:
            failures.append(f"bounce {b}: alive/depth agree {fr}")
        for key in ("radiance", "beta"):
            if stats[f"{key}_close"] < close_frac:
                failures.append(f"bounce {b}: {key} close "
                                f"{stats[key + '_close']}")
        state = a
    log("kernels", bounce_xla_ms=round(1e3 * _time_call(step_x, scene,
                                                         state), 3),
        bounce_kernel_ms=round(1e3 * _time_call(step_k, scene, state), 3))
    return failures


def check_traversal(log, mode: str, divs: int = 100, side: int = 256):
    """Traversal kernel vs ``intersect_tris`` on ``teapot_scene(divs)``:
    ``side``^2 camera rays plus one diffuse bounce from their hits."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from srt.core.ray import Ray
    from srt.core.rng import RaySampler
    from srt.pallas.intersect import intersect_tris_kernel
    from srt.render.intersect import (intersect_tris,
                                      intersect_tris_via_kernel, tris_winner)
    from srt.scene.ir import SceneFlags

    scene, cam, _ = _scene("teapot_scene", divs=divs)
    leaf = SceneFlags.of(scene).bvh_leaf
    log("kernels", teapot_tris=int(scene.n_tris),
        teapot_nodes=int(scene.n_bvh_nodes))
    state = _camera_state(scene, cam, side)
    ray = Ray(origin=state["o"], direction=state["d"], time=state["time"])

    def xla(sc, r):
        h = intersect_tris(sc, r, 1e-3, 3.0e38, leaf_size=leaf)
        return h.t, h.hit, h.p, h.normal

    def krn(sc, r):
        h = intersect_tris_via_kernel(sc, r, 1e-3, mode, leaf_size=leaf)
        return h.t, h.hit, h.p, h.normal

    f_x = _compile(log, "kernels", "traverse_xla", xla, scene, ray)
    f_k = _compile(log, "kernels", "traverse_kernel", krn, scene, ray)
    tri_x = jax.jit(lambda sc, r: tris_winner(sc, r, 1e-3, leaf))
    tri_k = jax.jit(lambda sc, r: intersect_tris_kernel(sc, r, 1e-3, mode,
                                                        leaf_size=leaf))

    # second ray set: a diffuse bounce from the reference's primary hits
    t, hit, p, n = f_x(scene, ray)
    s = RaySampler(salt=state["salt"]).fold(1)
    u1, u2 = s.uniform(14), s.uniform(15)
    phi = 2.0 * jnp.pi * u1
    rnd = jnp.stack([jnp.cos(phi) * jnp.sqrt(u2), jnp.sin(phi) * jnp.sqrt(u2),
                     jnp.sqrt(1.0 - u2)], axis=-1)
    d2 = n + rnd * 0.999
    d2 = d2 / jnp.linalg.norm(d2, axis=-1, keepdims=True)
    bounce = Ray(origin=jnp.where(hit[:, None], p, ray.origin),
                 direction=jnp.where(hit[:, None], d2, ray.direction),
                 time=ray.time)
    failures = []
    for name, r in (("primary", ray), ("bounce", bounce)):
        tx, _, _, ix = (np.asarray(v) for v in tri_x(scene, r))
        tk, _, _, ik = (np.asarray(v) for v in tri_k(scene, r))
        ix = np.where(tx < 3.0e38, ix, -1)
        ik = np.where(tk < 3.0e38, ik, -1)
        same = ix == ik
        hits = same & (ix >= 0)
        t_ok = np.abs(tx - tk) <= TRI_T_RTOL * np.abs(tx)
        fr = float(same.mean())
        t_fr = float(t_ok[hits].mean()) if hits.any() else 1.0
        log("kernels", **{f"tri_{name}_id_agree": fr,
                          f"tri_{name}_hit_frac": float((ix >= 0).mean()),
                          f"tri_{name}_t_close": t_fr})
        if fr < TRI_ID_AGREE:
            failures.append(f"traversal {name}: ids agree {fr}")
        if t_fr < 1.0:
            failures.append(f"traversal {name}: t close {t_fr}")
    log("kernels",
        traverse_xla_ms=round(1e3 * _time_call(f_x, scene, bounce), 3),
        traverse_kernel_ms=round(1e3 * _time_call(f_k, scene, bounce), 3))
    return failures


def check_backward(log, mode: str, side: int = 8, spp: int = 4,
                   depth: int = 4):
    """The train step's gradient — fused-kernel forward, XLA-linearization
    backward (``pallas/bounce_vjp.py``) — vs central finite differences
    of the same loss, on ``fog_scene``'s Beckmann roughness."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from srt.diff import image_loss, render_pixels

    scene, cam, _ = _scene("fog_scene")
    pixel_ids = jnp.arange(side * side, dtype=jnp.int32)
    target = render_pixels(scene, cam, pixel_ids, width=side, height=side,
                           spp=spp, max_depth=depth, seed=99,
                           pallas_mode="off")

    def f(params):
        return image_loss(params, scene, cam, target, pixel_ids,
                          width=side, height=side, spp=spp, max_depth=depth,
                          seed=7, engine_kw=dict(pallas_mode=mode))

    params = {"tex_color": scene.tex_color, "mat_params": scene.mat_params}
    vg = _compile(log, "kernels", "grad_step", jax.value_and_grad(f), params)
    loss, g = vg(params)
    loss_fn = jax.jit(f)
    mp = np.asarray(scene.mat_params)
    fd = {}
    for (i, c) in ((1, 0), (1, 1)):      # Beckmann alpha_x, alpha_y
        delta = np.zeros_like(mp)
        delta[i, c] = FD_EPS
        lp = float(loss_fn({"tex_color": scene.tex_color,
                            "mat_params": jnp.asarray(mp + delta)}))
        lm = float(loss_fn({"tex_color": scene.tex_color,
                            "mat_params": jnp.asarray(mp - delta)}))
        fd[(i, c)] = (lp - lm) / (2 * FD_EPS)
    g_m, g_t = np.asarray(g["mat_params"]), np.asarray(g["tex_color"])
    log("kernels", grad_loss=float(loss),
        grad_alpha=[float(g_m[1, 0]), float(g_m[1, 1])],
        grad_alpha_fd=[fd[(1, 0)], fd[(1, 1)]])
    failures = []
    for (i, c), v in fd.items():
        if abs(g_m[i, c] - v) > FD_ATOL + FD_RTOL * abs(v):
            failures.append(f"backward mat_params[{i},{c}] {g_m[i, c]} "
                            f"vs FD {v}")
    if not (np.isfinite(g_m).all() and np.isfinite(g_t).all()):
        failures.append("backward: non-finite gradient")
    return failures


def phase_kernels(log, mode: str, side: int = 256, bounces: int = 4,
                  divs: int = 100, bwd_side: int = 8,
                  close_frac: float = BOUNCE_CLOSE_FRAC):
    import jax
    failures = []
    with jax.default_matmul_precision("highest"):
        failures += check_bounce(log, mode, side=side, bounces=bounces,
                                 close_frac=close_frac)
        failures += check_traversal(log, mode, divs=divs, side=side)
        failures += check_backward(log, mode, side=bwd_side)
    return failures


# ---------------------------------------------------------------------------
# phases 2-3: forward renders through render_regen
# ---------------------------------------------------------------------------

def _render(log, phase, tag, scene, cam, cfg, mode, reps: int = 3):
    """render_regen once to compile, then ``reps`` timed renders (median)
    -> image of the last."""
    import numpy as np

    from srt.render.regen import render_regen
    t0 = time.perf_counter()
    _sync(render_regen(scene, cam, cfg, pallas_mode=mode))
    first = time.perf_counter() - t0
    walls = []
    for _ in range(reps):
        img, m = render_regen(scene, cam, cfg, metrics=True,
                              pallas_mode=mode)
        walls.append(m.wall_s)
    wall = float(np.median(walls))
    img = np.asarray(img)
    primary = cfg.width * cfg.height * cfg.spp
    log(phase, **{f"{tag}_compile_s": round(first - wall, 3),
                  f"{tag}_render_s": [round(w, 4) for w in walls],
                  f"{tag}_primary_rays_per_s": round(primary / wall, 1),
                  f"{tag}_path_vertices_per_s":
                      round(m.path_vertices / wall, 1),
                  f"{tag}_nan": int(np.isnan(img).sum()),
                  f"{tag}_nan_scrubbed": m.nan_scrubbed,
                  f"{tag}_mean": float(np.nanmean(img)),
                  f"{tag}_peak_bytes_in_use": _peak_bytes()})
    return img


def phase_forward(log, mode: str, width: int = 1000, spp: int = 50,
                  depth: int = 50, ref_spp: int = 16):
    import numpy as np

    from srt import RenderConfig

    scene, cam, _ = _scene("ball_scenes")
    cfg = RenderConfig(width=width, height=width, spp=spp, max_depth=depth,
                       rr_start=1 << 30)
    img = _render(log, "forward", "kernel", scene, cam, cfg, mode)
    _render(log, "forward", "xla", scene, cam, cfg, "off")
    ref_cfg = RenderConfig(width=width, height=width, spp=ref_spp,
                           max_depth=depth, rr_start=1 << 30)
    ref = _render(log, "forward", f"xla_{ref_spp}spp", scene, cam, ref_cfg,
                  "off", reps=1)
    mean_diff, stderr, z = _z_test(img, ref)
    log("forward", mean_diff=mean_diff, mean_diff_stderr=stderr, z=z)
    failures = []
    if not np.isfinite(img).all():
        failures.append("forward: non-finite image")
    if z > FWD_Z:
        failures.append(f"forward: mean differs from XLA by {z:.2f} sigma")
    return failures


def _z_test(img, ref):
    """Mean per-pixel difference of two images, its standard error over
    independent pixels, and their ratio in standard errors."""
    import numpy as np
    d = (np.asarray(img) - np.asarray(ref)).mean(axis=-1).ravel()
    stderr = float(d.std() / np.sqrt(d.size))
    mean = float(d.mean())
    if stderr == 0.0:
        return mean, stderr, 0.0 if mean == 0.0 else float("inf")
    return mean, stderr, abs(mean) / stderr


def phase_mesh(log, mode: str, divs: int = 100, width: int = 512,
               spp: int = 4, depth: int = 50):
    import numpy as np

    from srt import RenderConfig

    scene, cam, _ = _scene("teapot_scene", divs=divs)
    cfg = RenderConfig(width=width, height=width, spp=spp, max_depth=depth,
                       rr_start=1 << 30)
    img = _render(log, "mesh", "kernel", scene, cam, cfg, mode)
    _render(log, "mesh", "xla", scene, cam, cfg, "off", reps=1)
    return [] if np.isfinite(img).all() else ["mesh: non-finite image"]


# ---------------------------------------------------------------------------
# phase 4: train steps
# ---------------------------------------------------------------------------

# tools/trainbench.py's step budget, one bounce per scanned step: compile
# time grows linearly with ``unroll`` (16 took 5-6 minutes per train step
# to compile on the card, NVIDIA H100 80GB HBM3, 700 W).
TRAIN_KW = dict(wavefront=1 << 14, depth_budget=4.0, drain=12, unroll=1)


def _train(log, tag, scene, cam, params, width, spp, depth, steps,
           engine_kw):
    import numpy as np
    import optax

    from srt.diff.inverse import make_train_step
    optimizer = optax.adam(1e-2)
    opt_state = optimizer.init(params)
    target = np.full((width, width, 3), 0.3, np.float32)
    step = make_train_step(scene, cam, optimizer, width=width, height=width,
                           spp=spp, max_depth=depth, engine_kw=engine_kw)
    t0 = time.perf_counter()
    params, opt_state, loss = _sync(step(params, opt_state, target, 0))
    warm = time.perf_counter() - t0
    losses, times = [float(loss)], []
    for i in range(1, steps):
        t0 = time.perf_counter()
        params, opt_state, loss = _sync(step(params, opt_state, target, i))
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    mean_s = float(np.mean(times)) if times else float("nan")
    log("train", **{f"{tag}_first_step_s": round(warm, 3),
                    f"{tag}_step_s": round(mean_s, 4),
                    f"{tag}_rays_per_s": round(width * width * spp / mean_s,
                                               1),
                    f"{tag}_losses": [round(v, 6) for v in losses],
                    f"{tag}_peak_bytes_in_use": _peak_bytes()})
    ok = all(np.isfinite(v) for v in losses) and all(
        np.isfinite(np.asarray(v)).all() for v in params.values())
    return [] if ok else [f"train {tag}: non-finite loss or params"]


def phase_train(log, mode: str, width: int = 256, spp: int = 4,
                depth: int = 50, steps: int = 5, fog_width: int = 64,
                train_kw: dict | None = None):
    kw = dict(TRAIN_KW if train_kw is None else train_kw,
              pallas_mode=mode)
    failures = []
    scene, cam, _ = _scene("ball_scenes")
    failures += _train(log, "ball_tex_color", scene, cam,
                       {"tex_color": scene.tex_color}, width, spp, depth,
                       steps, kw)
    fscene, fcam, _ = _scene("fog_scene")
    failures += _train(log, "fog_mat_params", fscene, fcam,
                       {"mat_params": fscene.mat_params}, fog_width, spp,
                       depth, steps, kw)
    return failures


# ---------------------------------------------------------------------------
# phase 5: CLI
# ---------------------------------------------------------------------------

def phase_cli(log, width: int = 256, spp: int = 16, out_dir: str = "."):
    from srt import cli
    out = os.path.join(out_dir, "chip_smoke_cornell_boxes.png")
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["--scene", "cornell_boxes", "--width", str(width),
                       "--spp", str(spp), "--out", out, "--metrics"])
    wall = time.perf_counter() - t0
    metrics = {}
    for line in err.getvalue().splitlines():
        if line.startswith("{"):
            metrics = json.loads(line)
    log("cli", rc=rc, wall_s=round(wall, 3), out=out,
        png_bytes=os.path.getsize(out) if os.path.exists(out) else 0,
        nan_pixels=metrics.get("nan_pixels"),
        primary_rays_per_s=metrics.get("primary_rays_per_sec"))
    failures = []
    if rc != 0 or not os.path.exists(out) or os.path.getsize(out) == 0:
        failures.append("cli: no image written")
    if metrics.get("nan_pixels") != 0:
        failures.append(f"cli: nan pixels {metrics.get('nan_pixels')}")
    return failures


# ---------------------------------------------------------------------------
# --four: sharded render and train step vs one device
# ---------------------------------------------------------------------------

def phase_four(log, mode: str, n_dev: int = 4, width: int = 1000,
               spp: int = 16, depth: int = 50, train_width: int = 128,
               train_spp: int = 2, train_depth: int = 16):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from srt import RenderConfig, render
    from srt.diff.inverse import make_train_step
    from srt.dist.sharding import make_mesh, render_sharded

    failures = []
    scene, cam, _ = _scene("ball_scenes")
    cfg = RenderConfig(width=width, height=width, spp=spp, max_depth=depth,
                       rr_start=1 << 30)
    times = {}
    imgs = {}
    for c in (n_dev, 1):
        mesh = make_mesh(c)
        _sync(render_sharded(scene, cam, cfg, mesh, pallas_mode=mode))
        t0 = time.perf_counter()
        img = _sync(render_sharded(scene, cam, cfg, mesh, pallas_mode=mode))
        times[c] = time.perf_counter() - t0
        imgs[c] = img
    # the same program on one GPU, over pixel chunks of the shard size
    chunked = RenderConfig(width=width, height=width, spp=spp,
                           max_depth=depth, rr_start=1 << 30,
                           pixel_chunk=-(-width * width // n_dev))
    ref = np.asarray(render(scene, cam, chunked, pallas_mode=mode))
    shards = imgs[n_dev].addressable_shards
    devices = sorted({str(s.device) for s in shards})
    shard_means = [float(np.asarray(s.data).mean()) for s in shards]
    a, b = np.asarray(imgs[n_dev]), np.asarray(imgs[1])
    mean_diff, stderr, z = _z_test(a, b)
    mean_rel = abs(float(a.mean() - b.mean())) / abs(float(b.mean()))
    log("four", devices=len(jax.devices()), render_s_1=round(times[1], 4),
        **{f"render_s_{n_dev}": round(times[n_dev], 4)},
        speedup=round(times[1] / times[n_dev], 3),
        primary_rays_per_s=round(width * width * spp / times[n_dev], 1),
        bit_identical=bool(np.array_equal(a, ref)),
        max_abs_diff=float(np.abs(a - ref).max()),
        identical_to_one_queue=float((a == b).all(-1).mean()),
        one_queue_mean_rel_diff=mean_rel, one_queue_mean_diff=mean_diff,
        one_queue_stderr=stderr, one_queue_z=z,
        shard_devices=len(devices), shard_means=shard_means,
        nan=int(np.isnan(a).sum()))
    if not np.array_equal(a, ref):
        failures.append("four: sharded image differs from one device")
    if not np.isfinite(a).all():
        failures.append("four: non-finite image")
    if mean_rel > SHARD_MEAN_RTOL:
        failures.append(f"four: image mean {mean_rel:.2%} from one chunk")
    if len(devices) != n_dev or min(shard_means) <= 0.0:
        failures.append(f"four: work on {len(devices)} devices only")

    # one sharded train step vs the single-device step; a depth budget of
    # max_depth truncates no path
    params = {"tex_color": scene.tex_color}
    target = jnp.full((train_width, train_width, 3), 0.3, jnp.float32)
    kw = dict(wavefront=1 << 14, depth_budget=float(train_depth), drain=None,
              pallas_mode=mode)
    grads = {}
    for c in (n_dev, 1):
        mesh = make_mesh(c) if c > 1 else None
        optimizer = optax.sgd(1.0)
        step = make_train_step(scene, cam, optimizer, width=train_width,
                               height=train_width, spp=train_spp,
                               max_depth=train_depth, mesh=mesh,
                               engine_kw=kw)
        new, _, loss = _sync(step(params, optimizer.init(params), target, 3))
        # sgd(1.0): params - new = the gradient
        grads[c] = (float(loss), np.asarray(params["tex_color"])
                    - np.asarray(new["tex_color"]))
    (l4, g4), (l1, g1) = grads[n_dev], grads[1]
    gmax = float(np.abs(g1).max())
    log("four", train_loss_1=l1, **{f"train_loss_{n_dev}": l4},
        train_grad_maxdiff=float(np.abs(g4 - g1).max()),
        train_grad_maxabs=gmax)
    if abs(l4 - l1) > SHARD_LOSS_RTOL * abs(l1):
        failures.append(f"four: loss {l4} vs {l1}")
    if float(np.abs(g4 - g1).max()) > SHARD_GRAD_TOL * gmax:
        failures.append("four: gradients differ")
    return failures


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded render and train "
                         "step, each against one GPU")
    ap.add_argument("--out-dir", default=os.path.join("chiprun_out",
                                                      "chip_smoke"))
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from srt.utils.device import card_line
    card = card_line()
    if card is None:
        print("chip_smoke: nvidia-smi found no card", file=sys.stderr)
        return 2
    print(f"card: {card}", flush=True)
    import jax
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 2
    from srt.pallas.common import kernel_mode
    from srt.utils.cache import enable
    log = Log(card)
    log("setup", jax=jax.__version__, cache_dir=enable(),
        devices=len(jax.devices()), kind=jax.devices()[0].device_kind,
        xla_flags=os.environ.get("XLA_FLAGS", ""))
    mode = kernel_mode()
    os.makedirs(args.out_dir, exist_ok=True)

    if args.four:
        phases = {"four": lambda: phase_four(log, mode)}
    else:
        phases = {"kernels": lambda: phase_kernels(log, mode),
                  "forward": lambda: phase_forward(log, mode),
                  "mesh": lambda: phase_mesh(log, mode),
                  "train": lambda: phase_train(log, mode),
                  "cli": lambda: phase_cli(log, out_dir=args.out_dir)}
    failures = []
    for name, fn in phases.items():
        t0 = time.perf_counter()
        try:
            failed = fn()
        except Exception:      # recorded, and the run exits non-zero below
            traceback.print_exc()
            failed = [f"{name}: raised"]
        log(name, phase_s=round(time.perf_counter() - t0, 2),
            failures=len(failed))
        for f in failed:
            print(f"FAIL {f}", file=sys.stderr, flush=True)
        failures += failed
    with open(os.path.join(args.out_dir, "records.json"), "w") as f:
        json.dump({"card": card, "records": log.records,
                   "failures": failures}, f, indent=1, default=str)
    if failures:
        print(f"chip_smoke: {len(failures)} failure(s)", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
