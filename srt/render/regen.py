"""Path-regeneration render engine: a persistent full wavefront.

The scan integrator (:func:`srt.render.integrator.trace`) marches every
lane through ``max_depth`` bounces even though most paths die after a few —
at the reference's depth cap of 50 (``Raytracing_n.cpp:42``) the machine is
mostly shading dead lanes. This engine keeps one fixed-size wavefront
*always full* instead: when a path terminates, its radiance is scatter-added
into the image and the lane immediately pulls the next ``(pixel, sample)``
work item from a global cursor and starts a fresh camera ray. One
``lax.while_loop`` iteration = one bounce of the whole wavefront + lane
regeneration; the loop runs until the work queue is drained and every lane
is dead. This is the wavefront analogue of persistent-threads megakernel
path tracing (and of the reference's dynamic pixel self-scheduling,
``Raytracing_n.cpp:817-825`` — its mutex counter becomes a cumsum over
terminated lanes).

Identical estimator: every random decision is a pure function of
``(seed, pixel, sample, bounce)`` (see :mod:`srt.core.rng`), so this
engine computes exactly the same per-sample radiance as the scan engine —
images differ only by float accumulation order.

Forward-only: the data-dependent ``while_loop`` is not reverse-
differentiable; inverse rendering uses the scan engine.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from srt.core.rng import RaySampler
from srt.core.vecmath import where3
from srt.render.camera import Camera
from srt.render.integrator import bounce_step
from srt.scene.ir import Scene

# Same reserved camera sampler dimensions as render/api.py.
_DIM_LENS = 32
_DIM_TIME = 34


def _use_fused_bounce(flags, mode: str, rr_start: int,
                      max_depth: int) -> bool:
    # `mode` is a static jit argument (resolved OUTSIDE the trace in
    # render_regen), so the kernel choice is part of the jit cache key.
    from srt.pallas.bounce import fused_bounce_available
    if (flags is not None and flags.fused_deferred_albedo
            and rr_start < max_depth):
        # roulette's in-kernel survival test would see the albedo-less
        # beta on deferred-texture lanes; keep the XLA bounce there
        return False
    return fused_bounce_available(flags, mode)


@partial(jax.jit, static_argnames=("width", "height", "spp", "max_depth",
                                   "rr_start", "wavefront", "flags",
                                   "pdf_floor", "pallas_mode"))
def _render_regen(scene: Scene, camera: Camera, sobol_pts, seed, *,
                  width: int, height: int, spp: int, max_depth: int,
                  rr_start: int, wavefront: int, flags=None,
                  pdf_floor: float = 1e-9, pallas_mode: str = "auto"):
    """Full image via one while_loop with lane regeneration -> (H*W, 3) sums."""
    n_pixels = width * height
    total_work = n_pixels * spp
    n = min(wavefront, total_work)

    def camera_rays(pix, samp):
        """Primary rays + sampler salt for (pixel, sample) lanes."""
        col = (pix % width).astype(jnp.float32)
        row = (pix // width).astype(jnp.float32)
        jitter = sobol_pts[samp % sobol_pts.shape[0]]
        s = (col + jitter[:, 0]) / width
        t = ((height - 1.0 - row) + jitter[:, 1]) / height
        sampler = RaySampler.create(seed, pix, samp)
        rays = camera.rays(s, t, sampler.uniform(_DIM_LENS),
                           sampler.uniform(_DIM_LENS + 1),
                           sampler.uniform(_DIM_TIME))
        return rays, sampler.salt

    parity = flags is not None and flags.ref_parity
    zeros3 = jnp.zeros((n, 3), jnp.float32)
    state = dict(
        cursor=jnp.int32(0),
        n_vertices=jnp.uint32(0),   # ray segments traced (metrics)
        nan_scrubbed=jnp.uint32(0),
        acc=jnp.zeros((n_pixels, 3), jnp.float32),
        pix=jnp.zeros((n,), jnp.int32),
        samp=jnp.zeros((n,), jnp.int32),
        o=zeros3, d=zeros3.at[:, 2].set(1.0),
        time=jnp.zeros((n,), jnp.float32),
        beta=zeros3, radiance=zeros3,
        alive=jnp.zeros((n,), bool),
        salt=jnp.zeros((n,), jnp.uint32),
        depth=jnp.zeros((n,), jnp.int32),
    )
    if parity:
        # heap-recycled beckmann_pdf slot (integrator parity): persists
        # across regeneration, like the reference's per-thread heap slot
        # persists across pixels.
        state["stale"] = jnp.zeros((n,), jnp.float32)

    def cond(st):
        return (st["cursor"] < total_work) | jnp.any(st["alive"])

    def body(st):
        # --- regenerate dead lanes from the work queue -------------------
        need = ~st["alive"]
        k = jnp.cumsum(need.astype(jnp.int32))          # 1-based rank
        wid = st["cursor"] + k - 1
        take = need & (wid < total_work)
        # Consecutive work ids share a pixel (sample-minor): regenerated
        # lanes get coherent primary rays.
        pix = jnp.where(take, wid // spp, st["pix"])
        samp = jnp.where(take, wid % spp, st["samp"])
        rays, salt = camera_rays(pix, samp)
        state_stale = st.get("stale")
        st = dict(
            cursor=st["cursor"] + jnp.sum(take.astype(jnp.int32)),
            n_vertices=st["n_vertices"],
            nan_scrubbed=st["nan_scrubbed"],
            acc=st["acc"],
            pix=pix, samp=samp,
            o=where3(take, rays.origin, st["o"]),
            d=where3(take, rays.direction, st["d"]),
            time=jnp.where(take, rays.time, st["time"]),
            beta=where3(take, jnp.ones_like(st["beta"]), st["beta"]),
            radiance=where3(take, jnp.zeros_like(st["radiance"]),
                            st["radiance"]),
            alive=st["alive"] | take,
            salt=jnp.where(take, salt, st["salt"]),
            depth=jnp.where(take, 0, st["depth"]),
        )
        if parity:
            st["stale"] = state_stale

        # --- one bounce for the (now full) wavefront ---------------------
        # Eligible scenes (SceneFlags.fused_bounce) run the whole bounce as
        # ONE kernel (pallas/bounce.py) — same estimator, one launch
        # instead of the XLA fusion chain.
        was_alive = st["alive"]
        subkeys = ("o", "d", "time", "beta", "radiance", "alive", "salt",
                   "depth") + (("stale",) if parity else ())
        substate = {k: st[k] for k in subkeys}
        if _use_fused_bounce(flags, pallas_mode, rr_start,
                             max_depth):
            from srt.pallas.bounce import fused_bounce
            nxt = fused_bounce(scene, substate, max_depth, rr_start, flags,
                               pdf_floor, mode=pallas_mode)
        else:
            nxt = bounce_step(scene, substate, max_depth, rr_start, flags,
                              pdf_floor, pallas_mode)
        alive = nxt["alive"] & (nxt["depth"] < max_depth)

        # --- flush finished paths into the image -------------------------
        finished = was_alive & ~alive
        contrib = jnp.where(finished[:, None], nxt["radiance"], 0.0)
        # NaN scrub per sample, as de_nan (Raytracing_n.cpp:47-53) — counted.
        is_nan = jnp.isnan(contrib)
        contrib = jnp.where(is_nan, 0.0, contrib)
        acc = st["acc"].at[st["pix"]].add(contrib)

        out = dict(cursor=st["cursor"],
                   n_vertices=st["n_vertices"]
                   + jnp.sum(was_alive, dtype=jnp.uint32),
                   nan_scrubbed=st["nan_scrubbed"]
                   + jnp.sum(is_nan, dtype=jnp.uint32),
                   acc=acc, pix=st["pix"],
                   samp=st["samp"], o=nxt["o"], d=nxt["d"],
                   time=nxt["time"], beta=nxt["beta"],
                   radiance=nxt["radiance"], alive=alive,
                   salt=nxt["salt"], depth=nxt["depth"])
        if parity:
            out["stale"] = nxt["stale"]
        return out

    state = jax.lax.while_loop(cond, body, state)
    return state["acc"], state["n_vertices"], state["nan_scrubbed"]


def render_regen(scene: Scene, camera: Camera, config,
                 sobol_file: str | None = None, metrics: bool = False,
                 pallas_mode: str | None = None):
    """Render a linear-radiance image (H, W, 3) with the regeneration engine.

    Drop-in for :func:`srt.render.api.render`; same estimator, same
    RNG streams, ~max-depth/mean-path-length less wasted work per sample.
    ``pallas_mode`` overrides the process's kernel choice
    (``pallas/common.kernel_mode``; ``"off"`` = the XLA reference).
    """
    import time as _time

    from srt.core.sobol import sobol_points
    from srt.render.api import _rng_jitter
    from srt.utils.metrics import RenderMetrics

    w, h, spp = config.width, config.height, config.spp
    if config.sobol_pixel_jitter:
        pts = sobol_points(max(spp, 2), 2, dir_file=sobol_file)[:max(spp, 1)]
        jit_pts = jnp.asarray(pts, jnp.float32)
    else:
        jit_pts = _rng_jitter(spp, config.seed)

    from srt.pallas.common import kernel_mode
    from srt.render.api import scene_flags

    wavefront = getattr(config, "wavefront", 1 << 17)
    flags = scene_flags(scene, config)
    mode = pallas_mode or kernel_mode()
    t0 = _time.time()
    acc, n_vertices, nan_scrubbed = _render_regen(
        scene, camera, jit_pts, config.seed,
        width=w, height=h, spp=spp,
        max_depth=config.max_depth, rr_start=config.rr_start,
        wavefront=wavefront, flags=flags,
        pdf_floor=getattr(config, "pdf_floor", 1e-9),
        pallas_mode=mode)
    img = (acc / spp).reshape(h, w, 3)
    if metrics:
        img.block_until_ready()
        m = RenderMetrics(width=w, height=h, spp=spp,
                          max_depth=config.max_depth,
                          primary_rays=w * h * spp,
                          path_vertices=int(n_vertices),
                          nan_scrubbed=int(nan_scrubbed),
                          wall_s=_time.time() - t0)
        return img, m
    return img
