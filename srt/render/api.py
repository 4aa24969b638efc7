"""Top-level render API: pixels × samples -> image, jit-compiled per scene.

Replaces the reference's ``main`` + ``renderthread`` runtime
(``Raytracing_n.cpp:815-952``): the mutex-guarded dynamic pixel counter
becomes static tiling of a flat ray wavefront (uniform Sobol-batch cost makes
dynamic stealing pointless on SIMD hardware), and the 8 CPU threads become
one fused XLA program per sample-chunk, optionally sharded over a device
mesh by :mod:`srt.dist.sharding`.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from srt.core.rng import RaySampler, bits_to_uniform, hash_combine
from srt.core.sobol import sobol_points
from srt.render import film
from srt.render.camera import Camera
from srt.render.integrator import trace
from srt.scene.ir import Scene


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 256
    height: int = 256
    spp: int = 64
    max_depth: int = 16
    seed: int = 0
    rr_start: int = 1 << 30        # off by default (reference parity)
    sample_chunk: int = 8          # spp folded into one compiled wavefront
    pixel_chunk: int = 1 << 16     # pixels per device dispatch
    sobol_pixel_jitter: bool = True  # reference jitters pixels with Sobol
                                     # (Raytracing_n.cpp:834-835)
    pdf_floor: float = 1e-9          # zero-contribution cutoff for the
                                     # mixture pdf; raise (e.g. 1e-4) to
                                     # suppress fireflies at small bias
    ref_parity: bool = False         # reproduce the reference's
                                     # as-implemented Beckmann/Oren-Nayar
                                     # estimator (SceneFlags.ref_parity) for
                                     # golden-image comparison
    wavefront: int = 1 << 16         # persistent-wavefront lanes (regen)
    parity_no_stale: bool = False    # diagnostic: zero the heap-slot
                                     # reads (pairs with a C++ build whose
                                     # beckmann_pdf zero-inits its malloc)
    seq_stale: bool = False          # thread-faithful parity mode (scan
                                     # engine only): render each pixel's
                                     # samples SEQUENTIALLY, carrying the
                                     # heap-recycled beckmann_pdf slot
                                     # across samples like the reference's
                                     # per-thread malloc slot does across
                                     # its per-pixel ns loop (GOLDEN.md)


def scene_flags(scene, config):
    """Static shader-specialization flags for a render, including the
    config's estimator-parity switch."""
    from srt.scene.ir import SceneFlags
    flags = SceneFlags.of(scene)
    if flags is not None and getattr(config, "ref_parity", False):
        flags = flags._replace(ref_parity=True)
    if flags is not None and getattr(config, "parity_no_stale", False):
        flags = flags._replace(parity_no_stale=True)
    return flags


# Per-ray sampler dimensions reserved for camera decisions.
_DIM_LENS = 32
_DIM_TIME = 34


@partial(jax.jit, static_argnames=("width", "height", "max_depth", "rr_start",
                                   "n_samples", "with_aux", "flags",
                                   "pdf_floor", "pallas_mode"))
def _render_chunk(scene: Scene, camera: Camera, pixel_ids, sample0,
                  sobol_pts, seed, *, width, height, max_depth, rr_start,
                  n_samples, with_aux=False, flags=None, pdf_floor=1e-9,
                  stale_in=None, pallas_mode="off"):
    """Radiance sum over ``n_samples`` consecutive samples for a pixel chunk.

    Flattens (pixels × samples) into one wavefront so the whole chunk is a
    single fused program — the spp axis is data parallelism, exactly like
    extra pixels. With ``stale_in`` (requires ``n_samples == 1``:
    lane == pixel), the parity heap-slot carry threads through and back
    out — the sequential-sample golden mode (``RenderConfig.seq_stale``).
    """
    p = pixel_ids.shape[0]
    pix = jnp.repeat(pixel_ids, n_samples)                    # (P*S,)
    samp = sample0 + jnp.tile(np.arange(n_samples, dtype=np.int32), p)       # (P*S,)

    col = (pix % width).astype(jnp.float32)
    row = (pix // width).astype(jnp.float32)

    jitter = sobol_pts[samp % sobol_pts.shape[0]]             # (P*S, 2)
    s = (col + jitter[:, 0]) / width
    t = ((height - 1.0 - row) + jitter[:, 1]) / height

    sampler = RaySampler.create(seed, pix, samp)
    u_l1 = sampler.uniform(_DIM_LENS)
    u_l2 = sampler.uniform(_DIM_LENS + 1)
    u_t = sampler.uniform(_DIM_TIME)
    rays = camera.rays(s, t, u_l1, u_l2, u_t)

    if stale_in is not None:
        assert n_samples == 1, "stale threading needs lane == pixel"
        radiance, stale_out = trace(
            scene, rays, sampler, max_depth=max_depth, rr_start=rr_start,
            flags=flags, pdf_floor=pdf_floor, stale0=stale_in,
            return_stale=True, pallas_mode=pallas_mode)
        return radiance, stale_out
    out = trace(scene, rays, sampler, max_depth=max_depth,
                rr_start=rr_start, with_aux=with_aux, flags=flags,
                pdf_floor=pdf_floor, pallas_mode=pallas_mode)
    if with_aux:
        radiance, aux = out
        return jnp.sum(radiance.reshape(p, n_samples, 3), axis=1), aux
    return jnp.sum(out.reshape(p, n_samples, 3), axis=1)  # (P, 3)


def render(scene: Scene, camera: Camera, config: RenderConfig,
           sobol_file: str | None = None, metrics: bool = False,
           pallas_mode: str | None = None):
    """Render a linear-radiance image (H, W, 3) float32.

    Outer host loop over sample chunks and pixel chunks; all hot work is in
    the jitted ``_render_chunk``. Accumulation stays on device in f32.

    ``metrics=True`` additionally returns a
    :class:`srt.utils.RenderMetrics` (rays/s, bounce histogram,
    NaN-scrub count — SURVEY §5's structured observability).

    ``pallas_mode`` overrides the process's kernel choice
    (``pallas/common.kernel_mode``; ``"off"`` = the XLA reference).
    """
    import time as _time

    from srt.pallas.common import kernel_mode
    from srt.utils.metrics import RenderMetrics

    w, h, spp = config.width, config.height, config.spp
    n_pixels = w * h

    if config.sobol_pixel_jitter:
        pts = sobol_points(max(spp, 2), 2, dir_file=sobol_file)[:max(spp, 1)]
        jit_pts = jnp.asarray(pts, jnp.float32)
    else:
        # pure-RNG pixel jitter: derive from the sampler stream
        jit_pts = _rng_jitter(spp, config.seed)

    flags = scene_flags(scene, config)

    acc = jnp.zeros((n_pixels, 3), jnp.float32)
    chunk = min(config.sample_chunk, spp)
    m = RenderMetrics(width=w, height=h, spp=spp, max_depth=config.max_depth,
                      primary_rays=n_pixels * spp)
    t0 = _time.time()

    mode = pallas_mode or kernel_mode()
    seq = bool(config.seq_stale and flags is not None and flags.ref_parity)
    if seq:
        chunk = 1          # lane == pixel so the slot carry is per pixel
    for p0 in range(0, n_pixels, config.pixel_chunk):
        p1 = min(p0 + config.pixel_chunk, n_pixels)
        pixel_ids = jnp.arange(p0, p1, dtype=jnp.int32)
        part = jnp.zeros((p1 - p0, 3), jnp.float32)
        stale = jnp.zeros((p1 - p0,), jnp.float32) if seq else None
        for s0 in range(0, spp, chunk):
            n_s = min(chunk, spp - s0)
            out = _render_chunk(
                scene, camera, pixel_ids, s0, jit_pts,
                config.seed, width=w, height=h,
                max_depth=config.max_depth, rr_start=config.rr_start,
                n_samples=n_s, with_aux=metrics and not seq, flags=flags,
                pdf_floor=config.pdf_floor, stale_in=stale,
                pallas_mode=mode)
            if seq:
                out, stale = out
            elif metrics:
                out, aux = out
                m.add_chunk(aux)
            part = part + out
        acc = acc.at[p0:p1].add(part)

    img = (acc / spp).reshape(h, w, 3)
    if metrics:
        img.block_until_ready()
        m.wall_s = _time.time() - t0
        return img, m
    return img


def _rng_jitter(spp: int, seed: int):
    s = np.arange(spp, dtype=np.uint32)
    return jnp.stack([
        bits_to_uniform(hash_combine(s, jnp.uint32(seed * 2 + 101))),
        bits_to_uniform(hash_combine(s, jnp.uint32(seed * 2 + 102)))], axis=-1)


def render_tonemapped(scene, camera, config, **kw):
    return film.tonemap(render(scene, camera, config, **kw))
