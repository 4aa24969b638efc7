"""Differentiable rendering + inverse-rendering optimization.

No reference analogue (the C++ renderer is forward-only); this implements the
BASELINE config-5 capability: gradients of an image loss w.r.t. scene
parameters (albedo/texture colors, material params like roughness or IOR,
emission, light/sphere positions) with ``jax.grad`` straight through the
wavefront estimator.

Estimator notes:
* Sampling decisions (RNG bits, picked directions' *probabilities*) are
  discrete or detached; the radiance estimate is differentiable in the
  *values* (albedo multiplies throughput, emission adds, geometry moves hit
  points smoothly within a fixed visibility configuration).
* Visibility discontinuities are not differentiated (standard limitation;
  BASELINE scopes gradients to material/emission/light parameters).
* The sampler is decorrelated per step via ``seed`` so SGD sees fresh noise
  (stochastic gradient Langevin-style, standard for inverse MC rendering).
"""
from __future__ import annotations

from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from srt.core.rng import RaySampler
from srt.render.integrator import trace
from srt.scene.ir import Scene

_DIM_PIX_X = 30
_DIM_PIX_Y = 31
_DIM_LENS = 32
_DIM_TIME = 34


def splice(scene: Scene, params: dict[str, Any]) -> Scene:
    """Replace Scene fields by name from a parameter dict (the optimized
    subset of scene state, e.g. ``{"tex_color": ..., "mat_params": ...}``).

    Optimizing the f32 ``atlas`` drops its packed rgb8 twin (gradients
    can't flow through the integer-gather fast path)."""
    if "atlas" in params:
        return scene._replace(**params, atlas_u32=None)
    return scene._replace(**params)


#: Scene fields whose cotangents only exist on the geometric
#: (intersection / sampling-measure) paths. When none of them is being
#: optimized, detaching them is *exact* — a parameter that never appears
#: in these arrays has zero gradient through them by definition — and it
#: lets XLA dead-code-eliminate the transpose of the whole intersection
#: sweep from the backward pass (the single largest non-shading cost of
#: a train step; tools/trainbench.py).
_GEOM_FIELDS = frozenset({
    "sph_center0", "sph_center1", "sph_times", "sph_radius",
    "rect_bounds", "rect_k",
    "tri_p0", "tri_p1", "tri_p2", "tri_uv", "tri_n",
    "med_center", "med_radius", "med_half", "med_density",
    "bvh_lo", "bvh_hi",
})


def freeze_geometry(scene: Scene, exclude=()) -> Scene:
    """``stop_gradient`` every geometric Scene field not in ``exclude``."""
    upd = {}
    for f in _GEOM_FIELDS - set(exclude):
        v = getattr(scene, f)
        if v is not None:
            upd[f] = jax.lax.stop_gradient(v)
    return scene._replace(**upd)


def render_pixels(scene: Scene, camera, pixel_ids, *, width: int, height: int,
                  spp: int, max_depth: int, seed, engine: str = "regen",
                  wavefront: int = 1 << 13,
                  depth_budget: float = 4.0,
                  drain: int | None = 12,
                  unroll: int = 1,
                  frozen_geometry: bool = False,
                  pallas_mode: str | None = None) -> jnp.ndarray:
    """Mean radiance per pixel (P, 3), fully traceable/differentiable.

    Unlike the forward-path :func:`srt.render.api.render`, the pixel
    jitter comes from the counter RNG (not Sobol) so the whole evaluation is
    one jit region with no host state.

    ``engine="regen"`` (default) uses the reverse-differentiable
    regeneration scan (:mod:`srt.render.regen_scan`): same estimator,
    ~``max_depth / depth_budget``x fewer dead-lane bounces than the
    lockstep ``engine="scan"`` path (VERDICT r2 item 4). ``depth_budget``
    is the assumed mean path length for the static step budget; paths past
    the budget are truncated (counted, negligible when sized sanely).

    ``pallas_mode`` is the static kernel choice
    (``pallas/common.kernel_mode``); ``None`` resolves it here, while
    tracing, before the jitted engine is called (so it is part of its
    cache key). Inside a caller's own ``jit``, resolve it outside and pass
    it in, as :func:`make_train_step` does.
    """
    p = pixel_ids.shape[0]
    pix = jnp.repeat(pixel_ids, spp)
    samp = jnp.tile(np.arange(spp, dtype=np.int32), p)

    sampler = RaySampler.create(seed, pix, samp)
    jx = sampler.uniform(_DIM_PIX_X)
    jy = sampler.uniform(_DIM_PIX_Y)
    col = (pix % width).astype(jnp.float32)
    row = (pix // width).astype(jnp.float32)
    s = (col + jx) / width
    t = ((height - 1.0 - row) + jy) / height

    rays = camera.rays(s, t, sampler.uniform(_DIM_LENS),
                       sampler.uniform(_DIM_LENS + 1),
                       sampler.uniform(_DIM_TIME))
    # SceneFlags.of returns None when scene tables are traced; under the
    # usual make_train_step jit the *types* table is a closure constant,
    # so the shader still specializes (optimized params like tex_color
    # stay traced).
    from srt.scene.ir import SceneFlags
    flags = SceneFlags.of(scene)
    if engine == "regen":
        from srt.pallas.common import kernel_mode
        from srt.render.regen_scan import steps_for, trace_queue
        if pallas_mode is None:
            pallas_mode = kernel_mode()
        steps = steps_for(p * spp, wavefront, depth_budget, max_depth,
                          drain=drain)
        radiance, _ = trace_queue(scene, rays, sampler.salt, n_steps=steps,
                                  wavefront=wavefront, max_depth=max_depth,
                                  flags=flags, unroll=unroll,
                                  pallas_mode=pallas_mode,
                                  frozen_geometry=frozen_geometry)
    else:
        radiance = trace(scene, rays, sampler, max_depth=max_depth,
                         rr_start=1 << 30, flags=flags)
    return jnp.mean(radiance.reshape(p, spp, 3), axis=1)


def image_loss(params, scene, camera, target, pixel_ids, *, width, height,
               spp, max_depth, seed, engine="regen", engine_kw=None,
               frozen_geometry: bool | None = None):
    """L2 loss between the rendered pixels and target pixels (P, 3).

    ``frozen_geometry``: detach the geometric scene fields inside the
    hybrid bounce's *backward recompute* (pallas/bounce_vjp.py) so the
    intersection transpose is dead-code-eliminated. ``None`` (default)
    auto-enables exactly when no optimized param is geometric — then the
    dropped cotangents are zero by definition, so this is a free,
    mathematically exact speedup (see :data:`_GEOM_FIELDS`); pass
    ``False`` to force full geometry gradients regardless. Deliberately
    NOT applied to the primal scene: a primal ``stop_gradient`` turns
    those values into checkpoint-saved residuals instead of recomputed
    ones, which measured *slower* (tools/trainbench.py).
    """
    if frozen_geometry is None:
        frozen_geometry = not (set(params) & _GEOM_FIELDS)
    img = render_pixels(splice(scene, params), camera, pixel_ids,
                        width=width, height=height, spp=spp,
                        max_depth=max_depth, seed=seed, engine=engine,
                        frozen_geometry=frozen_geometry,
                        **(engine_kw or {}))
    return jnp.mean((img - target) ** 2)


def make_train_step(scene: Scene, camera, optimizer, *, width: int,
                    height: int, spp: int, max_depth: int,
                    mesh: Mesh | None = None,
                    engine: str = "regen",
                    engine_kw: dict | None = None) -> Callable:
    """Build a jitted SGD step ``(params, opt_state, target, seed) ->
    (params, opt_state, loss)``.

    With a ``mesh``, the pixel axis is sharded over the devices with
    ``shard_map`` and gradients are ``pmean``-reduced across them — the
    inverse-rendering analogue of data-parallel training (SURVEY §2.3).

    The kernel choice is resolved here, outside ``jit``
    (``pallas/common.kernel_mode``), unless ``engine_kw`` sets
    ``pallas_mode`` itself.
    """
    n_pixels = width * height
    if engine == "regen":
        from srt.pallas.common import kernel_mode
        engine_kw = {"pallas_mode": kernel_mode(), **(engine_kw or {})}

    if mesh is None:
        @jax.jit
        def step(params, opt_state, target, seed):
            pixel_ids = np.arange(n_pixels, dtype=np.int32)
            loss, grads = jax.value_and_grad(image_loss)(
                params, scene, camera, target.reshape(n_pixels, 3),
                pixel_ids, width=width, height=height, spp=spp,
                max_depth=max_depth, seed=seed, engine=engine,
                engine_kw=engine_kw)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            return jax.tree.map(lambda p, u: p + u, params, updates), \
                opt_state, loss
        return step

    axis = mesh.axis_names[0]
    n_dev = mesh.devices.size
    assert n_pixels % n_dev == 0, "pixel count must divide the mesh"

    def sharded_grad(params, target, pixel_ids, seed):
        """Per-shard loss+grad; pmean over the mesh axis. The scene is a
        closure constant, as in the single-device step, so its tables stay
        concrete: SceneFlags specialize the shader and select the kernels
        exactly as they do on one device."""
        loss, grads = jax.value_and_grad(image_loss)(
            params, scene, camera, target, pixel_ids,
            width=width, height=height, spp=spp, max_depth=max_depth,
            seed=seed, engine=engine, engine_kw=engine_kw)
        loss = jax.lax.pmean(loss, axis)
        grads = jax.tree.map(lambda g: jax.lax.pmean(g, axis), grads)
        return loss, grads

    smapped = shard_map(
        sharded_grad, mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P()),
        out_specs=(P(), P()), check_vma=False)

    @jax.jit
    def step(params, opt_state, target, seed):
        pixel_ids = jnp.arange(n_pixels, dtype=jnp.int32)
        loss, grads = smapped(params, target.reshape(n_pixels, 3),
                              pixel_ids, seed)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return jax.tree.map(lambda p, u: p + u, params, updates), \
            opt_state, loss

    return step
