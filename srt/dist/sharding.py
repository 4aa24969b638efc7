"""Multi-device rendering via jax.sharding + shard_map.

Replacement for the reference's only parallel layer — 8 CPU threads
pulling pixels off a mutex-guarded counter (``Raytracing_n.cpp:815-879``).
Design (SURVEY §2.3):

* The **ray wavefront** (pixels × samples) is the data-parallel axis: pixel
  batches are sharded over every device of a 1-D ``Mesh``. Static tiling
  replaces dynamic stealing — each Sobol batch costs the same, so there is
  no load imbalance to steal from. The mesh follows the algorithm alone:
  the cards of one host reach each other at the same rate.
* The **scene + BVH are replicated** (broadcast once per scene build). This
  mirrors the reference's shared heap scene graph, minus the races.
* Each device runs the single-device program on its own pixel strip under
  ``shard_map`` (kernels included). The only communication is image
  assembly and, in training, a gradient ``pmean``; multi-host runs add
  ``jax.distributed.initialize`` and the same program runs unchanged.
* One-device and N-device renders are **bit-identical** because the RNG is
  a pure function of (seed, pixel, sample, bounce, dim) — asserted in
  ``tests/test_dist.py``.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from srt.render.api import RenderConfig, _render_chunk
from srt.scene.ir import Scene


def make_mesh(n_devices: int | None = None, axis: str = "rays") -> Mesh:
    """1-D device mesh over the first ``n_devices`` local devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def replicate_scene(scene: Scene, mesh: Mesh) -> Scene:
    """Place every scene buffer fully-replicated on the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sharding), scene)


@partial(jax.jit, static_argnames=(
    "mesh", "n_samples", "width", "height", "max_depth", "rr_start", "flags",
    "pdf_floor", "pallas_mode"))
def _sharded_chunk(scene, camera, pixel_ids, sample0, sobol_pts, seed, *,
                   mesh, n_samples, width, height, max_depth, rr_start, flags,
                   pdf_floor, pallas_mode):
    """Radiance sums of one sample chunk, each device on its pixel strip."""
    axis = mesh.axis_names[0]

    def shard(scene, camera, pixel_ids, sample0, sobol_pts, seed):
        return _render_chunk(
            scene, camera, pixel_ids, sample0, sobol_pts, seed,
            width=width, height=height, max_depth=max_depth,
            rr_start=rr_start, n_samples=n_samples, flags=flags,
            pdf_floor=pdf_floor, pallas_mode=pallas_mode)

    return jax.shard_map(
        shard, mesh=mesh, in_specs=(P(), P(), P(axis), P(), P(), P()),
        out_specs=P(axis), check_vma=False)(
            scene, camera, pixel_ids, sample0, sobol_pts, seed)


def render_sharded(scene: Scene, camera, config: RenderConfig, mesh: Mesh,
                   sobol_file: str | None = None,
                   pallas_mode: str | None = None) -> jnp.ndarray:
    """Render with the pixel axis sharded over ``mesh``; returns (H, W, 3).

    The per-shard program is the same ``_render_chunk`` used single-device,
    run by ``shard_map`` on each device's pixel strip (zero collectives
    until the host gathers the image). ``pallas_mode`` overrides the
    process's kernel choice (``pallas/common.kernel_mode``).
    """
    from srt.core.sobol import sobol_points
    from srt.pallas.common import kernel_mode
    from srt.render.api import scene_flags

    w, h, spp = config.width, config.height, config.spp
    n_pixels = w * h
    n_dev = mesh.devices.size
    axis = mesh.axis_names[0]

    # Pad the pixel axis to a multiple of the device count.
    pad = (-n_pixels) % n_dev
    pixel_ids = jnp.arange(n_pixels + pad, dtype=jnp.int32)
    pixel_ids = jax.device_put(
        pixel_ids, NamedSharding(mesh, P(axis)))

    flags = scene_flags(scene, config)
    scene = replicate_scene(scene, mesh)
    camera = jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P())), camera)

    pts = sobol_points(max(spp, 2), 2, dir_file=sobol_file)[:max(spp, 1)]
    sobol_pts = jax.device_put(jnp.asarray(pts, jnp.float32),
                               NamedSharding(mesh, P()))

    acc = jnp.zeros((n_pixels + pad, 3), jnp.float32)
    acc = jax.device_put(acc, NamedSharding(mesh, P(axis)))
    chunk = min(config.sample_chunk, spp)
    for s0 in range(0, spp, chunk):
        acc = acc + _sharded_chunk(
            scene, camera, pixel_ids, jnp.int32(s0), sobol_pts,
            jnp.uint32(config.seed), mesh=mesh,
            n_samples=min(chunk, spp - s0), width=w, height=h,
            max_depth=config.max_depth, rr_start=config.rr_start,
            flags=flags, pdf_floor=config.pdf_floor,
            pallas_mode=pallas_mode or kernel_mode())
    img = (acc[:n_pixels] / spp).reshape(h, w, 3)
    return img
