"""Per-ray skip-link BVH traversal + triangle intersection (Pallas-Triton).

The XLA reference (``render/intersect.py:intersect_tris``) advances every
ray's node cursor in ONE ``lax.while_loop`` over the whole wavefront: each
step gathers one node per lane through device memory, the loop runs until
the slowest ray of the entire wavefront finishes, and the loop condition
is a wavefront-wide reduction.

This kernel runs the same traversal per block of ``BLOCK`` rays:

* every lane keeps its own node cursor and its own closest hit;
* one loop iteration gathers each active lane's node straight from global
  memory (the GPU's L1/L2 serve these per-lane loads; a mesh's nodes and
  vertices are a few tens of MB and largely stay in the 50 MB L2), runs
  the slab test, and — only when some lane of the block sits on a leaf —
  the leaf's masked Möller–Trumbore tests;
* a block loops until all of ITS lanes are done, so a slow ray holds back
  only its own block, not the wavefront.

One level for every mesh size: there is no on-chip scene budget, so the
same kernel covers a 12-triangle box and a 1.28M-triangle teapot pair.
Same traversal order and arithmetic as the XLA path (up to fma
contraction), so the winner is the same triangle.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental.pallas import triton as pltr

from srt.pallas.common import lane_call, pad_lanes, padded

_BIG = np.float32(3.0e38)


def traversal_available(scene, mode: str) -> bool:
    """Static gate: a kernel mode and a scene with triangles."""
    return mode != "off" and scene.n_tris > 0


def _kernel(lo_ref, hi_ref, skip_ref, first_ref, count_ref,
            p0_ref, p1_ref, p2_ref,
            ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
            t_ref, u_ref, v_ref, idx_ref, *, n_nodes: int, n_tris: int,
            t_min: float, leaf_size: int):
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]

    def safe_inv(d):
        return 1.0 / jnp.where(jnp.abs(d) < 1e-20, 1e-20, d)

    ivx, ivy, ivz = safe_inv(dx), safe_inv(dy), safe_inv(dz)

    def gather3(ref, i, mask):
        return tuple(pltr.load(ref.at[i, c], mask=mask, other=0.0)
                     for c in range(3))

    def moller(tri, lane, t_best, u_best, v_best, i_best):
        """Masked Möller–Trumbore of each lane's own triangle (math of
        render/intersect.py:_tri_intersect, triangle.h:117-188)."""
        p0x, p0y, p0z = gather3(p0_ref, tri, lane)
        p1x, p1y, p1z = gather3(p1_ref, tri, lane)
        p2x, p2y, p2z = gather3(p2_ref, tri, lane)
        e1x, e1y, e1z = p1x - p0x, p1y - p0y, p1z - p0z
        e2x, e2y, e2z = p2x - p0x, p2y - p0y, p2z - p0z
        pvx = dy * e2z - dz * e2y          # pvec = d x e2
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
        tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
        qvx = tvy * e1z - tvz * e1y        # qvec = tvec x e1
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
        t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
        better = (lane & (jnp.abs(det) > 1e-10) & (u >= 0.0) & (v >= 0.0)
                  & (u + v <= 1.0) & (t > t_min) & (t < t_best))
        return (jnp.where(better, t, t_best), jnp.where(better, u, u_best),
                jnp.where(better, v, v_best), jnp.where(better, tri, i_best))

    def cond(carry):
        return jnp.max(jnp.where(carry[0] < n_nodes, 1, 0)) > 0

    def body(carry):
        cursor, t_best, u_best, v_best, i_best = carry
        active = cursor < n_nodes
        cur = jnp.minimum(cursor, n_nodes - 1)
        lo_x, lo_y, lo_z = gather3(lo_ref, cur, active)
        hi_x, hi_y, hi_z = gather3(hi_ref, cur, active)
        skip = pltr.load(skip_ref.at[cur], mask=active, other=n_nodes)
        first = pltr.load(first_ref.at[cur], mask=active, other=-1)
        count = pltr.load(count_ref.at[cur], mask=active, other=0)

        # Slab test (aabb.h:10-62) against the lane's current best t.
        t0x, t1x = (lo_x - ox) * ivx, (hi_x - ox) * ivx
        t0y, t1y = (lo_y - oy) * ivy, (hi_y - oy) * ivy
        t0z, t1z = (lo_z - oz) * ivz, (hi_z - oz) * ivz
        tn = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x),
                                     jnp.minimum(t0y, t1y)),
                         jnp.minimum(t0z, t1z))
        tf = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x),
                                     jnp.maximum(t0y, t1y)),
                         jnp.maximum(t0z, t1z))
        box_hit = active & (tf >= jnp.maximum(tn, t_min)) & (tn < t_best)
        is_leaf = first >= 0
        at_leaf = box_hit & is_leaf

        def leaf(args):
            for j in range(leaf_size):   # static leaf width (SceneFlags)
                tri = jnp.clip(first + j, 0, n_tris - 1)
                args = moller(tri, at_leaf & (j < count), *args)
            return args

        t_best, u_best, v_best, i_best = jax.lax.cond(
            jnp.max(jnp.where(at_leaf, 1, 0)) > 0, leaf, lambda a: a,
            (t_best, u_best, v_best, i_best))
        # internal + hit descends (cursor + 1), otherwise the skip link
        nxt = jnp.where(box_hit & ~is_leaf, cursor + 1, skip)
        return (jnp.where(active, nxt, cursor), t_best, u_best, v_best,
                i_best)

    init = (jnp.zeros_like(ox, jnp.int32), jnp.full_like(ox, _BIG),
            jnp.zeros_like(ox), jnp.zeros_like(ox),
            jnp.zeros_like(ox, jnp.int32))
    _, t_best, u_best, v_best, i_best = jax.lax.while_loop(cond, body, init)
    t_ref[...] = t_best
    u_ref[...] = u_best
    v_ref[...] = v_best
    idx_ref[...] = i_best


def intersect_tris_kernel(scene, ray, t_min, mode: str, leaf_size: int = 4):
    """Closest hit over the triangle BVH -> ``(t, u, v, tri_index)`` per
    ray (``t == _BIG`` on a miss). The caller
    (``render/intersect.py:intersect_tris_via_kernel``) assembles the Hit
    record; uv/normal/material gathers stay in XLA."""
    n = ray.origin.shape[0]
    n_pad = padded(n)
    f32 = jnp.float32
    lanes = [pad_lanes(ray.origin[:, c], n_pad, f32) for c in range(3)]
    # pad rays point +z from the origin; their results are cut off below
    lanes += [pad_lanes(ray.direction[:, c], n_pad, f32, 1.0 if c == 2
                        else 0.0) for c in range(3)]
    tables = [jnp.asarray(scene.bvh_lo, f32), jnp.asarray(scene.bvh_hi, f32),
              jnp.asarray(scene.bvh_skip, jnp.int32),
              jnp.asarray(scene.bvh_first, jnp.int32),
              jnp.asarray(scene.bvh_count, jnp.int32),
              jnp.asarray(scene.tri_p0, f32), jnp.asarray(scene.tri_p1, f32),
              jnp.asarray(scene.tri_p2, f32)]
    kernel = functools.partial(
        _kernel, n_nodes=int(scene.n_bvh_nodes), n_tris=int(scene.n_tris),
        t_min=float(t_min), leaf_size=int(leaf_size))
    t, u, v, idx = lane_call(kernel, tables, lanes,
                             [f32, f32, f32, jnp.int32], mode=mode,
                             name="bvh_traverse")
    return t[:n], u[:n], v[:n], idx[:n]
