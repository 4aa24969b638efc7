"""Vectorized closest-hit intersection over the SoA scene.

Replaces the reference's virtual ``hitable::hit`` dispatch chain
(``hitable_list.h:21-33`` -> ``bvh.h:64-93`` -> per-shape ``hit``) with three
wavefront primitives:

* spheres/rects: chunked brute force — a handful of analytic primitives per
  scene makes a (rays × prim-chunk) vectorized test cheaper than any tree;
* triangles: stackless skip-link BVH traversal in a single ``lax.while_loop``
  with all rays in lockstep (per-ray node cursors, two gathers per step);
* media are *not* handled here — their "hit" is stochastic
  (``constant_medium.h:19-50``) and owned by the integrator where RNG lives.

All functions take rays as SoA ``(N,)`` batches and return a ``Hit`` SoA.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from srt.core.ray import Ray
from srt.core.vecmath import normalize, safe_sqrt
from srt.scene.ir import Scene

_BIG = np.float32(3.0e38)
_T_POS_MAX = np.float32(1.0e7)  # position-eval clamp; see miss-lane inf note
PRIM_CHUNK = 128  # static prims per vectorized brute-force block: bounds
                  # the (rays x chunk) intermediates while keeping the
                  # number of unrolled chunk blocks small (final: 1001
                  # spheres -> 8 blocks)


class Hit(NamedTuple):
    """SoA hit record (reference ``hit_record``, ``hitable.h:17-25``)."""
    t: jnp.ndarray        # (N,) ray parameter, _BIG when miss
    hit: jnp.ndarray      # (N,) bool
    p: jnp.ndarray        # (N, 3) world position
    normal: jnp.ndarray   # (N, 3) shading normal (may be flipped)
    uv: jnp.ndarray       # (N, 2)
    mat: jnp.ndarray      # (N,) int32 material id (0 when miss)

    @staticmethod
    def none(n: int) -> "Hit":
        return Hit(t=np.full((n,), _BIG, np.float32),
                   hit=np.zeros((n,), bool),
                   p=np.zeros((n, 3), np.float32),
                   normal=np.zeros((n, 3), np.float32),
                   uv=np.zeros((n, 2), np.float32),
                   mat=np.zeros((n,), np.int32))

    def closer_of(self, other: "Hit") -> "Hit":
        take = other.hit & (other.t < self.t)
        return Hit(
            t=jnp.where(take, other.t, self.t),
            hit=self.hit | other.hit,
            p=jnp.where(take[:, None], other.p, self.p),
            normal=jnp.where(take[:, None], other.normal, self.normal),
            uv=jnp.where(take[:, None], other.uv, self.uv),
            mat=jnp.where(take, other.mat, self.mat),
        )


def _sphere_uv(unit_p):
    """Spherical uv (reference ``get_sphere_uv``, ``hitable.h:10-15``).

    Gradient-safe at the poles: ``arcsin`` evaluated at a clipped ±1 and
    ``arctan2`` at (0,0) both emit NaN *cotangents* (inf * clip-zero);
    pole-adjacent lanes (|y| within ~1e-6 of 1) take a constant-angle
    branch instead — a <2e-3 rad primal difference confined to the poles.
    """
    x, y, z = unit_p[..., 0], unit_p[..., 1], unit_p[..., 2]
    r2 = x * x + z * z
    off_axis = r2 > 1e-12
    phi = jnp.arctan2(jnp.where(off_axis, z, 0.0),
                      jnp.where(off_axis, x, 1.0))
    y = jnp.clip(y, -1.0, 1.0)
    inner = jnp.abs(y) < 0.999999
    theta = jnp.where(inner, jnp.arcsin(jnp.where(inner, y, 0.0)),
                      jnp.sign(y) * (0.5 * jnp.pi))
    u = 1.0 - (phi + jnp.pi) / (2.0 * jnp.pi)
    v = (theta + jnp.pi / 2.0) / jnp.pi
    return jnp.stack([u, v], axis=-1)


def _assemble_sphere_hit(scene: Scene, ray: Ray, t_min, k) -> Hit:
    """Differentiable Hit for winner sphere ``k`` (-1 = miss).

    The discrete winner is detached (like argmin); t/normal/uv are
    re-derived here so geometry gradients (center/radius, e.g. an
    optimized light sphere) flow exactly as on the brute-force path.
    """
    hit_any = k >= 0
    kc = jnp.maximum(k, 0)

    cen0 = scene.sph_center0[kc]
    cen1 = scene.sph_center1[kc]
    times = scene.sph_times[kc]
    rad = scene.sph_radius[kc]
    dt = (ray.time - times[:, 0]) / jnp.maximum(times[:, 1] - times[:, 0],
                                                1e-20)
    cen = cen0 + dt[:, None] * (cen1 - cen0)
    oc = ray.origin - cen
    b = jnp.sum(oc * ray.direction, axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - rad ** 2
    disc = b * b - c
    sq = safe_sqrt(disc)
    t0 = -b - sq
    t1 = -b + sq
    valid0 = (disc > 0.0) & (t0 > t_min)
    t = jnp.where(valid0, t0, t1)
    env = scene.sph_env[kc]
    # env_sphere always-hit at the far crossing when in front
    # (env_sphere.h:27-38); guard t_min for both variants.
    t = jnp.where(env, t1, t)

    hit = hit_any & (t > t_min)
    tb = jnp.where(hit, t, _BIG)
    p = ray.at(jnp.minimum(tb, _T_POS_MAX))
    unit = (p - cen) / rad[:, None]
    flip = scene.sph_flip[kc] ^ env
    normal = jnp.where(flip[:, None], -unit, unit)
    return Hit(t=tb, hit=hit, p=p, normal=normal, uv=_sphere_uv(unit),
               mat=scene.sph_mat[kc])


def intersect_spheres_bvh(scene: Scene, ray: Ray, t_min, t_max,
                          leaf_size: int = 4) -> Hit:
    """Closest sphere hit via the skip-link sphere BVH (``sbvh_*``).

    Same traversal shape as :func:`intersect_tris`; leaves gather original
    sphere ids through ``sbvh_ids``, so no scene table is reordered. The
    winner search runs detached (a data-dependent ``while_loop`` has no
    reverse rule); :func:`_assemble_sphere_hit` re-derives the hit
    differentiably. Env spheres (always-hit, excluded from the tree) are
    swept separately via ``sph_env_ids``.

    Tie-breaking note: overlapping spheres at *exactly* equal t may pick a
    different winner than the brute-force sweep's lowest-index rule.
    """
    n = ray.origin.shape[0]
    n_nodes = scene.sbvh_skip.shape[0]
    inv_d = 1.0 / jnp.where(jnp.abs(ray.direction) < 1e-20, 1e-20,
                            ray.direction)

    def winner(scene, ray):
        def cond(state):
            cursor, _, _ = state
            return jnp.any(cursor < n_nodes)

        def body(state):
            cursor, t_best, k_best = state
            cur = jnp.minimum(cursor, n_nodes - 1)
            lo = scene.sbvh_lo[cur]
            hi = scene.sbvh_hi[cur]
            first = scene.sbvh_first[cur]
            count = scene.sbvh_count[cur]
            skip = scene.sbvh_skip[cur]

            tt0 = (lo - ray.origin) * inv_d
            tt1 = (hi - ray.origin) * inv_d
            tn = jnp.max(jnp.minimum(tt0, tt1), axis=-1)
            tf = jnp.min(jnp.maximum(tt0, tt1), axis=-1)
            box_hit = (tf >= jnp.maximum(tn, t_min)) & (tn < t_best)

            is_leaf = first >= 0
            active = cursor < n_nodes

            for j in range(leaf_size):
                slot = jnp.clip(first + j, 0, scene.sbvh_ids.shape[0] - 1)
                sid = scene.sbvh_ids[slot]
                lane = active & is_leaf & box_hit & (j < count)
                # single-sphere test (math of _sphere_chunk)
                times = scene.sph_times[sid]
                f = (ray.time - times[:, 0]) / jnp.maximum(
                    times[:, 1] - times[:, 0], 1e-20)
                cen = (scene.sph_center0[sid]
                       + f[:, None] * (scene.sph_center1[sid]
                                       - scene.sph_center0[sid]))
                oc = ray.origin - cen
                b = jnp.sum(oc * ray.direction, axis=-1)
                c = jnp.sum(oc * oc, axis=-1) - scene.sph_radius[sid] ** 2
                disc = b * b - c
                sq = safe_sqrt(disc)
                s0 = -b - sq
                s1 = -b + sq
                ok = disc > 0.0
                v0 = ok & (s0 > t_min) & (s0 < t_max)
                v1 = ok & (s1 > t_min) & (s1 < t_max)
                t = jnp.where(v0, s0, jnp.where(v1, s1, _BIG))
                better = lane & (t < t_best)
                t_best = jnp.where(better, t, t_best)
                k_best = jnp.where(better, sid, k_best)

            descend = active & box_hit & (~is_leaf)
            nxt = jnp.where(descend, cursor + 1, skip)
            cursor = jnp.where(active, nxt, cursor)
            return cursor, t_best, k_best

        init = (np.zeros((n,), np.int32), np.full((n,), _BIG, np.float32),
                np.full((n,), -1, np.int32))
        _, _, k_best = jax.lax.while_loop(cond, body, init)
        return k_best

    k = jax.lax.stop_gradient(winner(scene, ray))
    best = _assemble_sphere_hit(scene, ray, t_min, k)

    # env spheres (few; static count) — brute, differentiable.
    n_env = int(scene.sph_env_ids.shape[0])
    for e in range(n_env):
        sid = scene.sph_env_ids[e]
        k_env = jnp.full((n,), sid, jnp.int32)
        best = best.closer_of(_assemble_sphere_hit(scene, ray, t_min, k_env))
    return best


def intersect_spheres(scene: Scene, ray: Ray, t_min, t_max) -> Hit:
    """Closest hit among all spheres (incl. moving + env variants).

    Math of ``sphere.h:36-66`` / ``moving_sphere.h:24-51`` / the env
    always-hit rule of ``env_sphere.h:27-38``, vectorized over
    (rays, prim-chunk) blocks.
    """
    n = ray.origin.shape[0]
    best = Hit.none(n)
    s_total = scene.n_spheres
    for c0 in range(0, s_total, PRIM_CHUNK):
        c1 = min(c0 + PRIM_CHUNK, s_total)
        best = best.closer_of(
            _sphere_chunk(scene, ray, t_min, t_max, c0, c1))
    return best


def _sphere_chunk(scene: Scene, ray: Ray, t_min, t_max, c0: int, c1: int) -> Hit:
    cen0 = scene.sph_center0[c0:c1]          # (C, 3)
    cen1 = scene.sph_center1[c0:c1]
    times = scene.sph_times[c0:c1]
    rad = scene.sph_radius[c0:c1]            # (C,)
    # Motion lerp (moving_sphere.h:19-21), unclamped exactly like the
    # reference; static spheres have cen1 == cen0.
    dt = ((ray.time[:, None] - times[None, :, 0])
          / jnp.maximum(times[None, :, 1] - times[None, :, 0], 1e-20))
    cen = cen0[None] + dt[..., None] * (cen1 - cen0)[None]  # (N, C, 3)

    oc = ray.origin[:, None, :] - cen                        # (N, C, 3)
    d = ray.direction[:, None, :]
    b = jnp.sum(oc * d, axis=-1)                             # (N, C)
    c = jnp.sum(oc * oc, axis=-1) - rad[None] ** 2
    disc = b * b - c                                         # unit dir => a = 1
    sq = safe_sqrt(disc)  # NaN-free backward on miss lanes
    t0 = -b - sq
    t1 = -b + sq
    valid0 = (disc > 0.0) & (t0 > t_min) & (t0 < t_max)
    valid1 = (disc > 0.0) & (t1 > t_min) & (t1 < t_max)
    t = jnp.where(valid0, t0, jnp.where(valid1, t1, _BIG))

    # env_sphere always "hits" at the far crossing with inward normal
    # (env_sphere.h:27-38) — no discriminant test.
    env = scene.sph_env[c0:c1][None]
    t = jnp.where(env, jnp.where(t1 > t_min, t1, _BIG), t)

    tb = jnp.min(t, axis=1)                                  # (N,)
    k = jnp.argmin(t, axis=1)                                # (N,)
    hit = tb < _BIG

    cen_b = jnp.take_along_axis(cen, k[:, None, None], axis=1)[:, 0]
    rad_b = rad[k]
    # Clamp the position-evaluation t: origin + _BIG*dir overflows f32 to
    # inf on miss lanes, and inf intermediates turn the backward pass into
    # NaN (0 * inf) even where the output is masked.
    p = ray.at(jnp.minimum(tb, _T_POS_MAX))
    unit = (p - cen_b) / rad_b[:, None]
    normal = unit
    flip = scene.sph_flip[c0:c1][k] ^ scene.sph_env[c0:c1][k]
    normal = jnp.where(flip[:, None], -normal, normal)
    return Hit(t=jnp.where(hit, tb, _BIG), hit=hit, p=p, normal=normal,
               uv=_sphere_uv(unit), mat=scene.sph_mat[c0:c1][k])


# Per-rect-axis component indices: plane normal axis, and the two in-plane
# axes (u, v) matching the uv conventions of aarect.h:96-147.
_RECT_NAXIS = np.array([2, 1, 0], np.int32)   # xy->z, xz->y, yz->x
_RECT_UAXIS = np.array([0, 0, 1], np.int32)   # xy->x, xz->x, yz->y
_RECT_VAXIS = np.array([1, 2, 2], np.int32)   # xy->y, xz->z, yz->z


def intersect_rects(scene: Scene, ray: Ray, t_min, t_max) -> Hit:
    """Closest hit among axis-aligned rects (math of ``aarect.h:96-147``)."""
    n = ray.origin.shape[0]
    best = Hit.none(n)
    for c0 in range(0, scene.n_rects, PRIM_CHUNK):
        c1 = min(c0 + PRIM_CHUNK, scene.n_rects)
        best = best.closer_of(_rect_chunk(scene, ray, t_min, t_max, c0, c1))
    return best


def _rect_chunk(scene: Scene, ray: Ray, t_min, t_max, c0: int, c1: int) -> Hit:
    axis = scene.rect_axis[c0:c1]                  # (C,)
    bounds = scene.rect_bounds[c0:c1]              # (C, 4)
    kplane = scene.rect_k[c0:c1]                   # (C,)
    na = jnp.take(_RECT_NAXIS, axis)
    ua = jnp.take(_RECT_UAXIS, axis)
    va = jnp.take(_RECT_VAXIS, axis)

    o_n = ray.origin[:, na]                        # (N, C) gather per rect
    d_n = ray.direction[:, na]
    t = (kplane[None] - o_n) / jnp.where(jnp.abs(d_n) < 1e-20, 1e-20, d_n)
    pu = ray.origin[:, ua] + t * ray.direction[:, ua]
    pv = ray.origin[:, va] + t * ray.direction[:, va]
    inside = ((pu >= bounds[None, :, 0]) & (pu <= bounds[None, :, 1])
              & (pv >= bounds[None, :, 2]) & (pv <= bounds[None, :, 3]))
    valid = inside & (t > t_min) & (t < t_max)
    t = jnp.where(valid, t, _BIG)

    tb = jnp.min(t, axis=1)
    k = jnp.argmin(t, axis=1)
    hit = tb < _BIG

    b = bounds[k]                                   # (N, 4)
    u = (jnp.take_along_axis(pu, k[:, None], 1)[:, 0] - b[:, 0]) / (b[:, 1] - b[:, 0])
    v = (jnp.take_along_axis(pv, k[:, None], 1)[:, 0] - b[:, 2]) / (b[:, 3] - b[:, 2])
    normal = jax.nn.one_hot(jnp.take(_RECT_NAXIS, scene.rect_axis[c0:c1][k]), 3,
                            dtype=ray.origin.dtype)
    normal = jnp.where(scene.rect_flip[c0:c1][k][:, None], -normal, normal)
    return Hit(t=jnp.where(hit, tb, _BIG), hit=hit,
               p=ray.at(jnp.minimum(tb, _T_POS_MAX)),
               normal=normal, uv=jnp.stack([u, v], axis=-1),
               mat=scene.rect_mat[c0:c1][k])


def _tri_intersect(p0, p1, p2, ray_o, ray_d, t_min, t_max):
    """Möller–Trumbore over (N, L) triangle gathers (math of
    ``triangle.h:117-188``, front-face only; meshes here are closed or
    two-sided handled by the caller via winding).

    Returns (t, u, v, valid) each (N, L).
    """
    e1 = p1 - p0
    e2 = p2 - p0
    pvec = jnp.cross(ray_d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    # The reference flips T by det sign to accept only front faces with a
    # positive-det path (triangle.h:136-148); equivalently test both sides
    # here through |det| and reject backfaces via det sign when needed.
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    tvec = ray_o - p0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(ray_d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    valid = ((jnp.abs(det) > 1e-10) & (u >= 0.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t > t_min) & (t < t_max))
    return t, u, v, valid


def _tri_hit(scene: Scene, ray: Ray, t_best, u, v, tri) -> Hit:
    """Hit record from a traversal's winner ``(t, u, v, triangle id)``."""
    hit = t_best < _BIG
    w = 1.0 - u - v
    bary = jnp.stack([w, u, v], axis=-1)                      # (N, 3)
    uv = jnp.sum(scene.tri_uv[tri] * bary[..., None], axis=1)  # (N, 2)
    # Smooth normal interpolation, gated like FLAT_NORMAL=1 (triangle.h:179-183
    # interpolates when the flag is on — the reference default).
    normal = normalize(jnp.sum(scene.tri_n[tri] * bary[..., None], axis=1))
    return Hit(t=jnp.where(hit, t_best, _BIG), hit=hit,
               p=ray.at(jnp.minimum(t_best, _T_POS_MAX)),
               normal=normal, uv=uv, mat=scene.tri_mat[tri])


def intersect_tris_via_kernel(scene: Scene, ray: Ray, t_min, mode: str,
                              leaf_size: int = 4) -> Hit:
    """Hit assembly around the per-ray traversal kernel
    (``pallas/intersect.py``).

    Geometry is detached (stop_gradient on t/u/v): the kernel has no VJP;
    parameter gradients (albedo/materials/emission/lights) are
    unaffected, triangle-*vertex* gradients are out of scope on this path.
    """
    from srt.pallas.intersect import intersect_tris_kernel

    return _tri_hit(scene, ray, *jax.tree.map(
        jax.lax.stop_gradient,
        intersect_tris_kernel(scene, ray, t_min, mode, leaf_size=leaf_size)))


def tris_winner(scene: Scene, ray: Ray, t_min, leaf_size: int = 4):
    """Closest triangle via stackless skip-link BVH traversal ->
    ``(t, u, v, triangle id)`` per ray (``t == _BIG`` on a miss): the plain
    reference of the traversal kernel (``pallas/intersect.py``), with the
    same return convention.

    One ``lax.while_loop`` advances every ray's node cursor in lockstep; an
    iteration does (a) a slab test against the gathered node AABB and (b) for
    leaf nodes, ``leaf_size`` masked Möller–Trumbore tests. Rays that finish
    (cursor == n_nodes) idle until all finish — the XLA-level analogue of the
    wavefront; the kernel gives each block of rays its own loop instead.
    """
    n = ray.origin.shape[0]
    n_nodes = scene.n_bvh_nodes
    inv_d = 1.0 / jnp.where(jnp.abs(ray.direction) < 1e-20, 1e-20,
                            ray.direction)

    def cond(state):
        cursor, _, _, _, _ = state
        return jnp.any(cursor < n_nodes)

    def body(state):
        cursor, t_best, u_best, v_best, i_best = state
        cur = jnp.minimum(cursor, n_nodes - 1)
        lo = scene.bvh_lo[cur]                    # (N, 3)
        hi = scene.bvh_hi[cur]
        first = scene.bvh_first[cur]              # (N,)
        count = scene.bvh_count[cur]
        skip = scene.bvh_skip[cur]

        # Slab test (aabb.h:10-62) against current best t.
        tt0 = (lo - ray.origin) * inv_d
        tt1 = (hi - ray.origin) * inv_d
        tn = jnp.max(jnp.minimum(tt0, tt1), axis=-1)
        tf = jnp.min(jnp.maximum(tt0, tt1), axis=-1)
        box_hit = (tf >= jnp.maximum(tn, t_min)) & (tn < t_best)

        is_leaf = first >= 0
        active = cursor < n_nodes

        # Leaf: masked fixed-width triangle tests.
        for j in range(leaf_size):
            tri = jnp.clip(first + j, 0, scene.n_tris - 1)
            lane = active & is_leaf & box_hit & (j < count)
            t, u, v, valid = _tri_intersect(
                scene.tri_p0[tri], scene.tri_p1[tri], scene.tri_p2[tri],
                ray.origin, ray.direction, t_min, t_best)
            better = lane & valid & (t < t_best)
            t_best = jnp.where(better, t, t_best)
            u_best = jnp.where(better, u, u_best)
            v_best = jnp.where(better, v, v_best)
            i_best = jnp.where(better, tri, i_best)

        # Advance: internal+hit descends (cursor+1), otherwise skip link.
        descend = active & box_hit & (~is_leaf)
        nxt = jnp.where(descend, cursor + 1, skip)
        cursor = jnp.where(active, nxt, cursor)
        return cursor, t_best, u_best, v_best, i_best

    init = (np.zeros((n,), np.int32), np.full((n,), _BIG, np.float32),
            np.zeros((n,), np.float32), np.zeros((n,), np.float32),
            np.zeros((n,), np.int32))
    _, t_best, u, v, tri = jax.lax.while_loop(cond, body, init)
    return t_best, u, v, tri


def intersect_tris(scene: Scene, ray: Ray, t_min, t_max,
                   leaf_size: int = 4) -> Hit:
    """Closest triangle hit through :func:`tris_winner` (the XLA path)."""
    if scene.n_tris == 0:
        return Hit.none(ray.origin.shape[0])
    return _tri_hit(scene, ray, *tris_winner(scene, ray, t_min, leaf_size))


def intersect_scene(scene: Scene, ray: Ray, t_min=1e-3, t_max=_BIG,
                    flags=None, pallas_mode: str = "off") -> Hit:
    """Closest hit over every surface primitive family.

    ``flags`` (a concrete :class:`srt.scene.ir.SceneFlags`) supplies the
    static BVH leaf width; without it the builder default of 4 is assumed.
    ``pallas_mode`` (static, ``pallas/common.kernel_mode``) selects the
    triangle traversal kernel.
    """
    n = ray.origin.shape[0]
    best = Hit.none(n)
    if scene.n_spheres:
        import os as _os
        # The sphere BVH is opt-in: the brute (rays x spheres) sweep is
        # the default for every scene in the library (<= ~1k spheres).
        use_sbvh = (scene.sbvh_ids is not None
                    and _os.environ.get("SRT_SPHERE_BVH") == "on")
        if use_sbvh:
            # NOTE: the sphere BVH has its own leaf width (built with
            # leaf_size=4) — do not reuse the triangle bvh_leaf, which a
            # tiny mesh can shrink below 4 and silently drop sphere hits.
            sleaf = flags.sbvh_leaf if flags is not None else 4
            best = best.closer_of(
                intersect_spheres_bvh(scene, ray, t_min, t_max,
                                      leaf_size=sleaf))
        else:
            best = best.closer_of(intersect_spheres(scene, ray, t_min,
                                                    t_max))
    if scene.n_rects:
        best = best.closer_of(intersect_rects(scene, ray, t_min, t_max))
    if scene.n_tris:
        best = best.closer_of(
            intersect_tris_any(scene, ray, t_min, t_max, flags,
                               mode=pallas_mode))
    return best


def intersect_tris_any(scene: Scene, ray: Ray, t_min, t_max, flags=None,
                       mode: str = "off") -> Hit:
    """Triangle closest-hit: the traversal kernel when ``mode`` selects
    kernels, else the XLA reference. Also the external-hit feed of the
    fused bounce kernel (pallas/bounce.py)."""
    from srt.pallas.intersect import traversal_available
    leaf = flags.bvh_leaf if flags is not None else 4
    if traversal_available(scene, mode):
        return intersect_tris_via_kernel(scene, ray, t_min, mode,
                                         leaf_size=leaf)
    return intersect_tris(scene, ray, t_min, t_max, leaf_size=leaf)
