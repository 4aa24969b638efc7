"""Closed-form intersection tests + BVH vs brute force (SURVEY §4 'Unit')."""
import numpy as np
import jax.numpy as jnp

from srt.core.ray import Ray
from srt.render.intersect import (intersect_scene, intersect_tris,
                                      _tri_intersect, _BIG)
from srt.scene.build import SceneBuilder
from srt.render.camera import Camera


def _rays(origins, directions):
    o = jnp.asarray(origins, jnp.float32)
    d = jnp.asarray(directions, jnp.float32)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return Ray(origin=o, direction=d, time=jnp.zeros(o.shape[:-1], jnp.float32))


def test_sphere_hit_known():
    b = SceneBuilder()
    m = b.lambertian(b.constant((1, 1, 1)))
    b.sphere((0, 0, -5), 1.0, m)
    s = b.build()
    r = _rays([[0, 0, 0], [0, 3, 0]], [[0, 0, -1], [0, 0, -1]])
    h = intersect_scene(s, r)
    assert bool(h.hit[0]) and not bool(h.hit[1])
    assert abs(float(h.t[0]) - 4.0) < 1e-5
    assert np.allclose(np.asarray(h.normal[0]), [0, 0, 1], atol=1e-5)


def test_moving_sphere_lerp():
    b = SceneBuilder()
    m = b.lambertian(b.constant((1, 1, 1)))
    b.sphere((0, 0, -5), 1.0, m, center1=(0, 2, -5), t0=0.0, t1=1.0)
    s = b.build()
    o = jnp.asarray([[0, 0, 0], [0, 2, 0]], jnp.float32)
    d = jnp.asarray([[0, 0, -1], [0, 0, -1]], jnp.float32)
    # At t=0 sphere is at y=0 (first ray hits); at t=1 it is at y=2.
    h0 = intersect_scene(s, Ray(o, d, jnp.asarray([0.0, 0.0])))
    h1 = intersect_scene(s, Ray(o, d, jnp.asarray([1.0, 1.0])))
    assert bool(h0.hit[0]) and not bool(h0.hit[1])
    assert not bool(h1.hit[0]) and bool(h1.hit[1])


def test_rect_hits_all_axes():
    b = SceneBuilder()
    m = b.lambertian(b.constant((1, 1, 1)))
    b.xy_rect(-1, 1, -1, 1, -2.0, m)   # z = -2 plane
    b.xz_rect(-1, 1, -1, 1, 3.0, m)    # y = 3
    b.yz_rect(-1, 1, -1, 1, 5.0, m)    # x = 5
    s = b.build()
    r = _rays([[0, 0, 0]] * 3, [[0, 0, -1], [0, 1, 0], [1, 0, 0]])
    h = intersect_scene(s, r)
    assert np.all(np.asarray(h.hit))
    assert np.allclose(np.asarray(h.t), [2.0, 3.0, 5.0], atol=1e-5)
    # uv at the center of each rect is (0.5, 0.5).
    assert np.allclose(np.asarray(h.uv), 0.5, atol=1e-5)


def test_triangle_moller_trumbore():
    p0 = jnp.asarray([[-1.0, -1.0, -3.0]])
    p1 = jnp.asarray([[1.0, -1.0, -3.0]])
    p2 = jnp.asarray([[0.0, 1.0, -3.0]])
    o = jnp.asarray([[0.0, 0.0, 0.0]])
    d = jnp.asarray([[0.0, 0.0, -1.0]])
    t, u, v, ok = _tri_intersect(p0, p1, p2, o, d, 1e-3, 1e9)
    assert bool(ok[0]) and abs(float(t[0]) - 3.0) < 1e-5
    # Miss outside the triangle.
    o2 = jnp.asarray([[2.0, 0.0, 0.0]])
    _, _, _, ok2 = _tri_intersect(p0, p1, p2, o2, d, 1e-3, 1e9)
    assert not bool(ok2[0])


def test_bvh_matches_bruteforce():
    """Random triangle soup: BVH closest-hit == O(N) brute force."""
    rng = np.random.default_rng(3)
    tris = rng.uniform(-1, 1, (200, 3, 3)).astype(np.float32) * 0.3
    tris += rng.uniform(-2, 2, (200, 1, 3)).astype(np.float32)

    b = SceneBuilder()
    m = b.lambertian(b.constant((1, 1, 1)))
    b.triangles(tris, m)
    s = b.build()

    n = 256
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    r = _rays(o, d)
    h = intersect_tris(s, r, 1e-3, _BIG)

    # Brute force in numpy over the *reordered* triangle arrays.
    p0 = np.asarray(s.tri_p0); p1 = np.asarray(s.tri_p1); p2 = np.asarray(s.tri_p2)
    ro = np.asarray(r.origin); rd = np.asarray(r.direction)
    e1 = p1 - p0; e2 = p2 - p0
    pvec = np.cross(rd[:, None, :], e2[None])
    det = np.sum(e1[None] * pvec, axis=-1)
    inv = 1.0 / np.where(np.abs(det) < 1e-12, 1e-12, det)
    tvec = ro[:, None, :] - p0[None]
    uu = np.sum(tvec * pvec, axis=-1) * inv
    qvec = np.cross(tvec, e1[None])
    vv = np.sum(rd[:, None, :] * qvec, axis=-1) * inv
    tt = np.sum(e2[None] * qvec, axis=-1) * inv
    valid = (np.abs(det) > 1e-10) & (uu >= 0) & (vv >= 0) & (uu + vv <= 1) & (tt > 1e-3)
    tt = np.where(valid, tt, np.inf)
    t_ref = tt.min(axis=1)

    t_bvh = np.where(np.asarray(h.hit), np.asarray(h.t), np.inf)
    hit_ref = np.isfinite(t_ref)
    assert np.array_equal(np.asarray(h.hit), hit_ref)
    assert np.allclose(t_bvh[hit_ref], t_ref[hit_ref], rtol=1e-4, atol=1e-4)


def test_env_sphere_always_hits():
    b = SceneBuilder()
    m = b.diffuse_light(b.constant((1, 1, 1)))
    b.sphere((0, 0, 0), 100.0, m, env=True)
    s = b.build()
    rng = np.random.default_rng(4)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    r = _rays(np.zeros((64, 3), np.float32), d)
    h = intersect_scene(s, r)
    assert np.all(np.asarray(h.hit))
    assert np.allclose(np.asarray(h.t), 100.0, atol=1e-3)
    # Inward normal: opposes the hit direction.
    assert np.all(np.sum(np.asarray(h.normal) * np.asarray(r.direction), -1) < 0)


def test_camera_center_ray():
    cam = Camera.look_at(lookfrom=(0, 0, 0), lookat=(0, 0, -1), vfov=90.0,
                         aspect=1.0)
    s = jnp.asarray([0.5]); t = jnp.asarray([0.5])
    z = jnp.asarray([0.0])
    r = cam.rays(s, t, z, z, z)
    assert np.allclose(np.asarray(r.direction), [[0, 0, -1]], atol=1e-5)
    # Corner (s=1, t=1) at 90 deg fov: direction ~ (1, 1, -1)/sqrt(3).
    r = cam.rays(jnp.asarray([1.0]), jnp.asarray([1.0]), z, z, z)
    assert np.allclose(np.asarray(r.direction),
                       np.array([[1, 1, -1]]) / np.sqrt(3), atol=1e-4)


def test_sphere_bvh_matches_brute_force():
    """Sphere-BVH traversal (sbvh_*, built at >=64 spheres) vs the brute
    chunk sweep: static, moving, flipped, env spheres."""
    import numpy as np

    from srt.render.intersect import (intersect_spheres,
                                          intersect_spheres_bvh)
    from srt.scene.build import SceneBuilder

    rng = np.random.default_rng(5)
    b = SceneBuilder()
    m = b.lambertian(b.constant((0.5, 0.5, 0.5)))
    for i in range(80):
        c = rng.uniform(-8, 8, 3)
        if i % 5 == 0:
            b.sphere(c, 0.4, m, center1=c + rng.uniform(-1, 1, 3))
        elif i % 5 == 1:
            b.sphere(c, 0.4, m, flip=True)
        else:
            b.sphere(c, 0.4, m)
    b.sphere((0, 0, 0), 100.0, b.diffuse_light(b.constant((1, 1, 1))),
             env=True)
    scene = b.build()
    assert scene.sbvh_ids is not None

    n = 2000
    o = rng.standard_normal((n, 3)).astype(np.float32) * 4
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ray = Ray(origin=o, direction=d,
              time=rng.uniform(0, 1, n).astype(np.float32))

    hb = intersect_spheres(scene, ray, 1e-3, 3e38)
    hv = intersect_spheres_bvh(scene, ray, 1e-3, 3e38)
    np.testing.assert_array_equal(np.asarray(hb.hit), np.asarray(hv.hit))
    both = np.asarray(hb.hit)
    np.testing.assert_allclose(np.asarray(hb.t)[both],
                               np.asarray(hv.t)[both], rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(np.asarray(hb.mat)[both],
                                  np.asarray(hv.mat)[both])
    np.testing.assert_allclose(np.asarray(hb.normal)[both],
                               np.asarray(hv.normal)[both],
                               rtol=2e-4, atol=2e-4)
