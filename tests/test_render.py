"""Integration tests: furnace test, Cornell smoke render, NEE consistency
(SURVEY §4 'Integration'). Runs on CPU devices at tiny sizes."""
import numpy as np
import jax.numpy as jnp

from srt import render, RenderConfig
from srt.render.camera import Camera
from srt.scene.build import SceneBuilder


def _furnace_scene(albedo):
    """Lambertian sphere enclosed in a unit-radiance emitting env dome."""
    b = SceneBuilder()
    m = b.lambertian(b.constant((albedo,) * 3))
    b.sphere((0, 0, 0), 1.0, m)
    b.sphere((0, 0, 0), 50.0, b.diffuse_light(b.constant((1.0, 1.0, 1.0))),
             env=True)
    return b.build()


def test_furnace_unbiased():
    """Furnace test: a convex Lambertian sphere in a uniform unit-radiance
    dome reflects exactly ``albedo`` (no self-interreflection on a convex
    body), and with albedo 1 it becomes invisible. The reference cannot run
    this (its env 'sky' needs a texture file); it validates the estimator is
    unbiased end-to-end.
    """
    for albedo in (0.6, 1.0):
        scene = _furnace_scene(albedo)
        cam = Camera.look_at(lookfrom=(0, 0, 3), lookat=(0, 0, 0), vfov=30.0,
                             aspect=1.0)
        cfg = RenderConfig(width=24, height=24, spp=64, max_depth=8,
                           sample_chunk=64)
        img = np.asarray(render(scene, cam, cfg))
        # Center pixels view the sphere head-on.
        center = img[8:16, 8:16].mean()
        assert abs(center - albedo) / albedo < 0.03, (center, albedo)


def _cornell(light_power=15.0):
    b = SceneBuilder()
    red = b.lambertian(b.constant((0.65, 0.05, 0.05)))
    white = b.lambertian(b.constant((0.73, 0.73, 0.73)))
    green = b.lambertian(b.constant((0.12, 0.45, 0.15)))
    light = b.diffuse_light(b.constant((light_power,) * 3))
    b.yz_rect(0, 555, 0, 555, 555, green, flip=True)
    b.yz_rect(0, 555, 0, 555, 0, red)
    lid = b.xz_rect(213, 343, 227, 332, 554, light, flip=True)
    b.xz_rect(0, 555, 0, 555, 555, white, flip=True)
    b.xz_rect(0, 555, 0, 555, 0, white)
    b.xy_rect(0, 555, 0, 555, 555, white, flip=True)
    b.light_rect(lid)
    cam = Camera.look_at(lookfrom=(278, 278, -800), lookat=(278, 278, 0),
                         vfov=40.0, aspect=1.0)
    return b.build(), cam


def test_cornell_smoke():
    scene, cam = _cornell()
    img = np.asarray(render(scene, cam,
                            RenderConfig(width=32, height=32, spp=16,
                                         max_depth=6, sample_chunk=16)))
    assert img.shape == (32, 32, 3)
    assert not np.isnan(img).any()
    assert img.mean() > 0.02
    # Left third greener than right third; right third redder.
    left = img[:, :10].mean(axis=(0, 1))
    right = img[:, -10:].mean(axis=(0, 1))
    assert left[1] > left[0] and right[0] > right[1]


def test_nee_vs_bsdf_only_agree():
    """With and without light registration the estimator must converge to the
    same value (NEE is variance reduction, not a different integral)."""
    def build(register_light):
        b = SceneBuilder()
        white = b.lambertian(b.constant((0.73, 0.73, 0.73)))
        light = b.diffuse_light(b.constant((8.0, 8.0, 8.0)))
        b.xz_rect(-50, 50, -50, 50, 0, white)            # floor
        lid = b.xz_rect(-15, 15, -15, 15, 30, light, flip=True)  # big light
        if register_light:
            b.light_rect(lid)
        return b.build()

    cam = Camera.look_at(lookfrom=(0, 10, 40), lookat=(0, 5, 0), vfov=40.0,
                         aspect=1.0)
    cfg = RenderConfig(width=24, height=24, spp=256, max_depth=4,
                       sample_chunk=128, seed=1)
    a = np.asarray(render(build(True), cam, cfg)).mean()
    b = np.asarray(render(build(False), cam, cfg)).mean()
    assert abs(a - b) / max(a, b) < 0.08, (a, b)


def test_seed_determinism():
    scene, cam = _cornell()
    cfg = RenderConfig(width=16, height=16, spp=8, max_depth=4)
    i1 = np.asarray(render(scene, cam, cfg))
    i2 = np.asarray(render(scene, cam, cfg))
    assert np.array_equal(i1, i2)
    i3 = np.asarray(render(scene, cam,
                           RenderConfig(width=16, height=16, spp=8,
                                        max_depth=4, seed=9)))
    assert not np.array_equal(i1, i3)


def test_pixel_chunking_invariant():
    """Image must not depend on host-side pixel/sample chunk sizes."""
    scene, cam = _cornell()
    a = np.asarray(render(scene, cam, RenderConfig(
        width=16, height=16, spp=8, max_depth=4, pixel_chunk=64,
        sample_chunk=4)))
    b = np.asarray(render(scene, cam, RenderConfig(
        width=16, height=16, spp=8, max_depth=4, pixel_chunk=1 << 16,
        sample_chunk=8)))
    assert np.allclose(a, b, atol=1e-5)


def test_medium_attenuates():
    """A fog sphere in front of a light dims it vs the clear scene."""
    def build(with_fog):
        b = SceneBuilder()
        lid = b.xy_rect(-5, 5, -5, 5, -20, b.diffuse_light(b.constant((4, 4, 4))))
        if with_fog:
            b.medium_sphere((0, 0, -10), 4.0, 0.5, b.constant((0.2, 0.2, 0.2)))
        b.light_rect(lid)
        return b.build()
    cam = Camera.look_at(lookfrom=(0, 0, 0), lookat=(0, 0, -1), vfov=40.0,
                         aspect=1.0)
    cfg = RenderConfig(width=16, height=16, spp=64, max_depth=6,
                       sample_chunk=64)
    clear = np.asarray(render(build(False), cam, cfg)).mean()
    foggy = np.asarray(render(build(True), cam, cfg)).mean()
    assert foggy < clear * 0.8, (foggy, clear)


def test_medium_box_matches_enclosing_behavior():
    """Box-bounded constant medium (the generic convex boundary of
    constant_medium.h): attenuates like the sphere case, and a tiny box
    far from the ray path changes nothing."""
    def build(kind):
        b = SceneBuilder()
        lid = b.xy_rect(-5, 5, -5, 5, -20,
                        b.diffuse_light(b.constant((4, 4, 4))))
        if kind == "box":
            b.medium_box((-4, -4, -14), (4, 4, -6), 0.5,
                         b.constant((0.2, 0.2, 0.2)))
        elif kind == "far_box":
            b.medium_box((50, 50, 50), (51, 51, 51), 0.5,
                         b.constant((0.2, 0.2, 0.2)))
        b.light_rect(lid)
        return b.build()
    cam = Camera.look_at(lookfrom=(0, 0, 0), lookat=(0, 0, -1), vfov=40.0,
                         aspect=1.0)
    cfg = RenderConfig(width=16, height=16, spp=64, max_depth=6,
                       sample_chunk=64)
    clear = np.asarray(render(build("none"), cam, cfg))
    foggy = np.asarray(render(build("box"), cam, cfg))
    far = np.asarray(render(build("far_box"), cam, cfg))
    assert foggy.mean() < clear.mean() * 0.8
    # A medium the ray never crosses must not consume RNG differently
    # for surface paths -> image unchanged up to the extra medium's
    # (unused) free-flight dimension. Allow exact match here because the
    # medium dims are indexed per-medium and the surface path is
    # deterministic given the same stream.
    assert np.isfinite(far).all()
    assert abs(far.mean() - clear.mean()) < 0.02


def test_dome_light_in_nee_list():
    """A dome registered as an NEE *light* (``b.light_sphere``) must still
    give the analytic furnace value: shading points are *inside* the light
    sphere, exercising the uniform-sphere fallback of ``_sphere_sample`` /
    ``_sphere_pdf`` (the cone construction of sphere.h:7-15 degenerates
    there; env_sphere.h:40-48 is the reference's dome-light analogue)."""
    albedo = 0.6
    b = SceneBuilder()
    m = b.lambertian(b.constant((albedo,) * 3))
    b.sphere((0, 0, 0), 1.0, m)
    dome = b.sphere((0, 0, 0), 50.0,
                    b.diffuse_light(b.constant((1.0, 1.0, 1.0))), env=True)
    b.light_sphere(dome)
    scene = b.build()
    cam = Camera.look_at(lookfrom=(0, 0, 3), lookat=(0, 0, 0), vfov=30.0,
                         aspect=1.0)
    cfg = RenderConfig(width=24, height=24, spp=64, max_depth=8,
                       sample_chunk=64)
    img = np.asarray(render(scene, cam, cfg))
    center = img[8:16, 8:16].mean()
    assert abs(center - albedo) / albedo < 0.04, center


def test_medium_mesh_matches_box():
    """Mesh-bounded constant medium (the reference's constant_medium over
    any hitable, triangle.h:108-115 two-sided path): a box tessellated
    into 12 triangles must attenuate identically to the analytic box
    medium (same crossings => same RNG stream => near-identical images),
    including camera rays that START inside the volume."""
    p0, p1 = np.array([-4, -4, -14.0]), np.array([4, 4, -6.0])

    def box_tris(lo, hi):
        x0, y0, z0 = lo
        x1, y1, z1 = hi
        c = np.array([[x0, y0, z0], [x1, y0, z0], [x0, y1, z0],
                      [x1, y1, z0], [x0, y0, z1], [x1, y0, z1],
                      [x0, y1, z1], [x1, y1, z1]], np.float32)
        quads = np.array([[0, 2, 3, 1], [4, 5, 7, 6], [0, 1, 5, 4],
                          [2, 6, 7, 3], [0, 4, 6, 2], [1, 3, 7, 5]])
        f = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])
        return c[f]

    def build(kind, lo=p0, hi=p1):
        b = SceneBuilder()
        lid = b.xy_rect(-5, 5, -5, 5, -20,
                        b.diffuse_light(b.constant((4, 4, 4))))
        if kind == "box":
            b.medium_box(lo, hi, 0.5, b.constant((0.2, 0.2, 0.2)))
        elif kind == "mesh":
            b.medium_mesh(box_tris(lo, hi), 0.5, b.constant((0.2, 0.2, 0.2)))
        b.light_rect(lid)
        return b.build()

    cam = Camera.look_at(lookfrom=(0, 0, 0), lookat=(0, 0, -1), vfov=40.0,
                         aspect=1.0)
    cfg = RenderConfig(width=16, height=16, spp=32, max_depth=6,
                       sample_chunk=32)
    box_img = np.asarray(render(build("box"), cam, cfg))
    mesh_img = np.asarray(render(build("mesh"), cam, cfg))
    np.testing.assert_allclose(mesh_img, box_img, rtol=1e-3, atol=1e-3)

    # Camera inside the volume: entry clamps to 0 (constant_medium.h:23).
    cam_in = Camera.look_at(lookfrom=(0, 0, -10), lookat=(0, 0, -20),
                            vfov=40.0, aspect=1.0)
    bi = np.asarray(render(build("box"), cam_in, cfg))
    mi = np.asarray(render(build("mesh"), cam_in, cfg))
    np.testing.assert_allclose(mi, bi, rtol=1e-3, atol=1e-3)


def test_medium_mesh_trace_size_bounded():
    """The mesh-medium boundary sweep must loop over chunks
    (lax.fori_loop), not unroll them into the traced bounce: a big fog
    mesh's jaxpr must be the same size as a small one's (regression for
    the k/512 Python chunk unroll)."""
    import jax

    from srt.core.ray import Ray
    from srt.render.integrator import _mesh_medium_crossings

    def build(n_quads):
        b = SceneBuilder()
        lid = b.xy_rect(-5, 5, -5, 5, -20,
                        b.diffuse_light(b.constant((4, 4, 4))))
        th = np.linspace(0, 2 * np.pi, n_quads, endpoint=False)
        ring = np.stack([np.cos(th), np.sin(th), np.zeros_like(th)], -1)
        tris = np.stack([ring, np.roll(ring, -1, 0),
                         ring + [0, 0, 1.0]], 1).astype(np.float32)
        b.medium_mesh(tris, 0.5, b.constant((0.2, 0.2, 0.2)))
        b.light_rect(lid)
        return b.build()

    def crossings(scene):
        ray = Ray(origin=np.zeros((8, 3), np.float32),
                  direction=np.tile(np.array([0, 0, -1.0], np.float32),
                                    (8, 1)),
                  time=np.zeros((8,), np.float32))
        return _mesh_medium_crossings(scene, ray, 0)

    small = jax.make_jaxpr(crossings)(build(256))
    big = jax.make_jaxpr(crossings)(build(20000))
    n_small = len(small.jaxpr.eqns)
    n_big = len(big.jaxpr.eqns)
    assert n_big <= n_small + 5, (n_small, n_big)


def test_ref_parity_render_end_to_end():
    """ref_parity mode end-to-end: a diffuse floor under a bright dome
    with a weak rect light renders much darker under parity (diffuse
    surfaces become light-sampling-only, GOLDEN.md) — locking the
    round-3 golden-parity behavior against regressions."""
    b = SceneBuilder()
    ground = b.oren_nayar(b.constant((0.6, 0.6, 0.6)), 0.5)
    b.xz_rect(-50, 50, -50, 50, 0, ground)
    dome = b.sphere((0, 0, 0), 500.0,
                    b.diffuse_light(b.constant((1.0, 1.0, 1.0))), env=True)
    lid = b.xz_rect(-2, 2, -2, 2, 30,
                    b.diffuse_light(b.constant((0.5, 0.5, 0.5))), flip=True)
    b.light_rect(lid)  # the only NEE light; the dome is NOT in hlist
    scene = b.build()
    cam = Camera.look_at(lookfrom=(0, 8, -20), lookat=(0, 0, 0), vfov=40.0,
                         aspect=1.0)
    base = RenderConfig(width=24, height=24, spp=32, max_depth=5,
                        sample_chunk=32)
    std = np.asarray(render(scene, cam, base))
    par = np.asarray(render(scene, cam,
                            RenderConfig(**{**base.__dict__,
                                            "ref_parity": True})))
    # Floor rows (bottom half of the frame view the ground).
    floor_std = std[16:].mean()
    floor_par = par[16:].mean()
    assert np.isfinite(par).all()
    # Standard: floor sees the whole dome (~0.6). Parity: only the weak
    # rect light through NEE cones -> several times darker.
    assert floor_par < 0.5 * floor_std, (floor_par, floor_std)
