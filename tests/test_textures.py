"""Value-level texture + MERL tests (VERDICT r2 item 5): scalar numpy ports
of the reference formulas vs our batched implementations on random inputs.

Ports: checker (texture.h:13-19), perlin noise/turb (perlin.h:7-58), marble
(texture.h:35-46), image indexing (texture.h:58-70), Rusinkiewicz
half/diff indices (brdf.h:17-61,106-153)."""
import numpy as np
import jax.numpy as jnp

from srt.materials.textures import (perlin_noise, perlin_turb,
                                        texture_value)
from srt.scene.build import SceneBuilder


def _scene_tex(fn):
    b = SceneBuilder()
    tid = fn(b)
    b.lambertian(tid)
    return b.build(), tid


def test_checker_values():
    """Scalar port of checker_texture::value (texture.h:13-19)."""
    scene, tid = _scene_tex(lambda b: b.checker((0.2, 0.3, 0.1),
                                                (0.9, 0.9, 0.9)))
    rng = np.random.default_rng(0)
    p = rng.uniform(-3, 3, (256, 3)).astype(np.float32)
    uv = np.zeros((256, 2), np.float32)
    ids = jnp.zeros((256,), jnp.int32) + tid
    got = np.asarray(texture_value(scene, ids, jnp.asarray(uv),
                                   jnp.asarray(p)))
    for i in range(256):
        sines = (np.sin(10 * p[i, 0]) * np.sin(10 * p[i, 1])
                 * np.sin(10 * p[i, 2]))
        want = (0.9, 0.9, 0.9) if sines < 0 else (0.2, 0.3, 0.1)
        np.testing.assert_allclose(got[i], want, atol=1e-6)


def _scalar_perlin_noise(scene, p):
    """Scalar port of perlin::noise (perlin.h:29-46) over OUR tables."""
    vec = np.asarray(scene.perlin_vec)
    perm = np.asarray(scene.perlin_perm)
    u, v, w = (p - np.floor(p))
    i, j, k = (int(np.floor(c)) for c in p)
    uu, vv, ww = (c * c * (3 - 2 * c) for c in (u, v, w))
    acc = 0.0
    for di in range(2):
        for dj in range(2):
            for dk in range(2):
                g = vec[perm[0][(i + di) & 255] ^ perm[1][(j + dj) & 255]
                        ^ perm[2][(k + dk) & 255]]
                weight = np.array([u - di, v - dj, w - dk])
                acc += ((di * uu + (1 - di) * (1 - uu))
                        * (dj * vv + (1 - dj) * (1 - vv))
                        * (dk * ww + (1 - dk) * (1 - ww))
                        * float(g @ weight))
    return acc


def _scalar_turb(scene, p, depth=7):
    acc, weight, q = 0.0, 1.0, np.array(p, np.float64)
    for _ in range(depth):
        acc += weight * _scalar_perlin_noise(scene, q)
        weight *= 0.5
        q = q * 2
    return abs(acc)


def test_perlin_matches_scalar_port():
    scene, tid = _scene_tex(lambda b: b.noise(4.0))
    rng = np.random.default_rng(1)
    pts = rng.uniform(-5, 5, (64, 3)).astype(np.float32)
    got = np.asarray(perlin_noise(scene, jnp.asarray(pts)))
    want = np.array([_scalar_perlin_noise(scene, q) for q in pts])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # turbulence too
    got_t = np.asarray(perlin_turb(scene, jnp.asarray(pts[:16])))
    want_t = np.array([_scalar_turb(scene, q) for q in pts[:16]])
    np.testing.assert_allclose(got_t, want_t, rtol=1e-3, atol=1e-4)


def test_marble_texture_value():
    """0.5*(1+sin(scale*z + 5*turb(scale*p))) (texture.h:42)."""
    scene, tid = _scene_tex(lambda b: b.noise(4.0))
    rng = np.random.default_rng(2)
    p = rng.uniform(-2, 2, (16, 3)).astype(np.float32)
    ids = jnp.zeros((16,), jnp.int32) + tid
    got = np.asarray(texture_value(scene, ids, jnp.zeros((16, 2)),
                                   jnp.asarray(p)))
    for i in range(16):
        want = 0.5 * (1 + np.sin(4.0 * p[i, 2]
                                 + 5.0 * _scalar_turb(scene, 4.0 * p[i])))
        np.testing.assert_allclose(got[i], [want] * 3, rtol=1e-3, atol=1e-4)


def test_image_texture_indexing():
    """Scalar port of image_texture::value (texture.h:58-70): nearest
    neighbor, v-flip with the -0.001 bias, clamped."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (7, 5, 3)).astype(np.float32)  # ny=7, nx=5
    scene, tid = _scene_tex(lambda b: b.image(img))
    uv = rng.uniform(-0.2, 1.2, (128, 2)).astype(np.float32)
    ids = jnp.zeros((128,), jnp.int32) + tid
    got = np.asarray(texture_value(scene, ids, jnp.asarray(uv),
                                   jnp.zeros((128, 3))))
    ny, nx = img.shape[:2]
    for q in range(128):
        u, v = uv[q]
        i = int(u * nx)
        j = int((1 - v) * ny - 0.001)
        i = min(max(i, 0), nx - 1)
        j = min(max(j, 0), ny - 1)
        np.testing.assert_allclose(got[q], img[j, i], atol=1e-6,
                                   err_msg=f"uv={u},{v}")


# ---------------------------------------------------------------------------
# MERL
# ---------------------------------------------------------------------------

def _scalar_half_diff_index(wo, wi):
    """Scalar port of std_coords_to_half_diff_coords + index quantization
    (brdf.h:17-61,106-153), vectors already in the local z-up frame."""
    half = (wo + wi)
    half = half / np.linalg.norm(half)
    theta_half = np.arccos(np.clip(half[2], -1, 1))
    fi_half = np.arctan2(half[1], half[0])

    def rotate(vec, axis, angle):
        cos_a, sin_a = np.cos(angle), np.sin(angle)
        return (vec * cos_a + axis * (axis @ vec) * (1 - cos_a)
                + np.cross(axis, vec) * sin_a)

    normal = np.array([0.0, 0.0, 1.0])
    binormal = np.array([0.0, 1.0, 0.0])
    diff = rotate(rotate(wi, normal, -fi_half), binormal, -theta_half)
    theta_diff = np.arccos(np.clip(diff[2], -1, 1))
    fi_diff = np.arctan2(diff[1], diff[0])

    # theta_half_index (brdf.h:17-29)
    if theta_half <= 0:
        th = 0
    else:
        th = int(np.sqrt(theta_half / (np.pi / 2) * 90 * 90))
        th = min(max(th, 0), 89)
    td = min(max(int(theta_diff / (np.pi * 0.5) * 90), 0), 89)
    if fi_diff < 0:
        fi_diff += np.pi
    pd = min(max(int(fi_diff / np.pi * 180), 0), 179)
    return pd + td * 180 + th * 180 * 90


def test_merl_indices_match_scalar_port():
    from srt.materials.merl import half_diff_indices

    rng = np.random.default_rng(4)
    n = 256
    wo = rng.normal(size=(n, 3))
    wi = rng.normal(size=(n, 3))
    wo[:, 2] = np.abs(wo[:, 2]) + 0.05
    wi[:, 2] = np.abs(wi[:, 2]) + 0.05
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    got = np.asarray(half_diff_indices(jnp.asarray(wo, jnp.float32),
                                       jnp.asarray(wi, jnp.float32)))
    want = np.array([_scalar_half_diff_index(wo[i], wi[i])
                     for i in range(n)])
    # f32 vs f64 rounding can shift a quantized bin at cell borders;
    # demand exact match for the overwhelming majority.
    frac = (got == want).mean()
    assert frac > 0.97, frac


def test_merl_renders_and_differentiates():
    """A synthetic constant MERL table f = 1/pi renders like a white
    furnace (Lo = albedo) and carries gradients to the table."""
    import jax

    from srt import RenderConfig, render
    from srt.render.camera import Camera

    def build(scale=1.0):
        b = SceneBuilder()
        table = np.full((3, 90 * 90 * 180), scale / np.pi, np.float32)
        m = b.merl(table, (1.0, 1.0, 1.0))
        b.sphere((0, 0, 0), 1.0, m)
        b.sphere((0, 0, 0), 50.0,
                 b.diffuse_light(b.constant((1.0, 1.0, 1.0))), env=True)
        return b.build()

    scene = build()
    cam = Camera.look_at(lookfrom=(0, 0, 3), lookat=(0, 0, 0), vfov=30.0,
                         aspect=1.0)
    cfg = RenderConfig(width=16, height=16, spp=64, max_depth=6,
                       sample_chunk=64)
    img = np.asarray(render(scene, cam, cfg))
    center = img[5:11, 5:11].mean()
    assert abs(center - 1.0) < 0.05, center

    # Gradient w.r.t. the measured table flows and is positive.
    from srt.core.rng import RaySampler
    from srt.render.integrator import trace

    n = 256
    rng = np.random.default_rng(5)
    pix = jnp.asarray(rng.integers(0, 16 * 16, n), jnp.int32)
    sampler = RaySampler.create(0, pix, jnp.zeros((n,), jnp.int32))
    s = ((pix % 16).astype(jnp.float32) + 0.5) / 16
    t = ((16 - 1 - pix // 16).astype(jnp.float32) + 0.5) / 16
    rays = cam.rays(s, t, sampler.uniform(32), sampler.uniform(33),
                    sampler.uniform(34))

    def loss(tables):
        out = trace(scene._replace(merl=tables), rays, sampler,
                    max_depth=4, rr_start=1 << 30)
        return jnp.mean(out)

    g = jax.grad(loss)(scene.merl)
    g = np.asarray(g)
    assert np.isfinite(g).all()
    assert g.sum() > 0.0


def test_atlas_u32_packing_matches_f32():
    """The packed rgb8 atlas twin (Scene.atlas_u32, one gather per texel)
    must reproduce the f32 atlas path to <= 1 ulp (an accelerator may
    lower /255.0 with excess precision; on CPU it is bit-exact). Built for every u8-decoded
    image; float-sourced atlases fall back (atlas_u32 None)."""
    import numpy as np
    import jax.numpy as jnp

    from srt.materials.textures import _image_value
    from srt.scene.build import SceneBuilder

    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (16, 24, 3), dtype=np.uint8)
    b = SceneBuilder()
    t = b.image(img)
    b.sphere((0, 0, 0), 1.0, b.lambertian(t))
    lid = b.xz_rect(-1, 1, -1, 1, 5, b.diffuse_light(b.constant((4, 4, 4))))
    b.light_rect(lid)
    scene = b.build()
    assert scene.atlas_u32 is not None

    n = 2048
    tid = jnp.zeros((n,), jnp.int32) + t
    u = jnp.asarray(rng.random(n, dtype=np.float32))
    v = jnp.asarray(rng.random(n, dtype=np.float32))
    fast = np.asarray(_image_value(scene, tid, u, v))
    slow = np.asarray(_image_value(scene._replace(atlas_u32=None), tid, u, v))
    np.testing.assert_allclose(fast, slow, atol=1.2e-7, rtol=0)
    # round-trips the exact u8 grid
    assert set(np.unique(np.round(fast * 255))) <= set(range(256))
