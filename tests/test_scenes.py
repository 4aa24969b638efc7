"""Scene library tests: every reference scene builds and smoke-renders.

Renders are tiny (<= 24^2, 2 spp) — the goal is structural validity
(finite radiance, right light registration, plausible hues), not quality;
golden-image PSNR lives in test_golden.py.
"""
import warnings

import numpy as np
import pytest

from srt import RenderConfig, render
from srt.io.assets import find_asset
from srt.scene.library import SCENES, get_scene
from srt.scene.teapot import create_teapot

_HAVE_ASSETS = find_asset("environment_map/sky_2.png") is not None

_SMALL = {"teapot_scene": dict(divs=6), "final": dict(n_cluster=40),
          "final1": dict(n_cluster=40), "random_scene": dict(n_grid=4)}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_builds(name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene, cam, info = get_scene(name, aspect=1.0, max_tex=32,
                                     **_SMALL.get(name, {}))
    assert scene.n_lights >= 1
    assert info["lights"] in (1, 6) or name == "cornell_boxes"
    # every material id in every primitive table is valid
    n_mat = scene.mat_type.shape[0]
    for tbl in (scene.sph_mat, scene.rect_mat, scene.tri_mat, scene.med_mat):
        if tbl.shape[0]:
            assert int(tbl.max()) < n_mat and int(tbl.min()) >= 0


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_smoke_renders(name):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene, cam, _ = get_scene(name, aspect=1.0, max_tex=32,
                                  **_SMALL.get(name, {}))
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=4)
    img = np.asarray(render(scene, cam, cfg))
    assert np.isfinite(img).all(), name
    assert (img >= 0).all(), name
    assert img.mean() > 1e-4, f"{name}: black image"


def test_cornell_boxes_hues():
    """Green wall on image LEFT, red on RIGHT (camera looks +z)."""
    scene, cam, _ = get_scene("cornell_boxes")
    img = np.asarray(render(
        scene, cam, RenderConfig(width=32, height=32, spp=16, max_depth=6)))
    left = img[8:24, :8].mean(axis=(0, 1))
    right = img[8:24, -8:].mean(axis=(0, 1))
    assert left[1] > left[0], f"left wall not green: {left}"
    assert right[0] > right[1], f"right wall not red: {right}"


def test_get_scene_aliases():
    s1, _, _ = get_scene("boxes")
    s2, _, _ = get_scene("cornell_boxes")
    assert s1.rect_k.shape == s2.rect_k.shape
    with pytest.raises(KeyError):
        get_scene("nope")


@pytest.mark.skipif(not _HAVE_ASSETS, reason="reference assets not mounted")
def test_cornell_box_reference_layout():
    """The reference cornell_box: bunny mesh present, env dome emitter,
    one NEE rect light at y=800 (Raytracing_n.cpp:261,273)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        scene, cam, info = get_scene("cornell_box", max_tex=32)
    assert scene.n_tris == 69451          # bunny
    assert scene.n_spheres == 1           # env dome
    assert bool(scene.sph_flip[0])        # flip_normals(sphere(...))
    assert float(scene.rect_k[int(scene.light_index[0])]) == 800.0
    assert not info.get("skipped")


# ------------------------------------------------------------------ teapot
def test_teapot_tessellation_counts():
    m = create_teapot(scale=1.0, divs=4)
    # 32 patches * divs^2 quads * 2 tris, minus degenerate collapsed tris
    assert 32 * 4 * 4 * 2 * 0.8 <= m.n_tris <= 32 * 4 * 4 * 2
    assert np.isfinite(m.positions).all()
    assert m.uvs is not None


def test_teapot_smooth_normals_unit():
    m = create_teapot(scale=2.0, divs=6, smooth=True)
    ln = np.linalg.norm(m.normals, axis=-1)
    np.testing.assert_allclose(ln, 1.0, atol=1e-4)


def test_teapot_scale_linearity():
    a = create_teapot(scale=1.0, divs=3).positions
    b = create_teapot(scale=40.0, divs=3).positions
    np.testing.assert_allclose(b, a * 40.0, rtol=1e-5)


def test_box_instancing_rotate_translate():
    """Baked box instancing (the reference's translate(rotate_y(box)),
    hitable.h:35-132): a rotated box renders a rotated silhouette and a
    pure translation matches an axis-aligned box built at the target."""
    import numpy as np
    from srt import RenderConfig, render
    from srt.render.camera import Camera
    from srt.scene.build import SceneBuilder, rotation_y

    def build(rotate, translate, direct=None):
        b = SceneBuilder()
        white = b.lambertian(b.constant((0.73, 0.73, 0.73)))
        light = b.diffuse_light(b.constant((8.0, 8.0, 8.0)))
        lid = b.xz_rect(-3, 3, -3, 3, 8, light, flip=True)
        if direct is not None:
            b.box(direct[0], direct[1], white, as_tris=True)
        else:
            b.box((-1, 0, -1), (1, 2, 1), white, rotate=rotate,
                  translate=translate)
        b.light_rect(lid)
        cam = Camera.look_at(lookfrom=(0, 3, -9), lookat=(0, 1, 0),
                             vfov=35.0, aspect=1.0)
        return b.build(), cam

    cfg = RenderConfig(width=24, height=24, spp=4, max_depth=3)

    # Pure translation == axis-aligned box at the target position.
    s1, c1 = build(None, (0.5, 0.0, 0.5))
    s2, c2 = build(None, (0, 0, 0), direct=((-0.5, 0, -0.5), (1.5, 2, 1.5)))
    a = np.asarray(render(s1, c1, cfg))
    b_ = np.asarray(render(s2, c2, cfg))
    np.testing.assert_allclose(a, b_, atol=2e-5)

    # 45-degree rotation changes the image (silhouette widens).
    s3, c3 = build(rotation_y(45.0), (0, 0, 0))
    s0, c0 = build(None, (0, 0, 0))
    r45 = np.asarray(render(s3, c3, cfg))
    r0 = np.asarray(render(s0, c0, cfg))
    assert np.isfinite(r45).all()
    assert np.abs(r45 - r0).max() > 0.01


def test_random_scene_smoke():
    """RTiOW-cover scene (Raytracing_n.cpp:108-176): checker ground,
    moving spheres, cubemap env faces as lights — smoke render."""
    import numpy as np
    from srt import RenderConfig, render
    from srt.scene.library import get_scene
    from srt.scene.ir import MaterialType, TextureType

    scene, cam, info = get_scene("random_scene", aspect=1.0, max_tex=64,
                                 n_grid=4)
    assert info["lights"] == 6
    # exercises checker + moving spheres (center0 != center1 somewhere)
    tt = np.asarray(scene.tex_type)
    assert (tt == TextureType.CHECKER).any()
    assert (np.asarray(scene.sph_center0)
            != np.asarray(scene.sph_center1)).any()
    img = np.asarray(render(scene, cam, RenderConfig(
        width=24, height=24, spp=4, max_depth=5)))
    assert np.isnan(img).sum() == 0
    assert img.mean() > 0.01


def test_final1_layout():
    """final1 (Raytracing_n.cpp:693-711) = TNW light + the rotated
    1000-sphere cube, nothing else — a strict subset of ``final``."""
    scene, cam, info = get_scene("final1")
    assert scene.n_spheres == 1000
    assert np.allclose(np.asarray(scene.sph_radius), 10.0)
    assert scene.n_rects == 1          # the area light
    assert scene.n_tris == 0 and scene.n_media == 0
    assert scene.n_lights == 1 and info["lights"] == 1
    # the cluster's sphere cloud sits in the rotated [0,165]^3 cube
    c = np.asarray(scene.sph_center0)
    assert c[:, 1].min() > 260 and c[:, 1].max() < 165 + 280
