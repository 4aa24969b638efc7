"""The reference scene library: all eight active scenes as builder functions.

Re-creations of the hardcoded scene builders in
``Raytracing_n/Raytracing_n.cpp:108-711`` (selected there by the
compile-time global ``sceneid``, ``:43``; here by name via
:func:`get_scene` / the CLI). Every function returns
``(scene, camera, info)`` where ``info`` carries the NEE light list size
and any skipped assets.

Scenes and their reference lines:

* ``cornell_box``      — :216-304 (bunny + sky_2 dome + Oren–Nayar floor)
* ``teapot_scene``     — :306-377 (two Bézier teapots, bunny, fog sphere)
* ``ball_scenes``      — :379-425 (11x11 Beckmann roughness sweep; the
  reference *default*, ``sceneid = 2``)
* ``ball_orennayar_scenes`` — :427-473 (sigma sweep 0..20)
* ``final``            — :475-533 (TNW final: box terrain, volumes, earth)
* ``jadebunny_scene``  — :535-583 (glass bunny nested over blue bunny)
* ``soldier_scene``    — :585-657 (FBX soldier, wood+glass floor, sky4)
* ``flatnormal_bunny`` — :659-691 (gold Beckmann bunny, flat normals)

Plus ``cornell_boxes``: a self-contained classic Cornell (no external
assets) used by CI, ``bench.py`` fallback, and ``__graft_entry__``.

Asset handling differs from the reference by design: missing files degrade
to stand-ins with a warning (the reference would crash on a null stbi
pointer) and are reported in ``info["skipped"]``; the dragon and the MERL
binaries are LFS-stripped in the mirrored checkout.
"""
from __future__ import annotations

import warnings

import numpy as np

from srt.io.assets import find_asset, load_image_asset
from srt.render.camera import Camera
from srt.scene.build import SceneBuilder, rotation_x, rotation_y

#: Names accepted by :func:`get_scene`, ordered like the reference's
#: ``sceneid`` switch (``Raytracing_n.cpp:894-921``).
SCENES = {}


def _register(fn):
    SCENES[fn.__name__] = fn
    return fn


def list_scenes() -> list[str]:
    """All registered scene names (library order)."""
    return list(SCENES)


def get_scene(name: str, aspect: float = 1.0, **kw):
    """Build a scene by name (+aliases: ``cornell``, ``balls``, ...)."""
    aliases = {"cornell": "cornell_box", "teapot": "teapot_scene",
               "balls": "ball_scenes", "orennayar": "ball_orennayar_scenes",
               "jade": "jadebunny_scene", "soldier": "soldier_scene",
               "flatnormal": "flatnormal_bunny", "boxes": "cornell_boxes"}
    key = aliases.get(name, name)
    if key not in SCENES:
        raise KeyError(f"unknown scene {name!r}; have {sorted(SCENES)}")
    return SCENES[key](aspect=aspect, **kw)


def _maybe_downsample(img: np.ndarray, max_tex: int | None) -> np.ndarray:
    """Stride-downsample an image texture (render-size knob for CPU CI;
    lookups are nearest-neighbor anyway, ``texture.h:58-70``)."""
    if max_tex is None:
        return img
    step = max(1, int(np.ceil(max(img.shape[:2]) / max_tex)))
    return img[::step, ::step]


def _env_dome(b: SceneBuilder, lookfrom, image_rel: str, info: dict,
              max_tex: int | None, fallback=(0.6, 0.7, 0.9)) -> None:
    """The reference's IBL dome: ``flip_normals(sphere(lookfrom, 10000,
    diffuse_light(image)))`` (e.g. ``Raytracing_n.cpp:269-270``)."""
    if find_asset(image_rel) is None:
        info.setdefault("skipped", []).append(image_rel)
    img = _maybe_downsample(
        load_image_asset(image_rel, fallback_color=fallback), max_tex)
    tex = b.image(img)
    b.sphere(lookfrom, 10000.0, b.diffuse_light(tex), flip=True)


@_register
def random_scene(aspect: float = 1.0, max_tex: int | None = None,
                 n_grid: int = 11, seed: int = 7, **_kw):
    """Reference scene ``random_scene`` (``Raytracing_n.cpp:108-176``):
    the RTiOW cover — checker ground, 22x22 grid of random drifting
    (motion-blurred) lambertian / metal / dielectric spheres, three hero
    spheres — inside a six-face **cubemap environment** (sky_1
    Front..Bottom as inward diffuse-light rects, ``:152-170``), all six
    faces registered as NEE lights (``*hlist``, ``:172``).

    The reference's layout is a drand48 sequence (unseeded, per-run
    random); we use a pinned numpy seed — same distribution, stable
    fixture.
    """
    b = SceneBuilder()
    info: dict = {}
    rng = np.random.default_rng(seed)

    checker = b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(checker))

    gray = b.lambertian(b.constant((0.5, 0.5, 0.5)))
    glass = b.dielectric(1.5)
    for a in range(-n_grid, n_grid):
        for c in range(-n_grid, n_grid):
            choose = rng.uniform()
            center = np.array([a + 0.9 * rng.uniform(), 0.2,
                               c + 0.9 * rng.uniform()], np.float32)
            if np.linalg.norm(center - np.array([4, 0.2, 0])) <= 0.9:
                continue
            if choose < 0.8:  # drifting gray lambertian (moving_sphere)
                b.sphere(center, 0.2, gray,
                         center1=center + np.array([0, 0.5 * rng.uniform(),
                                                    0], np.float32))
            elif choose < 0.95:
                metal = b.metal((0.5 * (1 + rng.uniform()),
                                 0.5 * (1 + rng.uniform()),
                                 0.5 * (1 + rng.uniform())),
                                0.5 * rng.uniform())
                b.sphere(center, 0.2, metal)
            else:
                b.sphere(center, 0.2, glass)

    b.sphere((0, 1, 0), 1.0, glass)
    b.sphere((-4, 1, 0), 1.0, b.lambertian(b.constant((0.4, 0.2, 0.1))))
    b.sphere((4, 1, 0), 1.0, b.metal((0.7, 0.6, 0.5), 0.0))

    # Six-face cube environment, inward normals (Raytracing_n.cpp:152-170).
    def face(rel, add):
        if find_asset(f"environment_map/sky_1/{rel}.jpg") is None:
            info.setdefault("skipped", []).append(f"sky_1/{rel}")
        img = _maybe_downsample(load_image_asset(
            f"environment_map/sky_1/{rel}.jpg", (0.6, 0.7, 0.9)), max_tex)
        rid = add(b.diffuse_light(b.image(img)))
        b.light_rect(rid)

    # Deviation from a reference *bug*, intended behavior kept (SURVEY §7):
    # its Left/Right faces (:156-161) have outward normals, so the
    # one-sided emitter (material.h:348-354) renders them black; all six
    # faces here emit inward.
    e = 100.0
    face("Front", lambda m: b.xy_rect(-e, e, -e, e, -e, m))
    face("Back", lambda m: b.xy_rect(-e, e, -e, e, e, m, flip=True))
    face("Left", lambda m: b.yz_rect(-e, e, -e, e, e, m, flip=True))
    face("Right", lambda m: b.yz_rect(-e, e, -e, e, -e, m))
    face("Top", lambda m: b.xz_rect(-e, e, -e, e, e, m, flip=True))
    face("Bottom", lambda m: b.xz_rect(-e, e, -e, e, -e, m))

    cam = Camera.look_at((-10.0, 6.0, -15.0), (0.0, 0.0, 0.0), vfov=40.0,
                         aspect=aspect, aperture=0.0, focus_dist=10.0)
    info["lights"] = 6
    return b.build(), cam, info


def _rtiow_cam(aspect: float) -> Camera:
    """The RTiOW-era camera these dead fixtures were written for."""
    return Camera.look_at((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                          aspect=aspect, aperture=0.0, focus_dist=10.0)


@_register
def two_spheres(aspect: float = 1.0, ambient: float = 1.0, **_kw):
    """Dead reference fixture ``two_spheres`` (``Raytracing_n.cpp:178-187``):
    two giant checker spheres. The source builds no camera/lights for it
    (unreachable from ``main``); we add the canonical RTiOW camera and,
    since this renderer has no sky-gradient background, a dim white dome
    (``ambient=0`` disables) so the fixture actually renders."""
    b = SceneBuilder()
    checker = b.lambertian(b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))
    b.sphere((0, -10, 0), 10.0, checker)
    b.sphere((0, 10, 0), 10.0, checker)
    if ambient > 0:
        dome = b.sphere((0, 0, 0), 1000.0,
                        b.diffuse_light(b.constant((ambient,) * 3)), env=True)
        b.light_sphere(dome)
    return b.build(), _rtiow_cam(aspect), {"lights": 1 if ambient > 0 else 0}


@_register
def two_perlin_spheres(aspect: float = 1.0, ambient: float = 1.0, **_kw):
    """Dead reference fixture (``Raytracing_n.cpp:188-195``): marble-noise
    ground + sphere (scale 1). Camera/dome as :func:`two_spheres`."""
    b = SceneBuilder()
    per = b.lambertian(b.noise(1.0))
    b.sphere((0, -1000, 0), 1000.0, per)
    b.sphere((0, 2, 0), 2.0, per)
    if ambient > 0:
        dome = b.sphere((0, 0, 0), 5000.0,
                        b.diffuse_light(b.constant((ambient,) * 3)), env=True)
        b.light_sphere(dome)
    return b.build(), _rtiow_cam(aspect), {"lights": 1 if ambient > 0 else 0}


@_register
def earth_sphere(aspect: float = 1.0, max_tex: int | None = None, **_kw):
    """Dead reference fixture ``earth_shpere`` [sic]
    (``Raytracing_n.cpp:196-205``): an *emissive* earthmap sphere over a
    white ground."""
    b = SceneBuilder()
    info: dict = {"lights": 1}
    if find_asset("textures/earthmap.jpg") is None:
        info.setdefault("skipped", []).append("textures/earthmap.jpg")
    earth = b.image(_maybe_downsample(load_image_asset(
        "textures/earthmap.jpg", (0.2, 0.4, 0.8)), max_tex))
    b.sphere((0, -1000, 0), 1000.0,
             b.lambertian(b.constant((0.9, 0.9, 0.9))))
    sid = b.sphere((0, 2, 0), 2.0, b.diffuse_light(earth))
    b.light_sphere(sid)
    return b.build(), _rtiow_cam(aspect), info


@_register
def simple_light(aspect: float = 1.0, **_kw):
    """Dead reference fixture (``Raytracing_n.cpp:206-215``): marble
    ground + sphere lit by a small xy_rect emitter."""
    b = SceneBuilder()
    per = b.lambertian(b.noise(4.0))
    b.sphere((0, -1000, 0), 1000.0, per)
    b.sphere((0, 2, 0), 2.0, per)
    lid = b.xy_rect(3, 5, 1, 3, -2, b.diffuse_light(b.constant((4, 4, 4))))
    b.light_rect(lid)
    cam = Camera.look_at((26.0, 4.0, 6.0), (0.0, 2.0, 0.0), vfov=20.0,
                         aspect=aspect, aperture=0.0, focus_dist=10.0)
    return b.build(), cam, {"lights": 1}


@_register
def cornell_boxes(aspect: float = 1.0, **_kw):
    """Self-contained classic Cornell box (green/red walls, two boxes).

    Matches the *Rest of Your Life* Cornell the reference's ``cornell_box``
    evolved from (its walls are in the source, commented out,
    ``Raytracing_n.cpp:258-265``); no external assets, so it runs anywhere.
    """
    b = SceneBuilder()
    red = b.lambertian(b.constant((0.65, 0.05, 0.05)))
    white = b.lambertian(b.constant((0.73, 0.73, 0.73)))
    green = b.lambertian(b.constant((0.12, 0.45, 0.15)))
    light = b.diffuse_light(b.constant((15.0, 15.0, 15.0)))

    b.yz_rect(0, 555, 0, 555, 555, green, flip=True)
    b.yz_rect(0, 555, 0, 555, 0, red)
    lid = b.xz_rect(213, 343, 227, 332, 554, light, flip=True)
    b.xz_rect(0, 555, 0, 555, 0, white)
    b.xz_rect(0, 555, 0, 555, 555, white, flip=True)
    b.xy_rect(0, 555, 0, 555, 555, white, flip=True)
    b.box((130, 0, 65), (295, 165, 230), white, as_tris=True)
    b.box((265, 0, 295), (430, 330, 460), white, as_tris=True)
    b.light_rect(lid)

    cam = Camera.look_at((278, 278, -800), (278, 278, 0), vfov=40.0,
                         aspect=aspect, aperture=0.0, focus_dist=10.0)
    return b.build(), cam, {"lights": 1}


@_register
def cornell_box(aspect: float = 1.0, max_tex: int | None = None,
                bunny_scale: float = 2000.0, **_kw):
    """Reference scene 0 (``Raytracing_n.cpp:216-304``)."""
    from srt.io.mesh import load_mesh

    lookfrom = (300.0, 500.0, -800.0)
    b = SceneBuilder()
    info: dict = {}

    light = b.diffuse_light(b.constant((45.0, 45.0, 45.0)))
    on_white_0 = b.oren_nayar(b.constant((0.7, 0.7, 0.7)), 0.0)
    on_white_10 = b.oren_nayar(b.constant((0.7, 0.7, 0.7)), 10.0)

    lid = b.xz_rect(203, 353, 217, 343, 800, light, flip=True)   # :261
    b.xz_rect(0, 555, 0, 555, 0, on_white_0)                     # :264
    _env_dome(b, lookfrom, "environment_map/sky_2.png", info, max_tex)

    ply = find_asset("models/bunny.ply")
    if ply is None:
        info.setdefault("skipped", []).append("models/bunny.ply")
    else:
        b.trimesh(load_mesh(ply), on_white_10, scale=bunny_scale,
                  rotate=rotation_y(180.0), translate=(250, -70, 400),
                  flip_winding=True)                              # :273-274
    b.light_rect(lid)                                             # :285,303

    cam = Camera.look_at(lookfrom, (300, 278, 200), vfov=40.0,
                         aspect=aspect, aperture=0.0, focus_dist=10.0)
    info["lights"] = 1
    return b.build(), cam, info


@_register
def teapot_scene(aspect: float = 1.0, max_tex: int | None = None,
                 divs: int = 100, **_kw):
    """Reference scene 1 (``Raytracing_n.cpp:306-377``). ``divs`` exposes
    the hardcoded tessellation (``teapot.h:77``; 100 = 640k tris)."""
    from srt.io.mesh import load_mesh
    from srt.scene.teapot import create_teapot

    lookfrom = (100.0, 800.0, -400.0)
    b = SceneBuilder()
    info: dict = {}

    light = b.diffuse_light(b.constant((40.0, 40.0, 40.0)))
    lam_brown = b.lambertian(b.constant((0.426, 0.3, 0.254)))
    on_white = b.oren_nayar(b.constant((1.0, 1.0, 1.0)), 10.0)
    beck_gold = b.beckmann(b.constant((0.945, 0.75, 0.336)), 0.01, 0.05)
    beck_silver = b.beckmann(b.constant((0.8, 0.85, 0.88)), 0.1, 0.1)
    mirror = b.metal((0.9, 0.9, 0.9), 0.0)

    lid = b.xz_rect(3, 153, 217, 343, 800, light, flip=True)     # :336
    b.xz_rect(0, 555, 0, 555, 0, lam_brown)                      # :338
    _env_dome(b, lookfrom, "environment_map/sky_2.png", info, max_tex)

    pot = create_teapot(scale=40.0, divs=divs)                   # :348-354
    b.trimesh(pot, mirror, rotate=rotation_x(90.0), translate=(200, 0, 250))
    b.trimesh(pot, beck_gold, rotate=rotation_x(90.0), translate=(360, 0, 150))

    ply = find_asset("models/bunny.ply")
    if ply is None:
        info.setdefault("skipped", []).append("models/bunny.ply")
    else:
        b.trimesh(load_mesh(ply), on_white, scale=2000.0,
                  rotate=rotation_y(180.0), translate=(180, -70, 450),
                  flip_winding=True)                              # :356-357

    b.sphere((280, 30, 70), 30.0, b.dielectric(1.5))              # :360
    b.medium_sphere((280, 30, 70), 30.0, 0.2,
                    b.constant((0.2, 0.4, 0.9)))                  # :362

    dragon = find_asset("models/dragon.ply")                      # :364-366
    if dragon is None:
        info.setdefault("skipped", []).append("models/dragon.ply")
        warnings.warn("dragon.ply is LFS-stripped from the reference "
                      "checkout; teapot_scene renders without it")
    else:
        b.trimesh(load_mesh(dragon), beck_silver, scale=500.0,
                  rotate=rotation_y(180.0), translate=(140, -20, 120),
                  flip_winding=True)
    b.light_rect(lid)

    cam = Camera.look_at(lookfrom, (300, 278, 200), vfov=40.0,
                         aspect=aspect, aperture=0.0, focus_dist=10.0)
    info["lights"] = 1
    return b.build(), cam, info


@_register
def ball_scenes(aspect: float = 1.0, max_tex: int | None = None, **_kw):
    """Reference scene 2, the default (``Raytracing_n.cpp:379-425``):
    11x11 spheres sweeping anisotropic Beckmann roughness."""
    lookfrom = (300.0, 600.0, -100.0)
    b = SceneBuilder()
    info: dict = {}

    light = b.diffuse_light(b.constant((20.0, 20.0, 20.0)))
    on_brown = b.oren_nayar(b.constant((0.426, 0.3, 0.254)), 0.0)

    lid = b.xz_rect(203, 353, 217, 343, 800, light, flip=True)   # :396
    b.xz_rect(-100, 655, -100, 655, 0, on_brown)                 # :397
    _env_dome(b, lookfrom, "environment_map/sky_2.png", info, max_tex)

    white = b.constant((1.0, 1.0, 1.0))
    for j in range(121):                                          # :404-411
        mat = b.beckmann(white, (j % 11) / 11.0, (j // 11) / 11.0)
        b.sphere((550.0 - (j % 11) * 50.0, 20.0, 450.0 - 50.0 * (j // 11)),
                 20.0, mat)
    b.light_rect(lid)

    cam = Camera.look_at(lookfrom, (300, 20, 250), vfov=40.0,
                         aspect=aspect, aperture=0.0, focus_dist=10.0)
    info["lights"] = 1
    return b.build(), cam, info


@_register
def ball_orennayar_scenes(aspect: float = 1.0, max_tex: int | None = None,
                          **_kw):
    """Reference scene 3 (``Raytracing_n.cpp:427-473``): Oren–Nayar sigma
    sweep 0..20 degrees over 21 spheres."""
    lookfrom = (300.0, 800.0, -100.0)
    b = SceneBuilder()
    info: dict = {}

    light = b.diffuse_light(b.constant((20.0, 20.0, 20.0)))
    on_brown = b.oren_nayar(b.constant((0.426, 0.3, 0.254)), 0.0)

    lid = b.xz_rect(203, 353, 217, 343, 800, light, flip=True)   # :444
    b.xz_rect(-100, 655, -100, 655, 0, on_brown)                 # :445
    _env_dome(b, lookfrom, "environment_map/sky_2.png", info, max_tex)

    white = b.constant((1.0, 1.0, 1.0))
    for j in range(21):                                           # :452-459
        mat = b.oren_nayar(white, float(j))
        b.sphere((550.0 - (j % 7) * 70.0, 30.0, 450.0 - 70.0 * (j // 7)),
                 30.0, mat)
    b.light_rect(lid)

    cam = Camera.look_at(lookfrom, (300, 20, 450), vfov=40.0,
                         aspect=aspect, aperture=0.0, focus_dist=10.0)
    info["lights"] = 1
    return b.build(), cam, info


@_register
def final(aspect: float = 1.0, max_tex: int | None = None, seed: int = 1,
          n_cluster: int = 1000, **_kw):
    """Reference scene 5 (``Raytracing_n.cpp:475-533``): *The Next Week*
    final scene. The reference draws box heights / cluster positions from
    its global LCG mid-build (interleaved with BVH construction, so the
    exact sequence is irreproducible by design); we pin a numpy seed —
    same distribution, deterministic geometry.
    """
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    info: dict = {}

    white = b.lambertian(b.constant((0.73, 0.73, 0.73)))
    ground = b.lambertian(b.constant((0.48, 0.83, 0.53)))

    for i in range(20):                                           # :483-494
        for j in range(20):
            w = 100.0
            x0, z0 = -1000.0 + i * w, -1000.0 + j * w
            y1 = 100.0 * (rng.random() + 0.01)
            b.box((x0, 0.0, z0), (x0 + w, y1, z0 + w), ground, as_tris=True)

    light = b.diffuse_light(b.constant((7.0, 7.0, 7.0)))
    lid = b.xz_rect(123, 423, 147, 412, 554, light, flip=True)    # :498

    b.sphere((400, 400, 200), 50.0,
             b.lambertian(b.constant((0.7, 0.3, 0.1))),
             center1=(430, 400, 200), t0=0.0, t1=1.0)             # :500
    b.sphere((260, 150, 45), 50.0, b.dielectric(1.5))             # :501
    b.sphere((0, 150, 145), 50.0, b.metal((0.8, 0.8, 0.9), 1.0))  # :502
    b.sphere((360, 150, 145), 70.0, b.dielectric(1.5))            # :503
    b.medium_sphere((360, 150, 145), 70.0, 0.2,
                    b.constant((0.2, 0.4, 0.9)))                  # :505
    b.medium_sphere((0, 0, 0), 5000.0, 0.0001,
                    b.constant((1.0, 1.0, 1.0)))                  # :506-507

    if find_asset("textures/earthmap.jpg") is None:
        info.setdefault("skipped", []).append("textures/earthmap.jpg")
    earth = b.image(_maybe_downsample(
        load_image_asset("textures/earthmap.jpg", (0.2, 0.4, 0.8)), max_tex))
    b.sphere((400, 200, 400), 100.0, b.lambertian(earth))         # :511
    b.sphere((220, 280, 300), 80.0, b.lambertian(b.noise(0.1)))   # :512-513

    rot = rotation_y(15.0)                                        # :514-518
    centers = rng.random((n_cluster, 3)).astype(np.float32) * 165.0
    centers = centers @ rot.T + np.array([-100, 270, 395], np.float32)
    for c in centers:
        b.sphere(c, 10.0, white)
    b.light_rect(lid)

    cam = Camera.look_at((478, 278, -600), (278, 278, 0), vfov=40.0,
                         aspect=aspect, aperture=0.0, focus_dist=10.0)
    info["lights"] = 1
    return b.build(), cam, info


@_register
def final1(aspect: float = 1.0, seed: int = 1, n_cluster: int = 1000,
           **_kw):
    """Dead reference fixture ``final1`` (``Raytracing_n.cpp:693-711``): a
    strict subset of :func:`final` — the TNW area light plus the rotated
    1000-sphere cube, nothing else. The source builds no camera for it
    (unreachable from ``main``); we reuse ``final``'s camera. Sphere
    positions are drand48-random in the reference; pinned numpy seed here
    (same distribution, stable fixture — same policy as ``final``). The
    source also builds its light *unflipped* (upward-emitting, ``:702``)
    — black from any camera below it; we flip it as ``final`` does
    (``:498``) so the fixture actually renders."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    info: dict = {}

    white = b.lambertian(b.constant((0.73, 0.73, 0.73)))
    light = b.diffuse_light(b.constant((7.0, 7.0, 7.0)))
    lid = b.xz_rect(123, 423, 147, 412, 554, light, flip=True)    # :702

    rot = rotation_y(15.0)                                        # :704-709
    centers = rng.random((n_cluster, 3)).astype(np.float32) * 165.0
    centers = centers @ rot.T + np.array([-100, 270, 395], np.float32)
    for c in centers:
        b.sphere(c, 10.0, white)
    b.light_rect(lid)

    cam = Camera.look_at((478, 278, -600), (278, 278, 0), vfov=40.0,
                         aspect=aspect, aperture=0.0, focus_dist=10.0)
    info["lights"] = 1
    return b.build(), cam, info


@_register
def jadebunny_scene(aspect: float = 1.0, max_tex: int | None = None, **_kw):
    """Reference scene 4 (``Raytracing_n.cpp:535-583``): glass bunny shell
    over a slightly smaller Oren–Nayar blue bunny."""
    from srt.io.mesh import load_mesh

    lookfrom = (300.0, 500.0, -800.0)
    b = SceneBuilder()
    info: dict = {}

    light = b.diffuse_light(b.constant((45.0, 45.0, 45.0)))
    glass = b.dielectric(1.2)
    on_white_0 = b.oren_nayar(b.constant((0.7, 0.7, 0.7)), 0.0)
    on_blue = b.oren_nayar(b.constant((0.2, 0.4, 0.9)), 0.0)

    lid = b.xz_rect(203, 353, 17, 543, 800, light, flip=True)     # :555
    b.xz_rect(0, 555, 0, 555, 0, on_white_0)                      # :556
    _env_dome(b, lookfrom, "environment_map/sky_2.png", info, max_tex)

    ply = find_asset("models/bunny.ply")
    if ply is None:
        info.setdefault("skipped", []).append("models/bunny.ply")
    else:
        bunny = load_mesh(ply)
        b.trimesh(bunny, glass, scale=2000.0, rotate=rotation_y(180.0),
                  translate=(250, -70, 400))                      # :563-565
        b.trimesh(bunny, on_blue, scale=1990.0, rotate=rotation_y(180.0),
                  translate=(250, -70, 400), flip_winding=True)   # :568-570
    b.light_rect(lid)

    cam = Camera.look_at(lookfrom, (300, 278, 200), vfov=40.0,
                         aspect=aspect, aperture=0.0, focus_dist=10.0)
    info["lights"] = 1
    return b.build(), cam, info


@_register
def soldier_scene(aspect: float = 1.0, max_tex: int | None = None,
                  first_mesh_only: bool = False,
                  floor_variant: str = "ref", no_soldier: bool = False,
                  **_kw):
    """Reference scene 6 (``Raytracing_n.cpp:585-657``): FBX soldier over a
    glass-coated wood floor, sky4 dome, thin-lens bokeh (aperture 10).

    ``floor_variant`` / ``no_soldier`` are golden-debugging knobs
    (tools/regions.py): "ref" = wood box + glass coat box as the reference
    builds them; "nocoat" drops the glass box; "lambert" swaps the wood's
    Oren-Nayar for Lambertian; "rect" uses a single xz_rect floor.
    """
    from srt.io.mesh import load_mesh

    lookfrom = (300.0, 500.0, -800.0)
    b = SceneBuilder()
    info: dict = {}

    light1 = b.diffuse_light(b.constant((35.0, 35.0, 35.0)))
    lid = b.xz_rect(203, 353, 17, 167, 800, light1, flip=True)    # :623

    if find_asset("textures/TexturesCom_Wood_Wenge_1K_albedo.png") is None:
        info.setdefault("skipped", []).append("wood albedo")
    wood = b.image(_maybe_downsample(load_image_asset(
        "textures/TexturesCom_Wood_Wenge_1K_albedo.png", (0.3, 0.2, 0.1)),
        max_tex))
    if floor_variant == "lambert":
        floor_mat = b.lambertian(wood)
    else:
        floor_mat = b.oren_nayar(wood, 0.5)                       # :619
    if floor_variant == "rect":
        b.xz_rect(0, 600, 0, 600, 0.1, floor_mat)
    else:
        b.box((0, -0.1, 0), (600, 0.1, 600), floor_mat)           # :626
    if floor_variant not in ("nocoat", "rect"):
        b.box((0, -1, 0), (600, 1, 600), b.dielectric(1.4))       # :628

    _env_dome(b, lookfrom, "environment_map/sky4.jpg", info, max_tex)

    fbx = find_asset("models/Soilder.FBX")
    if no_soldier:
        fbx = None
    elif fbx is None:
        info.setdefault("skipped", []).append("models/Soilder.FBX")
    if fbx is not None:
        if find_asset("textures/NPC_YuanChengBing_A.png") is None:
            info.setdefault("skipped", []).append("soldier texture")
        skin = b.image(_maybe_downsample(load_image_asset(
            "textures/NPC_YuanChengBing_A.png", (0.5, 0.4, 0.3)), max_tex))
        beck_tex = b.beckmann(skin, 0.9, 0.85)                    # :604,638
        b.trimesh(load_mesh(fbx, first_mesh_only=first_mesh_only),
                  beck_tex, scale=8.0,
                  rotate=rotation_y(180.0), translate=(250, 0, 300),
                  flip_winding=True)                              # :640-642
    b.light_rect(lid)

    cam = Camera.look_at(lookfrom, (300, 278, 200), vfov=40.0,
                         aspect=aspect, aperture=10.0,
                         focus_dist=1000.0)                       # :589-592
    info["lights"] = 1
    return b.build(), cam, info


@_register
def flatnormal_bunny(aspect: float = 1.0, max_tex: int | None = None, **_kw):
    """Reference scene 7 (``Raytracing_n.cpp:659-691``).

    Deviations from reference *bugs*, intended behavior kept: the source
    builds the gold bunny but never appends it to the list (``:683-686``)
    and never assigns ``*hlist``; we add the bunny (the scene's entire
    point is its flat-normal shading) and register the light rect.
    """
    from srt.io.mesh import load_mesh

    lookfrom = (300.0, 500.0, -800.0)
    b = SceneBuilder()
    info: dict = {}

    light = b.diffuse_light(b.constant((45.0, 45.0, 45.0)))
    on_white = b.oren_nayar(b.constant((0.7, 0.7, 0.7)), 0.1)
    beck_gold = b.beckmann(b.constant((0.945, 0.75, 0.336)), 0.85, 0.85)

    lid = b.xz_rect(203, 353, 17, 167, 800, light, flip=True)     # :675
    b.xz_rect(0, 600, 0, 600, 0, on_white)                        # :676
    _env_dome(b, lookfrom, "environment_map/sky_2.png", info, max_tex)

    ply = find_asset("models/bunny.ply")
    if ply is None:
        info.setdefault("skipped", []).append("models/bunny.ply")
    else:
        b.trimesh(load_mesh(ply), beck_gold, scale=2000.0,
                  rotate=rotation_y(180.0), translate=(250, -70, 400))
    b.light_rect(lid)

    cam = Camera.look_at(lookfrom, (300, 278, 200), vfov=40.0,
                         aspect=aspect, aperture=0.0, focus_dist=10.0)
    info["lights"] = 1
    return b.build(), cam, info


@_register
def fog_scene(aspect: float = 1.0, **_kw):
    """BASELINE config-5 inverse-rendering scene: an area light and a rough
    Beckmann sphere on an Oren-Nayar floor, inside constant-medium fog
    (``constant_medium.h:19-50`` free flight). Material 1 is the Beckmann
    ball; texture 1 its albedo, texture 2 the light's emission."""
    b = SceneBuilder()
    floor = b.oren_nayar(b.constant((0.6, 0.5, 0.4)), 5.0)
    ball = b.beckmann(b.constant((0.2, 0.4, 0.8)), 0.4, 0.4)
    light = b.diffuse_light(b.constant((14.0, 14.0, 14.0)))
    b.xz_rect(-6, 6, -6, 6, 0, floor)
    b.sphere((0.0, 1.0, 0.0), 1.0, ball)
    lid = b.xz_rect(-1.5, 1.5, -1.5, 1.5, 5.0, light, flip=True)
    b.medium_sphere((0.0, 1.5, 0.0), 4.0, 0.12, b.constant((0.9, 0.9, 0.9)))
    b.light_rect(lid)
    cam = Camera.look_at(lookfrom=(0, 2.2, -7), lookat=(0, 1, 0), vfov=40.0,
                         aspect=aspect)
    return b.build(), cam, {"lights": 1}
