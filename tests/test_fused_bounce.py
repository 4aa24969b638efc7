"""Fused-bounce kernel (pallas/bounce.py) vs the XLA bounce oracle.

Interpret mode gives the Triton-route kernel's semantics on the CPU mesh
(same scheme as tests/test_pallas.py). The kernel is estimator-identical
by construction (same RNG dimension slots, same math), so whole-image
agreement at tight tolerance is the contract — not a statistical test.
"""
from __future__ import annotations

import numpy as np

from srt import RenderConfig
from srt.render.regen import render_regen
from srt.scene.build import SceneBuilder
from srt.scene.ir import SceneFlags
from srt.render.camera import Camera


def _render_both(scene, cam, **kw):
    cfg = RenderConfig(width=kw.pop("width", 48), height=kw.pop("height", 48),
                       spp=kw.pop("spp", 4), max_depth=kw.pop("max_depth", 6),
                       wavefront=kw.pop("wavefront", 4096), **kw)
    img_k = np.asarray(render_regen(scene, cam, cfg, pallas_mode="interpret"))
    img_x = np.asarray(render_regen(scene, cam, cfg, pallas_mode="off"))
    return img_k, img_x


def test_flags_gate_ball_scenes():
    from srt.scene.library import ball_scenes
    scene, _, _ = ball_scenes(aspect=1.0)
    flags = SceneFlags.of(scene)
    assert flags.fused_bounce
    assert flags.light_kinds == (0,)
    assert not flags.moving


def test_flags_gate_extended_coverage():
    # triangles (external-hit feed), analytic media, isotropic and
    # deferred NOISE/IMAGE albedo are in scope since round 4
    from srt.scene.library import (cornell_boxes, final, simple_light,
                                       two_perlin_spheres)
    assert SceneFlags.of(cornell_boxes(aspect=1.0)[0]).fused_bounce
    f = SceneFlags.of(final(aspect=1.0)[0])
    assert f.fused_bounce and f.fused_deferred_albedo
    assert SceneFlags.of(simple_light(aspect=1.0)[0]).fused_bounce
    # env (always-hit) ambient domes are in-kernel since round 5
    assert SceneFlags.of(two_perlin_spheres(aspect=1.0)[0]).fused_bounce


def test_many_sphere_scene():
    """No sphere cap: a 2048-sphere scene stays on the kernel path (its
    sphere table lives in global memory) and the image matches XLA."""
    rng = np.random.default_rng(3)
    b = SceneBuilder()
    white = b.lambertian(b.constant((0.73, 0.73, 0.73)))
    light = b.diffuse_light(b.constant((7.0, 7.0, 7.0)))
    lid = b.xz_rect(123, 423, 147, 412, 554, light, flip=True)
    for c in (rng.random((2048, 3)).astype(np.float32) * 330.0
              + np.array([-100, 100, 300], np.float32)):
        b.sphere(c, 8.0, white)
    b.light_rect(lid)
    scene = b.build()
    assert SceneFlags.of(scene).fused_bounce
    from srt.render.camera import Camera
    cam = Camera.look_at((478, 278, -600), (278, 278, 0), vfov=40.0,
                         aspect=1.0)
    img_k, img_x = _render_both(scene, cam, width=16, height=16, spp=2,
                                max_depth=3)
    assert np.isfinite(img_k).all()
    same = np.isclose(img_k, img_x, rtol=1e-4, atol=1e-5).mean()
    assert same > 0.95, same


def test_env_sphere_scene_matches_xla():
    """Env (always-hit) dome in-kernel: far-crossing hit with the inward
    normal (env_sphere.h:27-38) — image equivalence vs the XLA bounce,
    including a lane that *starts* on the dome's emitter path."""
    from srt.scene.library import two_perlin_spheres
    scene, cam, _ = two_perlin_spheres(aspect=1.0)
    assert SceneFlags.of(scene).fused_bounce
    img_k, img_x = _render_both(scene, cam, width=32, height=32, spp=4,
                                max_depth=4)
    assert np.isfinite(img_k).all()
    # chaotic-divergence contract (see test_ball_scenes_image_statistics):
    # means agree, most pixels bitwise-equal (ulp-level knife-edge flips
    # on a few percent of pixels, hence 0.9 rather than the per-bounce
    # bound)
    assert abs(img_k.mean() - img_x.mean()) < 0.02 * max(img_x.mean(), 1e-6)
    same = np.isclose(img_k, img_x, rtol=1e-4, atol=1e-5).mean()
    assert same > 0.90, same


def test_ball_scenes_bounce_equivalence():
    """Per-bounce state equivalence on the Beckmann headline scene.

    Whole-image bitwise comparison across *different XLA compilations* is
    not a meaningful contract for a chaotic-path estimator: any two float
    programs of the same math (even scan vs regen, or the same engine at
    two batch shapes) flip knife-edge branches (the VNDF
    ``cosThetaI > 0.9999`` split) on a ~0.1% sliver of lanes, and a
    flipped branch resamples that whole path. The strong deterministic
    contract is per-bounce: on identical input states, the kernel and the
    XLA ``bounce_step`` must agree lane-for-lane except that sliver.
    """
    import jax.numpy as jnp

    from srt.core.rng import RaySampler
    from srt.pallas.bounce import fused_bounce
    from srt.render.integrator import bounce_step

    from srt.scene.library import ball_scenes
    scene, cam, _ = ball_scenes(aspect=1.0)
    flags = SceneFlags.of(scene)
    n = 4096
    pix = jnp.arange(n, dtype=jnp.int32)
    samp = jnp.zeros(n, jnp.int32)
    s = (pix % 64).astype(jnp.float32) / 64.0
    t = (pix // 64 % 64).astype(jnp.float32) / 64.0
    sampler = RaySampler.create(0, pix, samp)
    rays = cam.rays(s, t, sampler.uniform(32), sampler.uniform(33),
                    sampler.uniform(34))
    state = dict(o=rays.origin, d=rays.direction, time=rays.time,
                 beta=jnp.ones((n, 3)), radiance=jnp.zeros((n, 3)),
                 alive=jnp.ones(n, bool), salt=sampler.salt,
                 depth=jnp.zeros(n, jnp.int32))
    import functools
    import jax

    # jit both sides: eager CPU dispatch and jitted graphs fuse fma
    # differently, which alone flips knife-edge VNDF branches.
    step_xla = jax.jit(functools.partial(
        bounce_step, max_depth=8, rr_start=1 << 30, flags=flags))
    step_krn = jax.jit(functools.partial(
        fused_bounce, max_depth=8, rr_start=1 << 30, flags=flags,
        mode="interpret"))
    for step in range(3):
        a = step_xla(scene, state)
        b = step_krn(scene, state)
        live = np.asarray(a["alive"])
        alive_mismatch = (np.asarray(a["alive"])
                          != np.asarray(b["alive"])).mean()
        # Tolerances: on the CPU CI backend the two jitted graphs fuse
        # fma differently and grazing-angle VNDF lanes retain ~1e-3
        # jitter on a few % of lanes (the card's bounds are in
        # chip_smoke.py). A real formula bug shows up as order-1 errors
        # on most lanes — far outside these bounds.
        assert alive_mismatch <= 2e-3, (step, alive_mismatch)
        for key, tol, frac in (("d", 1e-4, 0.05), ("beta", 1e-3, 0.05),
                               ("radiance", 1e-3, 0.01)):
            da = np.abs(np.asarray(a[key]) - np.asarray(b[key])).max(-1)
            if key != "radiance":   # dead-lane values are don't-care
                da = np.where(live, da, 0.0)
            frac_bad = (da > tol).mean()
            assert frac_bad <= frac, (step, key, frac_bad, da.max())
            assert np.median(da) <= 1e-5, (step, key)
        state = a   # advance along the XLA trajectory


def test_ball_scenes_image_statistics():
    """Whole-image agreement is statistical (see the equivalence test's
    docstring): means match closely, the typical pixel matches bitwise,
    and only the knife-edge resampled sliver differs."""
    from srt.scene.library import ball_scenes
    scene, cam, _ = ball_scenes(aspect=1.0)
    img_k, img_x = _render_both(scene, cam)
    assert np.isfinite(img_k).all()
    diff = np.abs(img_k - img_x).max(axis=-1)
    assert abs(img_k.mean() - img_x.mean()) < 3e-3
    assert np.median(diff) < 1e-6
    assert (diff > 1e-2).mean() < 0.15


def test_sphere_light_and_image_emitter():
    # earth_sphere: IMAGE-textured emissive sphere registered as an NEE
    # sphere light -> exercises deferred emission + cone sampling.
    from srt.scene.library import earth_sphere
    scene, cam, _ = earth_sphere(aspect=1.0)
    assert SceneFlags.of(scene).fused_bounce
    img_k, img_x = _render_both(scene, cam)
    assert np.isfinite(img_k).all()
    diff = np.abs(img_k - img_x).max(axis=-1)
    # sub-0.5% of pixels may flip an emitter texel via t-ulp differences
    assert np.median(diff) < 1e-6
    assert (diff > 1e-3).mean() < 5e-3
    assert abs(img_k.mean() - img_x.mean()) < 1e-3


def test_specular_and_moving_spheres():
    # metal + dielectric + a moving lambertian sphere + checker ground.
    b = SceneBuilder()
    checker = b.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.sphere((0, -1000, 0), 1000.0, b.lambertian(checker))
    b.sphere((0, 1, 0), 1.0, b.dielectric(1.5))
    b.sphere((-3, 1, 0), 1.0, b.metal((0.8, 0.6, 0.2), 0.3))
    b.sphere((3, 1, 0), 1.0, b.lambertian(b.constant((0.5, 0.2, 0.2))),
             center1=(3, 1.4, 0))
    rid = b.xz_rect(2.0, 4.0, -1.0, 1.0, 6.0, b.diffuse_light(
        b.constant((7.0, 7.0, 7.0))), flip=True)
    b.light_rect(rid)
    scene = b.build()
    flags = SceneFlags.of(scene)
    assert flags.fused_bounce and flags.moving
    cam = Camera.look_at((13, 2, 3), (0, 0, 0), vfov=25.0, aspect=1.0,
                         time0=0.0, time1=1.0)
    img_k, img_x = _render_both(scene, cam)
    assert np.isfinite(img_k).all()
    diff = np.abs(img_k - img_x).max(axis=-1)
    assert np.median(diff) < 1e-6
    assert (diff > 1e-3).mean() < 5e-3
    assert abs(img_k.mean() - img_x.mean()) < 1e-3


def test_russian_roulette_path():
    # Beckmann scene -> statistical tolerance (see equivalence test).
    from srt.scene.library import ball_scenes
    scene, cam, _ = ball_scenes(aspect=1.0)
    img_k, img_x = _render_both(scene, cam, max_depth=8, rr_start=3,
                                width=32, height=32)
    diff = np.abs(img_k - img_x).max(axis=-1)
    assert abs(img_k.mean() - img_x.mean()) < 5e-3
    assert np.median(diff) < 1e-6
    assert (diff > 1e-2).mean() < 0.2


def test_final_scene_matches_xla():
    """`final` exercises every round-4 extension at once: external
    triangle hits, two analytic media, isotropic, metal/dielectric,
    moving spheres, and deferred NOISE + IMAGE albedo."""
    from srt.scene.library import final
    scene, cam, _ = final(aspect=1.0)
    img_k, img_x = _render_both(scene, cam, width=40, height=40, spp=2,
                                max_depth=5)
    assert np.isfinite(img_k).all()
    diff = np.abs(img_k - img_x).max(axis=-1)
    assert np.median(diff) < 1e-5
    assert abs(img_k.mean() - img_x.mean()) < 5e-3
    assert (diff > 1e-2).mean() < 0.2


def test_simple_light_marble_matches_xla():
    # deferred Perlin-marble albedo (NOISE) path
    from srt.scene.library import simple_light
    scene, cam, _ = simple_light(aspect=1.0)
    img_k, img_x = _render_both(scene, cam)
    diff = np.abs(img_k - img_x).max(axis=-1)
    assert np.median(diff) < 1e-6
    assert (diff > 1e-3).mean() < 5e-3
    assert abs(img_k.mean() - img_x.mean()) < 1e-3


def test_parity_mode_bounce_equivalence():
    """ref_parity in-kernel (round 5): the stale heap-slot carry, the
    light-only diffuse draw, the bounded retry rounds and the
    as-implemented Beckmann/O-N formulas must match the XLA parity bounce
    per-bounce on identical inputs (same contract and tolerances as
    test_ball_scenes_bounce_equivalence)."""
    import functools

    import jax
    import jax.numpy as jnp

    from srt.core.rng import RaySampler
    from srt.pallas.bounce import fused_bounce
    from srt.render.integrator import bounce_step
    from srt.scene.library import ball_scenes

    scene, cam, _ = ball_scenes(aspect=1.0)
    flags = SceneFlags.of(scene)._replace(ref_parity=True)
    from srt.pallas.bounce import fused_bounce_available
    assert fused_bounce_available(flags, "interpret")
    assert not fused_bounce_available(flags, "off")
    n = 4096
    pix = jnp.arange(n, dtype=jnp.int32)
    samp = jnp.zeros(n, jnp.int32)
    s = (pix % 64).astype(jnp.float32) / 64.0
    t = (pix // 64 % 64).astype(jnp.float32) / 64.0
    sampler = RaySampler.create(0, pix, samp)
    rays = cam.rays(s, t, sampler.uniform(32), sampler.uniform(33),
                    sampler.uniform(34))
    state = dict(o=rays.origin, d=rays.direction, time=rays.time,
                 beta=jnp.ones((n, 3)), radiance=jnp.zeros((n, 3)),
                 alive=jnp.ones(n, bool), salt=sampler.salt,
                 depth=jnp.zeros(n, jnp.int32),
                 stale=jnp.zeros((n,), jnp.float32))

    step_xla = jax.jit(functools.partial(
        bounce_step, max_depth=8, rr_start=1 << 30, flags=flags))
    step_krn = jax.jit(functools.partial(
        fused_bounce, max_depth=8, rr_start=1 << 30, flags=flags,
        mode="interpret"))
    for step in range(3):
        a = step_xla(scene, state)
        b = step_krn(scene, state)
        live = np.asarray(a["alive"])
        alive_mismatch = (np.asarray(a["alive"])
                          != np.asarray(b["alive"])).mean()
        assert alive_mismatch <= 2e-3, (step, alive_mismatch)
        for key, tol, frac in (("d", 1e-4, 0.05), ("beta", 1e-3, 0.05),
                               ("radiance", 1e-3, 0.01),
                               ("stale", 1e-3, 0.05)):
            da = np.abs(np.asarray(a[key]) - np.asarray(b[key]))
            if da.ndim == 2:
                da = da.max(-1)
            if key != "radiance":   # dead-lane values are don't-care
                da = np.where(live, da, 0.0)
            frac_bad = (da > tol).mean()
            assert frac_bad <= frac, (step, key, frac_bad, da.max())
            assert np.median(da) <= 1e-5, (step, key)
        state = a


def test_parity_mode_image_matches_xla():
    """End-to-end ref_parity render through the kernel engine vs the XLA
    bounce — image statistics contract."""
    from srt.scene.library import ball_scenes
    scene, cam, _ = ball_scenes(aspect=1.0)
    img_k, img_x = _render_both(scene, cam, width=32, height=32, spp=4,
                                max_depth=5, ref_parity=True)
    assert np.isfinite(img_k).all()
    assert abs(img_k.mean() - img_x.mean()) < 0.03 * max(img_x.mean(), 1e-6)
    same = np.isclose(img_k, img_x, rtol=1e-4, atol=1e-5).mean()
    # parity's stale carry couples bounces across the whole lane history
    # (a 1-ulp pdf difference persists in the slot and flips a later
    # light-branch weight), so the bitwise-close fraction is lower than
    # the non-parity engines' — the deterministic contract is the
    # per-bounce test above; here means must agree and most pixels match
    assert same > 0.80, same
