"""Traversal kernel vs the XLA reference path (interpret mode), and the
static kernel choice, launch wrapper and compile-cache placement.

On CPU the Triton-route kernels run through the Pallas interpreter — same
program, same semantics, no GPU required (the SURVEY §4 fake-backend
strategy applied to kernels). ``chip_smoke.py`` compiles them for the card
and compares them there at real widths; the lowering to Triton IR is
checked here too, since it needs no card.
"""
import numpy as np
import pytest

from srt.core.ray import Ray
from srt.io.mesh import TriMesh
from srt.render.intersect import (intersect_tris,
                                  intersect_tris_via_kernel)
from srt.scene.build import SceneBuilder


def _soup_scene(t=300, seed=0):
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    mat = b.lambertian(b.constant((0.5, 0.5, 0.5)))
    tris = rng.standard_normal((t, 3, 3)).astype(np.float32)
    b.trimesh(TriMesh(positions=tris, uvs=None, normals=None), mat)
    return b.build(), rng


def _rays(rng, n):
    o = rng.standard_normal((n, 3)).astype(np.float32) * 3
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return Ray(origin=o, direction=d, time=np.zeros(n, np.float32))


def _assert_hits_match(hx, hp):
    a, b = np.asarray(hx.hit), np.asarray(hp.hit)
    np.testing.assert_array_equal(a, b)
    both = a & b
    np.testing.assert_allclose(np.asarray(hx.t)[both],
                               np.asarray(hp.t)[both], rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(np.asarray(hx.mat)[both],
                                  np.asarray(hp.mat)[both])
    # Barycentric uv agreement where hit.
    np.testing.assert_allclose(np.asarray(hx.uv)[both],
                               np.asarray(hp.uv)[both], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_tris,n_rays", [(37, 257), (300, 2000)])
def test_pallas_matches_xla_traversal(n_tris, n_rays):
    scene, rng = _soup_scene(n_tris)
    ray = _rays(rng, n_rays)
    hx = intersect_tris(scene, ray, 1e-3, 3e38)
    hp = intersect_tris_via_kernel(scene, ray, 1e-3, "interpret")
    _assert_hits_match(hx, hp)


def test_traversal_kernel_large_mesh():
    """A mesh above the old 6 MB on-chip scene budget (nodes + vertices):
    the per-ray kernel reads global memory, so one level covers it."""
    from srt.render.camera import Camera
    from srt.scene.teapot import create_teapot

    b = SceneBuilder()
    mat = b.lambertian(b.constant((0.5, 0.5, 0.5)))
    b.trimesh(create_teapot(scale=1.0, divs=44), mat)
    scene = b.build()
    assert (scene.n_bvh_nodes + scene.n_tris) * 36 > 6 * 1024 * 1024
    cam = Camera.look_at((3.0, 4.0, -6.0), (0.0, 0.0, 1.0), vfov=40.0,
                         aspect=1.0)
    n = 16
    s, t = np.meshgrid((np.arange(n) + 0.5) / n, (np.arange(n) + 0.5) / n)
    z = np.zeros(n * n, np.float32)
    ray = cam.rays(s.ravel().astype(np.float32), t.ravel().astype(np.float32),
                   z, z, z)
    hx = intersect_tris(scene, ray, 1e-3, 3e38)
    hp = intersect_tris_via_kernel(scene, ray, 1e-3, "interpret")
    assert np.asarray(hx.hit).mean() > 0.2      # the rays see the mesh
    _assert_hits_match(hx, hp)


@pytest.mark.parametrize("n_rays", [1, 127, 129, 1000])
def test_traversal_wrapper_padding(n_rays):
    """Ray counts off the 128-lane block: padded lanes are cut off and the
    real lanes' winners are the reference's."""
    from srt.pallas.common import BLOCK
    from srt.pallas.intersect import intersect_tris_kernel
    from srt.render.intersect import tris_winner

    scene, rng = _soup_scene(64, seed=n_rays)
    ray = _rays(rng, n_rays)
    t, u, v, idx = intersect_tris_kernel(scene, ray, 1e-3, "interpret")
    assert t.shape == u.shape == v.shape == idx.shape == (n_rays,)
    assert BLOCK == 128
    tx, _, _, ix = tris_winner(scene, ray, 1e-3)
    hit = np.asarray(tx) < 3e38
    np.testing.assert_array_equal(hit, np.asarray(t) < 3e38)
    np.testing.assert_array_equal(np.asarray(ix)[hit], np.asarray(idx)[hit])


def test_pallas_full_render_matches():
    """End-to-end render with the kernels on (traversal + fused bounce)."""
    from srt import RenderConfig, render
    from srt.scene.library import cornell_boxes

    scene, cam, _ = cornell_boxes(aspect=1.0)
    cfg = RenderConfig(width=12, height=12, spp=2, max_depth=3)
    ref = np.asarray(render(scene, cam, cfg, pallas_mode="off"))
    img = np.asarray(render(scene, cam, cfg, pallas_mode="interpret"))
    # Traversal order identical; only fma/reassociation noise differs.
    np.testing.assert_allclose(ref, img, rtol=1e-4, atol=1e-4)


def test_pallas_gating():
    from srt.pallas.intersect import traversal_available

    scene, _ = _soup_scene(10)
    assert traversal_available(scene, "interpret")
    assert traversal_available(scene, "gpu")
    assert not traversal_available(scene, "off")
    # a triangle-free scene never launches the traversal kernel
    b = SceneBuilder()
    b.sphere((0, 0, 0), 1.0, b.lambertian(b.constant((0.5, 0.5, 0.5))))
    assert not traversal_available(b.build(), "interpret")


@pytest.mark.parametrize("backend,requested,expected", [
    ("cpu", "auto", "off"),
    ("gpu", "auto", "gpu"),
    ("cpu", "interpret", "interpret"),
    ("cpu", "off", "off"),
    ("gpu", "off", "off"),
])
def test_kernel_mode_static_choice(monkeypatch, backend, requested,
                                   expected):
    import srt.pallas.common as common
    monkeypatch.setattr(common.jax, "default_backend", lambda: backend)
    monkeypatch.setenv("SRT_PALLAS", requested)
    assert common.kernel_mode() == expected
    assert common.kernel_mode(requested) == expected


def test_kernel_mode_refuses_interpret_off_cpu(monkeypatch):
    import srt.pallas.common as common
    monkeypatch.setattr(common.jax, "default_backend", lambda: "gpu")
    with pytest.raises(ValueError, match="interpret"):
        common.kernel_mode("interpret")
    with pytest.raises(ValueError, match="expected auto"):
        common.kernel_mode("bogus")


def test_off_mode_selects_xla():
    """``off`` keeps every kernel out: the gates say no and the launcher
    refuses, so an off-mode trace holds no pallas_call."""
    import jax

    from srt.pallas.bounce import fused_bounce_available
    from srt.pallas.common import lane_call
    from srt.render.intersect import intersect_scene
    from srt.scene.ir import SceneFlags

    scene, rng = _soup_scene(20)
    flags = SceneFlags.of(scene)
    assert fused_bounce_available(flags, "interpret")
    assert not fused_bounce_available(flags, "off")
    with pytest.raises(ValueError, match="off"):
        lane_call(None, [], [np.zeros(128, np.float32)], [np.float32],
                  mode="off", name="x")
    ray = _rays(rng, 64)
    off = jax.make_jaxpr(lambda r: intersect_scene(scene, r, flags=flags,
                                                   pallas_mode="off").t)(ray)
    on = jax.make_jaxpr(lambda r: intersect_scene(
        scene, r, flags=flags, pallas_mode="interpret").t)(ray)
    assert "pallas_call" not in str(off)
    assert "pallas_call" in str(on)


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_placement(monkeypatch, tmp_path, env_dir):
    """``cache.enable`` honours ``JAX_COMPILATION_CACHE_DIR`` and otherwise
    uses ``<repo>/.jax_cache``; it is the one place that sets it."""
    import os

    import jax

    from srt.utils import cache

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("SRT_NO_COMPILE_CACHE", raising=False)
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(repo, ".jax_cache")
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    try:
        assert cache.cache_dir() == want
        assert cache.enable() == want
        assert jax.config.jax_compilation_cache_dir == want
        monkeypatch.setenv("SRT_NO_COMPILE_CACHE", "1")
        assert cache.enable() is None
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("kernel", ["bounce", "traversal"])
def test_kernels_lower_to_triton(kernel):
    """Each kernel lowers for CUDA through the Triton route (no card
    needed): unsupported primitives or block shapes fail here."""
    import functools

    import jax
    import jax.numpy as jnp

    from srt.scene.ir import SceneFlags

    if kernel == "traversal":
        from srt.pallas.intersect import intersect_tris_kernel
        scene, rng = _soup_scene(50)
        ray = _rays(rng, 256)
        fn = jax.jit(lambda s, r: intersect_tris_kernel(s, r, 1e-3, "gpu"))
        args = (scene, ray)
    else:
        from srt.core.rng import RaySampler
        from srt.pallas.bounce import fused_bounce
        from srt.scene.library import fog_scene
        scene, cam, _ = fog_scene()
        flags = SceneFlags.of(scene)
        n = 256
        pix = jnp.arange(n, dtype=jnp.int32)
        sampler = RaySampler.create(0, pix, jnp.zeros(n, jnp.int32))
        st = (pix.astype(jnp.float32) + 0.5) / n
        rays = cam.rays(st, st, sampler.uniform(32), sampler.uniform(33),
                        sampler.uniform(34))
        state = dict(o=rays.origin, d=rays.direction, time=rays.time,
                     beta=jnp.ones((n, 3)), radiance=jnp.zeros((n, 3)),
                     alive=jnp.ones(n, bool), salt=sampler.salt,
                     depth=jnp.zeros(n, jnp.int32))
        fn = jax.jit(functools.partial(
            fused_bounce, max_depth=8, rr_start=1 << 30, flags=flags,
            mode="gpu"))
        args = (scene, state)
    text = fn.trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text
