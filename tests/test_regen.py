"""Regeneration engine vs scan engine: same estimator, same images."""
import numpy as np

from srt import RenderConfig, render
from srt.render.regen import render_regen
from srt.scene.library import cornell_boxes


def test_regen_matches_scan():
    """Identical RNG streams => identical per-sample radiance; images may
    differ only by float accumulation order."""
    scene, cam, _ = cornell_boxes(aspect=1.0)
    cfg = RenderConfig(width=16, height=16, spp=4, max_depth=6)
    img_scan, m_scan = render(scene, cam, cfg, metrics=True)
    img_regen, m_regen = render_regen(scene, cam, cfg, metrics=True)
    a, b = np.asarray(img_scan), np.asarray(img_regen)
    # Exactly the same ray segments were traced...
    assert m_scan.path_vertices == m_regen.path_vertices
    # ...and the images agree to accumulation-order noise.
    np.testing.assert_allclose(a, b, atol=2e-5, rtol=1e-5)
    assert np.isfinite(b).all()


def test_regen_small_wavefront_queue_drain():
    """Wavefront far smaller than the work queue: every (pixel, sample)
    item must be issued exactly once (the cursor/cumsum regeneration)."""
    scene, cam, _ = cornell_boxes(aspect=1.0)
    cfg = RenderConfig(width=8, height=8, spp=4, max_depth=4)
    object.__setattr__(cfg, "wavefront", 37)  # frozen dataclass; test knob
    img, m = render_regen(scene, cam, cfg, metrics=True)
    ref = np.asarray(render(scene, cam, cfg))
    np.testing.assert_allclose(np.asarray(img), ref, atol=2e-5, rtol=1e-5)


def test_regen_metrics_histogram_consistency():
    scene, cam, _ = cornell_boxes(aspect=1.0)
    cfg = RenderConfig(width=8, height=8, spp=2, max_depth=5)
    _, m = render(scene, cam, cfg, metrics=True)
    assert m.primary_rays == 8 * 8 * 2
    assert m.alive_per_bounce is not None
    assert m.alive_per_bounce.shape == (5,)
    # Bounce 0 has every lane alive; counts are non-increasing.
    assert m.alive_per_bounce[0] == m.primary_rays
    assert all(np.diff(m.alive_per_bounce) <= 0)
    assert m.path_vertices == int(m.alive_per_bounce.sum())


def test_regen_scan_matches_trace():
    """The reverse-differentiable regen-scan engine computes the same
    per-sample radiance as the scan integrator (identical RNG streams),
    and its gradients flow (non-zero grad to albedo)."""
    import jax
    import jax.numpy as jnp

    from srt.core.rng import RaySampler
    from srt.render.integrator import trace
    from srt.render.regen_scan import steps_for, trace_queue
    from srt.scene.ir import SceneFlags

    from test_render import _cornell
    scene, cam = _cornell()
    n = 512
    rng = np.random.default_rng(0)
    pix = jnp.asarray(rng.integers(0, 64 * 64, n), jnp.int32)
    samp = jnp.zeros((n,), jnp.int32)
    sampler = RaySampler.create(0, pix, samp)
    s = ((pix % 64).astype(jnp.float32) + 0.5) / 64
    t = ((64 - 1 - pix // 64).astype(jnp.float32) + 0.5) / 64
    rays = cam.rays(s, t, sampler.uniform(32), sampler.uniform(33),
                    sampler.uniform(34))
    flags = SceneFlags.of(scene)

    ref = trace(scene, rays, sampler, max_depth=8, rr_start=1 << 30,
                flags=flags)

    steps = steps_for(n, 128, depth_budget=6.0, max_depth=8)
    out, started = trace_queue(scene, rays, sampler.salt, n_steps=steps,
                               wavefront=128, max_depth=8, flags=flags)
    assert float(jnp.min(started)) == 1.0, "budget must start every ray"
    np.testing.assert_allclose(np.asarray(ref), np.asarray(out),
                               rtol=1e-5, atol=1e-5)

    # Gradient flows to a scene parameter through the scan engine.
    def loss(tex_color):
        out2, _ = trace_queue(scene._replace(tex_color=tex_color), rays,
                              sampler.salt, n_steps=steps, wavefront=128,
                              max_depth=8, flags=flags)
        return jnp.mean(out2)
    g = jax.grad(loss)(scene.tex_color)
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.max(jnp.abs(g))) > 0.0
