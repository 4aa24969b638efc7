"""Distributed semantics on the virtual 8-device CPU mesh (SURVEY §4):
1-device and 8-device renders must be bit-identical, and the shard_map
training step must agree with the single-device one."""
import numpy as np
import jax.numpy as jnp

from srt import render, RenderConfig
from srt.dist import make_mesh, render_sharded
from srt.render.camera import Camera
from srt.scene.build import SceneBuilder


def _scene():
    b = SceneBuilder()
    white = b.lambertian(b.constant((0.73, 0.73, 0.73)))
    red = b.lambertian(b.constant((0.65, 0.05, 0.05)))
    light = b.diffuse_light(b.constant((10.0, 10.0, 10.0)))
    b.xz_rect(0, 10, 0, 10, 0, white)
    b.sphere((5, 1, 5), 1.0, red)
    lid = b.xz_rect(3, 7, 3, 7, 8, light, flip=True)
    b.light_rect(lid)
    cam = Camera.look_at(lookfrom=(5, 3, -8), lookat=(5, 1, 5), vfov=40.0,
                         aspect=1.0)
    return b.build(), cam


def test_sharded_render_bit_identical(eight_devices):
    scene, cam = _scene()
    cfg = RenderConfig(width=16, height=16, spp=8, max_depth=4)
    img1 = np.asarray(render_sharded(scene, cam, cfg, make_mesh(1)))
    img8 = np.asarray(render_sharded(scene, cam, cfg, make_mesh(8)))
    assert np.array_equal(img1, img8)


def test_sharded_matches_host_loop_render(eight_devices):
    scene, cam = _scene()
    cfg = RenderConfig(width=16, height=16, spp=8, max_depth=4)
    a = np.asarray(render(scene, cam, cfg))
    b = np.asarray(render_sharded(scene, cam, cfg, make_mesh(8)))
    assert np.allclose(a, b, atol=1e-6)


def test_train_step_sharded_matches_single(eight_devices):
    import optax
    from srt.diff import make_train_step, render_pixels

    scene, cam = _scene()
    w = h = 16
    target = render_pixels(scene, cam, jnp.arange(w * h, dtype=jnp.int32),
                           width=w, height=h, spp=4, max_depth=3, seed=123)

    params = {"tex_color": scene.tex_color}
    opt = optax.adam(1e-2)

    step1 = make_train_step(scene, cam, opt, width=w, height=h, spp=4,
                            max_depth=3, mesh=None)
    step8 = make_train_step(scene, cam, opt, width=w, height=h, spp=4,
                            max_depth=3, mesh=make_mesh(8))

    s1 = opt.init(params)
    s8 = opt.init(params)
    p1, _, l1 = step1(params, s1, target, 0)
    p8, _, l8 = step8(params, s8, target, 0)
    assert abs(float(l1) - float(l8)) < 1e-6
    for k in params:
        assert np.allclose(np.asarray(p1[k]), np.asarray(p8[k]), atol=1e-5)


def test_scaling_harness_smoke():
    """tools/scaling.py core loop: efficiency table + bit-exactness on a
    2-device sweep (BASELINE row 4's harness, CI-smoke-tested)."""
    import subprocess, sys, os, json
    env = {**os.environ,
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2"}
    out = subprocess.run(
        [sys.executable, "tools/scaling.py", "--width", "16", "--spp", "2",
         "--max-depth", "3", "--reps", "1", "--devices", "1", "2"],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-2000:]
    data = json.loads(out.stdout.strip().splitlines()[-1])
    assert data["devices"]["2"]["bit_exact_vs_1dev"] is True
    assert data["devices"]["1"]["efficiency_vs_linear"] == 1.0
