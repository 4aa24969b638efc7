"""Gradient correctness (BASELINE 'grad-allclose'): jax.grad through the
wavefront estimator vs central finite differences, and a small inverse
optimization that recovers a perturbed albedo."""
import numpy as np
import jax
import jax.numpy as jnp

from srt.diff import image_loss, render_pixels
from srt.render.camera import Camera
from srt.scene.build import SceneBuilder


def _cornellette():
    b = SceneBuilder()
    red = b.lambertian(b.constant((0.65, 0.05, 0.05)))
    white = b.lambertian(b.constant((0.73, 0.73, 0.73)))
    light = b.diffuse_light(b.constant((10.0, 10.0, 10.0)))
    b.yz_rect(0, 10, 0, 10, 10, red, flip=True)
    b.xz_rect(0, 10, 0, 10, 0, white)
    lid = b.xz_rect(3, 7, 3, 7, 9.9, light, flip=True)
    b.light_rect(lid)
    cam = Camera.look_at(lookfrom=(5, 5, -12), lookat=(5, 3, 5), vfov=45.0,
                         aspect=1.0)
    return b.build(), cam


def _loss_fn(scene, cam, target, w, h):
    pixel_ids = jnp.arange(w * h, dtype=jnp.int32)

    def f(params):
        return image_loss(params, scene, cam, target, pixel_ids,
                          width=w, height=h, spp=8, max_depth=3, seed=7)
    return f


def test_grad_matches_finite_differences_albedo_and_emission():
    scene, cam = _cornellette()
    w = h = 12
    pixel_ids = jnp.arange(w * h, dtype=jnp.int32)
    target = render_pixels(scene, cam, pixel_ids, width=w, height=h,
                           spp=8, max_depth=3, seed=99)
    f = _loss_fn(scene, cam, target, w, h)

    params = {"tex_color": scene.tex_color}
    g = jax.grad(f)(params)["tex_color"]

    eps = 3e-3
    tc = np.asarray(scene.tex_color)
    # Check the two most influential entries per texture row.
    flat = np.abs(np.asarray(g)).sum(axis=1)
    rows = np.argsort(flat)[-2:]
    for i in rows:
        for c in range(3):
            delta = np.zeros_like(tc)
            delta[i, c] = eps
            lp = float(f({"tex_color": jnp.asarray(tc + delta)}))
            lm = float(f({"tex_color": jnp.asarray(tc - delta)}))
            fd = (lp - lm) / (2 * eps)
            an = float(g[i, c])
            # Same random stream on both sides: FD is exact up to O(eps^2).
            assert abs(fd - an) < 3e-3 + 0.05 * abs(fd), (i, c, fd, an)


def test_grad_nonzero_for_material_params():
    """Roughness (Beckmann alpha) and dielectric IOR receive gradients."""
    b = SceneBuilder()
    rough = b.beckmann(b.constant((0.9, 0.9, 0.9)), 0.3, 0.3)
    light = b.diffuse_light(b.constant((8.0, 8.0, 8.0)))
    b.sphere((0, 0, 0), 1.0, rough)
    lid = b.xz_rect(-2, 2, -2, 2, 4, light, flip=True)
    b.light_rect(lid)
    scene = b.build()
    cam = Camera.look_at(lookfrom=(0, 1, -5), lookat=(0, 0, 0), vfov=35.0,
                         aspect=1.0)
    w = h = 10
    pixel_ids = jnp.arange(w * h, dtype=jnp.int32)
    target = render_pixels(scene, cam, pixel_ids, width=w, height=h,
                           spp=8, max_depth=3, seed=3) * 0.8

    def f(params):
        return image_loss(params, scene, cam, target, pixel_ids,
                          width=w, height=h, spp=8, max_depth=3, seed=7)

    g = jax.grad(f)({"mat_params": scene.mat_params})["mat_params"]
    g = np.asarray(g)
    assert np.isfinite(g).all()
    assert np.abs(g[0, :2]).sum() > 0.0   # alpha_x, alpha_y of the beckmann


def test_inverse_recovers_albedo():
    """Gradient descent pulls a wrong wall color toward the target color."""
    import optax
    from srt.diff import make_train_step

    scene, cam = _cornellette()
    w = h = 12
    pixel_ids = jnp.arange(w * h, dtype=jnp.int32)
    target = render_pixels(scene, cam, pixel_ids, width=w, height=h,
                           spp=8, max_depth=3, seed=0)

    wrong = np.asarray(scene.tex_color).copy()
    true_red = wrong[0].copy()       # tex 0 = the red wall color
    wrong[0] = [0.3, 0.3, 0.6]
    params = {"tex_color": jnp.asarray(wrong)}

    opt = optax.adam(5e-2)
    step = make_train_step(scene, cam, opt, width=w, height=h, spp=8,
                           max_depth=3)
    state = opt.init(params)
    start_err = float(jnp.abs(params["tex_color"][0] - true_red).sum())
    for it in range(40):
        params, state, loss = step(params, state, target, it)
    end_err = float(jnp.abs(params["tex_color"][0] - true_red).sum())
    assert end_err < 0.5 * start_err, (start_err, end_err)


def test_grad_matches_finite_differences_light_position():
    """BASELINE config-5 scope includes *light position*: move a sphere
    light; jax.grad vs central FD on sph_center0.

    Configuration chosen so the estimator is smooth in the light center:
    the camera never sees the 0.5-radius light 30 units up (solid angle
    ~1e-4 sr), so the discrete which-lane-hits-the-emitter set is stable
    within +-eps and FD measures the same interior derivative autodiff
    computes (the silhouette/boundary term is out of scope — standard for
    interior-point differentiable rendering).
    """
    b = SceneBuilder()
    white = b.lambertian(b.constant((0.7, 0.7, 0.7)))
    glow = b.diffuse_light(b.constant((3000.0, 3000.0, 3000.0)))
    b.xz_rect(-4, 4, -4, 4, 0, white)
    lamp = b.sphere((2.0, 30.0, 0.0), 0.5, glow)
    b.light_sphere(lamp)
    scene = b.build()
    cam = Camera.look_at(lookfrom=(0, 6, -6), lookat=(0, 0, 0), vfov=30.0,
                         aspect=1.0)
    w = h = 10
    pixel_ids = jnp.arange(w * h, dtype=jnp.int32)
    target = render_pixels(scene, cam, pixel_ids, width=w, height=h,
                           spp=8, max_depth=2, seed=11) * 0.9

    def f(params):
        return image_loss(params, scene, cam, target, pixel_ids,
                          width=w, height=h, spp=8, max_depth=2, seed=7)

    g = jax.grad(f)({"sph_center0": scene.sph_center0})["sph_center0"]
    g = np.asarray(g)
    assert np.isfinite(g).all()
    assert np.abs(g[lamp]).sum() > 0.0

    c0 = np.asarray(scene.sph_center0)
    eps = 1e-3
    for axis in range(3):
        delta = np.zeros_like(c0)
        delta[lamp, axis] = eps
        lp = float(f({"sph_center0": jnp.asarray(c0 + delta)}))
        lm = float(f({"sph_center0": jnp.asarray(c0 - delta)}))
        fd = (lp - lm) / (2 * eps)
        an = float(g[lamp, axis])
        assert abs(fd - an) < 1e-3 + 0.25 * abs(fd), (axis, fd, an)


def _fog_scene():
    """BASELINE config-5 scene: a light and a rough sphere inside
    constant-medium fog (constant_medium.h:19-50 free flight)."""
    from srt.scene.library import fog_scene
    scene, cam, _ = fog_scene(aspect=1.0)
    return scene, cam


def test_fog_inverse_recovers_albedo_roughness_light():
    """BASELINE config 5: recover albedo + roughness + light intensity
    through a participating medium.

    Projected, masked gradient descent — only the unknown entries are
    optimized (the rest of the table is treated as known scene spec) and
    iterates are projected to their valid ranges, the standard setup for
    inverse material estimation.
    """
    import optax

    scene, cam = _fog_scene()
    w = h = 12
    pixel_ids = jnp.arange(w * h, dtype=jnp.int32)
    target = render_pixels(scene, cam, pixel_ids, width=w, height=h,
                           spp=8, max_depth=4, seed=0)

    true_tex = np.asarray(scene.tex_color)
    true_mat = np.asarray(scene.mat_params)
    wrong_tex = true_tex.copy()
    wrong_tex[1] = [0.6, 0.3, 0.2]       # ball albedo (tex 1)
    wrong_tex[2] = [10.0, 10.0, 10.0]    # light emission (tex 2; true 14)
    wrong_mat = true_mat.copy()
    wrong_mat[1, :2] = 0.8               # beckmann alpha (mat 1; true 0.4)
    params = {"tex_color": jnp.asarray(wrong_tex),
              "mat_params": jnp.asarray(wrong_mat)}

    tex_mask = np.zeros_like(true_tex)
    tex_mask[1] = tex_mask[2] = 1.0
    mat_mask = np.zeros_like(true_mat)
    mat_mask[1, :2] = 1.0
    masks = {"tex_color": jnp.asarray(tex_mask),
             "mat_params": jnp.asarray(mat_mask)}

    opt = optax.adam(5e-2)
    state = opt.init(params)

    @jax.jit
    def step(params, state, seed):
        loss, grads = jax.value_and_grad(image_loss)(
            params, scene, cam, target, pixel_ids, width=w, height=h,
            spp=8, max_depth=4, seed=seed)
        grads = jax.tree.map(lambda g, m: jnp.where(m > 0, g, 0.0),
                             grads, masks)
        updates, state = opt.update(grads, state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        # Projection to valid ranges.
        params = {"tex_color": jnp.maximum(params["tex_color"], 0.0),
                  "mat_params": jnp.clip(params["mat_params"], 1e-3, 4.0)}
        return params, state, loss

    def errs(p):
        t = np.asarray(p["tex_color"])
        m = np.asarray(p["mat_params"])
        return (np.abs(t[1] - true_tex[1]).sum(),
                np.abs(t[2] - true_tex[2]).sum(),
                np.abs(m[1, :2] - true_mat[1, :2]).sum())

    e0 = errs(params)
    for it in range(120):
        # Noise-aligned estimator: the loss reuses the target's seed, so
        # the objective is exactly 0 at the true parameters and the
        # variance term of a noisy L2 (whose emission-derivative would
        # otherwise bias the light recovery at low spp) cancels.
        params, state, loss = step(params, state, 0)
    e1 = errs(params)
    assert np.isfinite(float(loss)), loss
    assert all(np.isfinite(np.asarray(v)).all() for v in params.values())
    # Albedo and light intensity recover strongly; roughness is the
    # weakest signal through fog but must improve.
    assert e1[0] < 0.5 * e0[0], ("albedo", e0, e1)
    assert e1[1] < 0.5 * e0[1], ("light", e0, e1)
    assert e1[2] < e0[2], ("roughness", e0, e1)


def test_hybrid_kernel_vjp_matches_xla():
    """The fused-kernel-forward / XLA-backward bounce
    (pallas/bounce_vjp.py): loss and gradient through the regen engine
    with the kernel (interpret mode) must match the pure-XLA path.

    Small per-bounce float differences between the two forwards compound
    through the estimator, so the contract is close agreement, not
    bitwise equality (see tests/test_fused_bounce.py for the per-bounce
    bound)."""
    from srt.scene.ir import SceneFlags

    scene, cam = _cornellette()
    assert SceneFlags.of(scene).fused_bounce  # eligible for the kernel
    w = h = 8
    pixel_ids = jnp.arange(w * h, dtype=jnp.int32)
    target = render_pixels(scene, cam, pixel_ids, width=w, height=h,
                           spp=4, max_depth=3, seed=99)

    def run(mode):
        def f(params):
            return image_loss(params, scene, cam, target, pixel_ids,
                              width=w, height=h, spp=4, max_depth=3,
                              seed=7, engine_kw=dict(pallas_mode=mode))
        params = {"tex_color": scene.tex_color,
                  "mat_params": scene.mat_params}
        loss, g = jax.value_and_grad(f)(params)
        return float(loss), np.asarray(g["tex_color"]), \
            np.asarray(g["mat_params"])

    loss_x, gtex_x, gmat_x = run("off")
    loss_k, gtex_k, gmat_k = run("interpret")

    assert abs(loss_k - loss_x) < 1e-4 + 1e-3 * abs(loss_x)
    np.testing.assert_allclose(gtex_k, gtex_x, rtol=5e-3, atol=1e-5)
    np.testing.assert_allclose(gmat_k, gmat_x, rtol=5e-3, atol=1e-5)
