"""Beckmann roughness gradient vs central finite differences, for each
forward the train step can take: the fused bounce kernel (interpret mode)
with the XLA-linearization backward of ``pallas/bounce_vjp.py``, and the
plain XLA bounce.

Both sides use the same random stream, so FD of the loss is exact up to
O(eps^2) and float32 rounding — as long as the step crosses no knife-edge
branch of the sampler (at eps = 1e-2 one VNDF lane flips here and moves
FD of alpha_y by 8%; 3e-3 and 1e-3 agree to 0.2%). A backward that drops
the roughness dependence of the sampled VNDF direction gives
(-0.0065, 0.0323) here against FD's (-0.0179, 0.0391).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from srt.diff import image_loss, render_pixels
from srt.scene.library import fog_scene

EPS = 3e-3          # alpha = 0.4: small against alpha, large against f32 noise


@pytest.mark.parametrize("forward", ["kernel", "xla"])
def test_beckmann_roughness_grad_matches_fd(forward):
    scene, cam, _ = fog_scene(aspect=1.0)
    side = 8
    pixel_ids = jnp.arange(side * side, dtype=jnp.int32)
    target = render_pixels(scene, cam, pixel_ids, width=side, height=side,
                           spp=4, max_depth=4, seed=99, pallas_mode="off")
    kw = dict(pallas_mode="interpret" if forward == "kernel" else "off")

    def f(mat_params):
        return image_loss({"mat_params": mat_params}, scene, cam, target,
                          pixel_ids, width=side, height=side, spp=4,
                          max_depth=4, seed=7, engine_kw=kw)

    g = np.asarray(jax.jit(jax.grad(f))(scene.mat_params))
    assert np.isfinite(g).all()
    loss = jax.jit(f)
    mp = np.asarray(scene.mat_params)
    for c in (0, 1):                     # material 1 = the Beckmann ball
        delta = np.zeros_like(mp)
        delta[1, c] = EPS
        fd = (float(loss(jnp.asarray(mp + delta)))
              - float(loss(jnp.asarray(mp - delta)))) / (2 * EPS)
        assert abs(g[1, c] - fd) < 2e-4 + 0.05 * abs(fd), (c, g[1, c], fd)
