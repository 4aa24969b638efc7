"""Checkpoint/resume: bit-identical resumed renders, pytree round-trip."""
import os

import jax
import jax.numpy as jnp
import numpy as np

from srt import RenderConfig, render
from srt.render.api import _render_chunk
from srt.core.sobol import sobol_points
from srt.scene.library import cornell_boxes
from srt.utils.checkpoint import (load_pytree, load_render_ckpt,
                                      render_resumable, save_pytree,
                                      save_render_ckpt)

CFG = dict(width=12, height=12, spp=4, max_depth=4, sample_chunk=2)


def test_resumable_equals_plain(tmp_path):
    scene, cam, _ = cornell_boxes(aspect=1.0)
    cfg = RenderConfig(**CFG)
    full = np.asarray(render(scene, cam, cfg))
    ck = str(tmp_path / "r.npz")
    res = np.asarray(render_resumable(scene, cam, cfg, ck, ckpt_every_spp=2))
    assert np.array_equal(full, res)
    assert not os.path.exists(ck)  # deleted on completion


def test_resume_from_partial_checkpoint(tmp_path):
    """Simulate a crash after 2 of 4 spp: resume must be bit-identical."""
    scene, cam, _ = cornell_boxes(aspect=1.0)
    cfg = RenderConfig(**CFG)
    full = np.asarray(render(scene, cam, cfg))

    # Partial accumulator: samples 0..1 only, as the resumable loop
    # would have computed it before dying.
    pts = jnp.asarray(sobol_points(cfg.spp, 2), jnp.float32)[:cfg.spp]
    pixel_ids = jnp.arange(cfg.width * cfg.height, dtype=jnp.int32)
    from srt.scene.ir import SceneFlags
    acc = np.asarray(_render_chunk(
        scene, cam, pixel_ids, 0, pts, cfg.seed, width=cfg.width,
        height=cfg.height, max_depth=cfg.max_depth, rr_start=cfg.rr_start,
        n_samples=2, flags=SceneFlags.of(scene)))
    ck = str(tmp_path / "r.npz")
    save_render_ckpt(ck, acc, 2, cfg)

    res = np.asarray(render_resumable(scene, cam, cfg, ck))
    assert np.array_equal(full, res)


def test_mismatched_checkpoint_rejected(tmp_path):
    scene, cam, _ = cornell_boxes(aspect=1.0)
    cfg = RenderConfig(**CFG)
    ck = str(tmp_path / "r.npz")
    save_render_ckpt(ck, np.ones((144, 3), np.float32), 2, cfg)
    other = RenderConfig(**{**CFG, "seed": 99})
    assert load_render_ckpt(ck, other) is None     # seed mismatch
    assert load_render_ckpt(ck, cfg) is not None


def test_pytree_roundtrip(tmp_path):
    import optax
    params = {"a": jnp.arange(3.0), "b": {"c": jnp.ones((2, 2))}}
    opt = optax.adam(1e-2)
    state = opt.init(params)
    path = str(tmp_path / "opt.npz")
    save_pytree(path, (params, state))
    restored = load_pytree(path, (params, state))
    assert restored is not None
    r_params, r_state = restored
    np.testing.assert_array_equal(np.asarray(r_params["a"]),
                                  np.asarray(params["a"]))
    chex_leaves = jax.tree_util.tree_leaves(r_state)
    orig_leaves = jax.tree_util.tree_leaves(state)
    assert len(chex_leaves) == len(orig_leaves)
    for x, y in zip(chex_leaves, orig_leaves):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
