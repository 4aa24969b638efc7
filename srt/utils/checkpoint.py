"""Checkpoint / resume: tile-accumulator renders and optimizer state.

The reference has no persistence at all — a render dies with the process
and the only artifact is the final PPM dump (``Raytracing_n.cpp:869-878``).
Here (SURVEY §5) long renders checkpoint the accumulated radiance *sums*
plus the sample cursor, and resume by continuing the sample loop: every
random decision is a pure function of ``(seed, pixel, sample, bounce)``
(:mod:`srt.core.rng`), so a resumed render is *bit-identical* to an
uninterrupted one — re-execution after failure costs only the samples since
the last checkpoint.

Inverse-rendering optimizer state (params + optax state) uses the same npz
container via flattened pytree leaves.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np


def _atomic_savez(path: str, **arrays) -> None:
    """Write-then-rename so a crash mid-save never corrupts a checkpoint."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


# --------------------------------------------------------------------------
# Render checkpointing
# --------------------------------------------------------------------------

def save_render_ckpt(path: str, acc: np.ndarray, spp_done: int,
                     config) -> None:
    """Persist radiance sums + sample cursor + the config fingerprint."""
    meta = json.dumps(dataclasses.asdict(config))
    _atomic_savez(path, acc=np.asarray(acc), spp_done=np.int64(spp_done),
                  config_json=np.frombuffer(meta.encode(), np.uint8))


def load_render_ckpt(path: str, config) -> tuple[np.ndarray, int] | None:
    """(acc, spp_done), or None if absent/mismatched with ``config``."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        meta = json.loads(bytes(z["config_json"]).decode())
        current = dataclasses.asdict(config)
        # seed/resolution/depth must match for the streams to line up;
        # chunk sizes are execution details and may differ.
        keys = ("width", "height", "spp", "max_depth", "seed", "rr_start",
                "sobol_pixel_jitter", "pdf_floor")
        if any(meta.get(k) != current.get(k) for k in keys):
            return None
        return z["acc"].copy(), int(z["spp_done"])


def render_resumable(scene, camera, config, ckpt_path: str,
                     ckpt_every_spp: int = 16,
                     sobol_file: str | None = None) -> jnp.ndarray:
    """Render with periodic checkpoints; resumes from ``ckpt_path`` if
    present. Returns the (H, W, 3) linear image and deletes the checkpoint
    on completion.

    Bit-identical to :func:`srt.render.api.render` with the same
    config when ``ckpt_every_spp`` is a multiple of ``sample_chunk``
    (accumulation happens in the same sample-chunk order).
    """
    from srt.core.sobol import sobol_points
    from srt.render.api import _render_chunk, _rng_jitter, scene_flags

    flags = scene_flags(scene, config)  # same specialization as render()
    w, h, spp = config.width, config.height, config.spp
    n_pixels = w * h

    if config.sobol_pixel_jitter:
        pts = sobol_points(max(spp, 2), 2, dir_file=sobol_file)[:max(spp, 1)]
        jit_pts = jnp.asarray(pts, jnp.float32)
    else:
        jit_pts = _rng_jitter(spp, config.seed)

    loaded = load_render_ckpt(ckpt_path, config)
    if loaded is not None:
        acc_np, s_done = loaded
        acc = jnp.asarray(acc_np)
    else:
        acc, s_done = jnp.zeros((n_pixels, 3), jnp.float32), 0

    chunk = min(config.sample_chunk, spp)
    since_ckpt = 0
    s0 = s_done
    while s0 < spp:
        n_s = min(chunk, spp - s0)
        part = jnp.zeros((n_pixels, 3), jnp.float32)
        for p0 in range(0, n_pixels, config.pixel_chunk):
            p1 = min(p0 + config.pixel_chunk, n_pixels)
            pixel_ids = jnp.arange(p0, p1, dtype=jnp.int32)
            part = part.at[p0:p1].add(_render_chunk(
                scene, camera, pixel_ids, s0, jit_pts, config.seed,
                width=w, height=h, max_depth=config.max_depth,
                rr_start=config.rr_start, n_samples=n_s, flags=flags,
                pdf_floor=config.pdf_floor))
        acc = acc + part
        s0 += n_s
        since_ckpt += n_s
        if since_ckpt >= ckpt_every_spp and s0 < spp:
            save_render_ckpt(ckpt_path, np.asarray(acc), s0, config)
            since_ckpt = 0

    if os.path.exists(ckpt_path):
        os.unlink(ckpt_path)
    return (acc / spp).reshape(h, w, 3)


# --------------------------------------------------------------------------
# Optimizer-state checkpointing (inverse rendering)
# --------------------------------------------------------------------------

def save_pytree(path: str, tree) -> None:
    """Persist any pytree of arrays (params + optax state) as npz leaves."""
    leaves = jax.tree_util.tree_leaves(tree)
    _atomic_savez(path, n=np.int64(len(leaves)),
                  **{f"leaf_{i}": np.asarray(x)
                     for i, x in enumerate(leaves)})


def load_pytree(path: str, like):
    """Restore a pytree saved by :func:`save_pytree` into the structure of
    ``like`` (e.g. a freshly initialized (params, opt_state))."""
    if not os.path.exists(path):
        return None
    treedef = jax.tree_util.tree_structure(like)
    with np.load(path) as z:
        n = int(z["n"])
        leaves = [jnp.asarray(z[f"leaf_{i}"]) for i in range(n)]
    if n != treedef.num_leaves:
        return None
    return jax.tree_util.tree_unflatten(treedef, leaves)
