"""Texture table evaluation: constant / checker / Perlin marble / image.

One batched function evaluates every texel query for a wavefront of hits.
All four texture models are computed on masked lanes and selected by tag —
this costs a handful of fused elementwise ops, far cheaper than
divergent per-ray dispatch (the reference virtual-dispatches per hit,
``texture.h:4-70``).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from srt.scene.ir import Scene, TextureType, has_tex


def _lut256(table_f32, idx):
    """Exact 256-entry table lookup as a one-hot matmul.

    The matmul replaces a gather (it was written for a machine whose
    random gathers ran serially; whether it still pays on the GPU is an
    open measurement, ROADMAP §1 item 5) and is *bit-exact*: the one-hot
    rows multiply the table by exactly 1.0 or 0.0, which is lossless even through the split-bf16
    HIGHEST-precision path, and the row sum adds one nonzero term.
    ``idx``: (...,) int32 in [0, 256); ``table_f32``: (256,) or (256, k).
    """
    import jax
    oh = (idx[..., None] == jnp.arange(256, dtype=idx.dtype)).astype(
        jnp.float32)
    return jnp.matmul(oh, table_f32, precision=jax.lax.Precision.HIGHEST)


def perlin_noise(scene: Scene, p):
    """Gradient Perlin noise with hermite smoothing.

    Math of ``perlin.h:7-46``: 256-entry permutation tables xor-combined to
    index random unit gradients, trilinear hermite blend of corner dots.
    ``p``: (N, 3) -> (N,).

    Table lookups run as one-hot matmuls (:func:`_lut256`, bit-exact)
    and the per-axis permutation reads are hoisted out of the corner loop
    — 6 permutation + 8 gradient lookups per call instead of the naive
    32 serial gathers.
    """
    pf = jnp.floor(p)
    uvw = p - pf                              # (N, 3) fractional
    ijk = pf.astype(jnp.int32)                # (N, 3)
    s = uvw * uvw * (3.0 - 2.0 * uvw)         # hermite per axis (N, 3)

    permf = scene.perlin_perm.astype(jnp.float32)      # (3, 256)
    # per-axis hashes for offsets 0/1 (values <= 255: exact through f32)
    h = [[_lut256(permf[a], (ijk[..., a] + d) & 255).astype(jnp.int32)
          for d in (0, 1)] for a in range(3)]
    acc = jnp.zeros_like(p[..., 0])
    for di in range(2):
        for dj in range(2):
            for dk in range(2):
                g = _lut256(scene.perlin_vec,
                            h[0][di] ^ h[1][dj] ^ h[2][dk])     # (N, 3)
                weight = uvw - np.array([di, dj, dk], np.float32)
                corner = jnp.sum(g * weight, axis=-1)
                wx = s[..., 0] if di else (1.0 - s[..., 0])
                wy = s[..., 1] if dj else (1.0 - s[..., 1])
                wz = s[..., 2] if dk else (1.0 - s[..., 2])
                acc = acc + wx * wy * wz * corner
    return acc


def perlin_turb(scene: Scene, p, depth: int = 7):
    """fbm turbulence (``perlin.h:48-58``)."""
    acc = jnp.zeros_like(p[..., 0])
    weight = 1.0
    q = p
    for _ in range(depth):
        acc = acc + weight * perlin_noise(scene, q)
        weight *= 0.5
        q = q * 2.0
    return jnp.abs(acc)


def _marble(scene: Scene, tex_id, p):
    """Marble intensity 0.5*(1+sin(scale*z + 5*turb)) (``texture.h:42``)."""
    scale = scene.tex_scale[tex_id][..., None]
    turb = perlin_turb(scene, scale * p)
    return 0.5 * (1.0 + jnp.sin(scale[..., 0] * p[..., 2] + 5.0 * turb))


def texture_value_compact(scene: Scene, tex_id, uv, p, flags, active,
                          capacity: int):
    """:func:`texture_value` evaluated only on the stream-compacted
    ``active`` lanes -> (N, 3); inactive lanes return 0.

    Perlin turbulence is 7 octaves x 8 corners x 4 table gathers per lane
    — by far the most expensive texel in the framework (it alone halved
    ``final``'s throughput when evaluated full-width, PERF.md) — and
    image-atlas gathers cost too. Deferred-texture lanes are typically a
    few percent of a wavefront, so: cumsum-rank compact them into a
    ``capacity``-sized buffer (the regen work-queue pattern), evaluate
    there, gather back. Per-lane math is unchanged, so values are
    bit-identical to the full-width evaluation. If more than ``capacity``
    lanes are active, a ``lax.cond`` falls back to the full-width
    evaluation — exact at any occupancy.
    """
    import jax

    n = p.shape[0]
    cap = min(capacity, n)
    rank = jnp.cumsum(active.astype(jnp.int32)) - 1
    slot = jnp.where(active & (rank < cap), rank, cap)  # cap = dump slot
    comp_p = jnp.zeros((cap + 1, 3), p.dtype).at[slot].set(p)
    comp_uv = jnp.zeros((cap + 1, 2), uv.dtype).at[slot].set(uv)
    comp_id = jnp.zeros((cap + 1,), tex_id.dtype).at[slot].set(tex_id)
    col = texture_value(scene, comp_id, comp_uv, comp_p, flags)[slot]
    overflow = jnp.any(active & (rank >= cap))
    mask3 = active[:, None]
    return jax.lax.cond(
        overflow,
        lambda: jnp.where(mask3, texture_value(scene, tex_id, uv, p, flags),
                          0.0),
        lambda: jnp.where(mask3, col, 0.0))


def _image_value(scene: Scene, tex_id, u, v):
    """Nearest-neighbor atlas lookup with y-flip (``texture.h:58-70``).

    Uses the packed rgb8 twin (``Scene.atlas_u32``) when present: one u32
    gather + bit unpack instead of three f32 gathers — and unpacking
    ``int(v)/255.0`` in f32 reproduces the build-time ``u8/255`` values
    bit-exactly.
    """
    meta = scene.tex_img[tex_id]              # (N, 3) offset, nx, ny
    off, nx, ny = meta[..., 0], meta[..., 1], meta[..., 2]
    i = jnp.clip((u * nx.astype(u.dtype)).astype(jnp.int32), 0, nx - 1)
    j = jnp.clip(((1.0 - v) * ny.astype(v.dtype) - 0.001).astype(jnp.int32),
                 0, ny - 1)
    if scene.atlas.shape[0] == 0:
        return jnp.ones_like(u)[..., None] * np.ones(3, np.float32)
    if scene.atlas_u32 is not None:
        base3 = off // 3 + i + nx * j
        bits = scene.atlas_u32[jnp.clip(base3, 0,
                                        scene.atlas_u32.shape[0] - 1)]
        inv = np.float32(255.0)
        return jnp.stack([((bits >> 16) & 255).astype(jnp.float32) / inv,
                          ((bits >> 8) & 255).astype(jnp.float32) / inv,
                          (bits & 255).astype(jnp.float32) / inv], axis=-1)
    base = off + 3 * (i + nx * j)
    base = jnp.clip(base, 0, scene.atlas.shape[0] - 3)
    return jnp.stack([scene.atlas[base], scene.atlas[base + 1],
                      scene.atlas[base + 2]], axis=-1)


def texture_value(scene: Scene, tex_id, uv, p, flags=None):
    """Evaluate texture ``tex_id`` (N,) at hit uv (N,2) / position (N,3).

    ``flags`` (:class:`srt.scene.ir.SceneFlags`) statically skips
    texture families the scene doesn't use — bit-identical, since skipped
    families' selection masks are all-False. With ``flags=None``, falls
    back to inspecting the table when it is a concrete closure constant.
    """
    ttype = scene.tex_type[tex_id]
    color = scene.tex_color[tex_id]
    out = color

    def table_has(kind):
        if flags is not None:
            return has_tex(flags, kind)
        try:  # concrete (closure-constant) table — inspect directly
            return bool((scene.tex_type == kind).any())
        except Exception:
            return True  # traced table — evaluate unconditionally

    if table_has(TextureType.CHECKER):
        # CHECKER: 3-D sine parity between two colors (texture.h:13-19).
        sines = (jnp.sin(10.0 * p[..., 0]) * jnp.sin(10.0 * p[..., 1])
                 * jnp.sin(10.0 * p[..., 2]))
        checker = jnp.where((sines < 0.0)[..., None],
                            scene.tex_color2[tex_id], color)
        out = jnp.where((ttype == TextureType.CHECKER)[..., None], checker,
                        out)

    if table_has(TextureType.NOISE):
        # NOISE: marble 0.5*(1+sin(scale*z + 5*turb)) (texture.h:42).
        marble = _marble(scene, tex_id, p)[..., None] * jnp.ones_like(color)
        out = jnp.where((ttype == TextureType.NOISE)[..., None], marble,
                        out)

    if table_has(TextureType.IMAGE):
        image = _image_value(scene, tex_id, uv[..., 0], uv[..., 1])
        out = jnp.where((ttype == TextureType.IMAGE)[..., None], image, out)

    return out
