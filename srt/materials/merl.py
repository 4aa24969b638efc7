"""MERL measured-BRDF table lookup in Rusinkiewicz half/diff coordinates.

Math of the reference's ``brdf.h:106-214`` (``std_coords_to_half_diff_coords``
+ index quantization), vectorized over local-frame direction batches. The
binary reader lives in :mod:`srt.io.merl`.
"""
from __future__ import annotations

import jax.numpy as jnp

RES_THETA_H = 90
RES_THETA_D = 90
RES_PHI_D = 360  # stored /2 due to reciprocity


def _rotate_z(v, angle):
    c, s = jnp.cos(angle), jnp.sin(angle)
    return jnp.stack([c * v[..., 0] - s * v[..., 1],
                      s * v[..., 0] + c * v[..., 1], v[..., 2]], axis=-1)


def _rotate_y(v, angle):
    c, s = jnp.cos(angle), jnp.sin(angle)
    return jnp.stack([c * v[..., 0] + s * v[..., 2], v[..., 1],
                      -s * v[..., 0] + c * v[..., 2]], axis=-1)


def half_diff_indices(wo, wi):
    """Quantized (theta_half, theta_diff, phi_diff) table index.

    Index quantization of ``brdf.h:17-61`` (square-root warp on theta_half).
    """
    wh = wo + wi
    wh = wh / jnp.maximum(jnp.linalg.norm(wh, axis=-1, keepdims=True), 1e-20)
    theta_h = jnp.arccos(jnp.clip(wh[..., 2], -1.0, 1.0))
    phi_h = jnp.arctan2(wh[..., 1], wh[..., 0])

    d = _rotate_y(_rotate_z(wi, -phi_h), -theta_h)
    theta_d = jnp.arccos(jnp.clip(d[..., 2], -1.0, 1.0))
    phi_d = jnp.arctan2(d[..., 1], d[..., 0])

    th_deg = theta_h / (jnp.pi / 2.0) * RES_THETA_H
    th_idx = jnp.sqrt(jnp.maximum(th_deg * RES_THETA_H, 0.0)).astype(jnp.int32)
    th_idx = jnp.clip(th_idx, 0, RES_THETA_H - 1)

    td_idx = jnp.clip((theta_d / (jnp.pi / 2.0) * RES_THETA_D).astype(jnp.int32),
                      0, RES_THETA_D - 1)

    phi_d = jnp.where(phi_d < 0.0, phi_d + jnp.pi, phi_d)
    pd_idx = jnp.clip((phi_d / jnp.pi * (RES_PHI_D // 2)).astype(jnp.int32),
                      0, RES_PHI_D // 2 - 1)

    return (pd_idx + td_idx * (RES_PHI_D // 2)
            + th_idx * (RES_PHI_D // 2) * RES_THETA_D)


def lookup(tables, table_id, wo, wi):
    """f_rgb(wo, wi) from stacked tables (Nm, 3, K) — scales pre-applied."""
    ind = half_diff_indices(wo, wi)
    tid = jnp.clip(table_id, 0, tables.shape[0] - 1)
    k = tables.shape[-1]
    flat = tables.reshape(-1)
    base = (tid * 3) * k + jnp.clip(ind, 0, k - 1)
    val = jnp.stack([flat[base], flat[base + k], flat[base + 2 * k]], axis=-1)
    return jnp.maximum(val, 0.0)
