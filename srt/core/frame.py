"""Shading-frame trigonometry on batched local-frame vectors.

Equivalent of the reference's ``reflection.h:8-53`` helpers: all functions take
``(..., 3)`` vectors expressed in a local frame whose +z axis is the shading
normal, and return ``(...)`` scalars. Branches become ``jnp.where`` selects.
"""
from __future__ import annotations

import jax.numpy as jnp

from srt.core.vecmath import gsdiv, safe_sqrt


def cos_theta(w):
    return w[..., 2]


def cos2_theta(w):
    return w[..., 2] * w[..., 2]


def abs_cos_theta(w):
    return jnp.abs(w[..., 2])


def sin2_theta(w):
    return jnp.maximum(0.0, 1.0 - cos2_theta(w))


def sin_theta(w):
    return safe_sqrt(1.0 - cos2_theta(w))


def tan_theta(w):
    """Sign-preserving, finite-safe tan (grazing angles clamp to ±1e8 so the
    backward pass never sees inf)."""
    c = cos_theta(w)
    safe = jnp.where(jnp.abs(c) < 1e-8, jnp.sign(c) * 1e-8 + 1e-20, c)
    return sin_theta(w) / safe


def tan2_theta(w):
    return gsdiv(sin2_theta(w), jnp.maximum(cos2_theta(w), 1e-20))


def cos_phi(w):
    st = sin_theta(w)
    return jnp.where(st == 0.0, 1.0,
                     jnp.clip(gsdiv(w[..., 0], jnp.maximum(st, 1e-20)),
                              -1.0, 1.0))


def sin_phi(w):
    st = sin_theta(w)
    return jnp.where(st == 0.0, 0.0,
                     jnp.clip(gsdiv(w[..., 1], jnp.maximum(st, 1e-20)),
                              -1.0, 1.0))


def cos2_phi(w):
    c = cos_phi(w)
    return c * c


def sin2_phi(w):
    s = sin_phi(w)
    return s * s


def same_hemisphere(w, wp):
    return w[..., 2] * wp[..., 2] > 0.0


def spherical_direction(sin_t, cos_t, phi):
    """(sinθcosφ, sinθsinφ, cosθ) (reference ``geometry.h:97-99``)."""
    return jnp.stack([sin_t * jnp.cos(phi), sin_t * jnp.sin(phi), cos_t], axis=-1)


def local_reflect(wo, wh):
    """Reflect ``wo`` about half-vector ``wh`` in the local frame
    (reference ``reflection.h:34-36``)."""
    return -wo + 2.0 * jnp.sum(wo * wh, axis=-1, keepdims=True) * wh
