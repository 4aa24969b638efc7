"""Batched 3-vector math on ``(..., 3)`` arrays.

Wavefront replacement for the scalar ``vec3`` value class of the reference
(``Raytracing_n/vec3.h:11-173``): every helper here maps elementwise over an
arbitrary leading batch shape so a whole wavefront of rays is processed in
one fused XLA op, instead of one C++ object at a time.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def vec3(x, y, z, dtype=jnp.float32):
    """Stack three scalars/arrays into a ``(..., 3)`` vector array."""
    return jnp.stack(jnp.broadcast_arrays(
        jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(z, dtype)), axis=-1)


def dot(a, b):
    """Batched dot product over the trailing axis, keepdims dropped."""
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def length_sq(a):
    return jnp.sum(a * a, axis=-1)


def length(a):
    return jnp.sqrt(length_sq(a))


def normalize(a, eps: float = 1e-20):
    """Unit vector; safe against zero-length input (returns ~0 instead of
    NaN), with a finite backward there too (safe_sqrt, gsrecip)."""
    return a * gsrecip(jnp.maximum(safe_sqrt(length_sq(a)), eps))[..., None]


def reflect(v, n):
    """Mirror ``v`` about normal ``n`` (reference: ``material.h:34-36``)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract_dir(v, n, ni_over_nt):
    """Snell refraction of direction ``v`` about outward normal ``n``.

    Returns ``(refracted, ok)`` where ``ok`` is False on total internal
    reflection (math of reference ``material.h:21-32``). ``refracted`` is only
    meaningful where ``ok``.
    """
    uv = normalize(v)
    dt = dot(uv, n)
    disc = 1.0 - ni_over_nt * ni_over_nt * (1.0 - dt * dt)
    ok = disc > 0.0
    # Double-where: sqrt has an infinite derivative at 0, which would turn
    # masked-out TIR lanes into NaN gradients for the IOR.
    disc_safe = jnp.where(ok, disc, 1.0)
    refracted = (ni_over_nt[..., None] * (uv - n * dt[..., None])
                 - n * jnp.sqrt(disc_safe)[..., None])
    refracted = where3(ok, refracted, jnp.zeros_like(refracted))
    return refracted, ok


def where3(mask, a, b):
    """Select between two ``(..., 3)`` arrays with a ``(...)`` mask."""
    return jnp.where(mask[..., None], a, b)


def floor_clamp(x, lo):
    """``maximum(x, lo)`` whose vjp is a pure select.

    ``lax.max`` splits tie-gradients with a multiply, so a NaN cotangent
    leaks into the *clamped* operand (grad(maximum(x, lo) * nan) == nan
    even for x < lo); parameter-table clamps must block that — rows of
    unrelated materials read garbage params on masked lanes whose
    cotangents can be non-finite."""
    ok = x > lo
    return jnp.where(ok, x, lo)


def safe_normalize(v, eps: float = 1e-12):
    """Unit vector with a NaN-free backward pass: degenerate inputs
    (|v|^2 <= eps, e.g. the half-vector of wi == -wo) map to +z with zero
    cotangent instead of 0/0."""
    l2 = jnp.sum(v * v, axis=-1, keepdims=True)
    ok = l2 > eps
    fallback = jnp.zeros_like(v).at[..., 2].set(1.0)
    return jnp.where(ok, v, fallback) / jnp.sqrt(jnp.where(ok, l2, 1.0))


def safe_sqrt(x, eps: float = 0.0):
    """sqrt that is NaN-free in the *backward* pass on clamped lanes.

    ``sqrt(maximum(x, 0))`` has derivative inf at 0 — masking the output
    afterwards still poisons gradients (0 * inf = NaN). The double-where
    keeps the primal identical and routes clamped lanes' cotangents
    through a constant."""
    pos = x > eps
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), 0.0)


@jax.custom_jvp
def gsdiv(num, den):
    """``num / den`` with the same VALUE, but clamped tangent
    coefficients: the plain division's den-cotangent is ``-num / den**2``,
    which overflows f32 to inf against the tiny guard floors (1e-20) used
    all over the sampling math — and ``0 * inf = NaN`` then poisons the
    backward pass through masked lanes (minimal repro:
    ``grad(lambda x: 1/jnp.maximum(x-1, 1e-20))(1.0)``)."""
    return num / den


@gsdiv.defjvp
def _gsdiv_jvp(primals, tangents):
    num, den = primals
    dnum, dden = tangents
    inv = 1.0 / den
    out = num * inv
    coef = jnp.clip(-out * inv, -3e37, 3e37)
    return num / den, dnum * inv + dden * coef


@jax.custom_jvp
def gsrecip(den):
    """``jnp.reciprocal(den)`` with a clamped tangent (see :func:`gsdiv`)."""
    return jnp.reciprocal(den)


@gsrecip.defjvp
def _gsrecip_jvp(primals, tangents):
    den, = primals
    dden, = tangents
    out = jnp.reciprocal(den)
    coef = jnp.clip(-out * out, -3e37, 3e37)
    return out, dden * coef


def de_nan(c):
    """Zero out NaN channels per sample (reference: ``Raytracing_n.cpp:47-53``),
    except here it is counted by the caller's metrics instead of silent."""
    return jnp.where(jnp.isnan(c), 0.0, c)
