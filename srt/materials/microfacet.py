"""Anisotropic Beckmann microfacet distribution with visible-normal sampling.

Batched JAX port of the *math* of the reference's PBRT-style
``microfacet_distribution.h`` (D: lines 155-162, Lambda: 164-173, VNDF
sampling via the erf-domain numerical inversion: 12-107, 175-211). The
numerical inversion runs a fixed 6-step Newton-bisection (the reference
iterates up to 10 with an early-out; a fixed count keeps the loop unrolled
and branch-free).

All directions are in the local shading frame (+z = normal).
"""
from __future__ import annotations

import jax.numpy as jnp

from srt.core import frame
# The reference evaluates erf/erfinv with its own polynomial fits
# (common.h:26-78), not libm; using the same shared fits here keeps the
# XLA path and the fused bounce kernel sample-stream-aligned. See
# core/approx.py.
from srt.core.approx import (acos_as, erf_as, erf_reference_buggy,
                             erfinv_giles as erfinv)
from srt.core.vecmath import gsdiv, safe_sqrt

_SQRT_PI_INV = 0.5641895835477563


def beckmann_d(wh, alphax, alphay):
    """Anisotropic Beckmann NDF (microfacet_distribution.h:155-162).

    ``tan2`` is clamped to a finite huge value before the exp: at grazing
    half-vectors the raw inf makes ``d exp(-tan2/a^2)/da = 0 * inf = NaN``
    in the backward pass (alpha is an optimizable parameter); with the
    clamp the exp is still exactly 0 in f32 and its alpha-cotangent is 0.
    """
    tan2 = jnp.minimum(frame.tan2_theta(wh), 1e8)
    cos4 = frame.cos2_theta(wh) ** 2
    e = jnp.exp(-tan2 * (frame.cos2_phi(wh) / (alphax * alphax)
                         + frame.sin2_phi(wh) / (alphay * alphay)))
    d = gsdiv(e, jnp.pi * alphax * alphay * jnp.maximum(cos4, 1e-16))
    return jnp.where(tan2 < 1e8, d, 0.0)  # NaN tan2 falls into the 0 branch


def beckmann_lambda(w, alphax, alphay):
    """Rational-approx Lambda (microfacet_distribution.h:164-173).

    ``abs_tan`` clamped finite: at cos-theta == 0 lanes the raw inf turns
    the alpha-cotangent of ``1/(alpha*tan)`` into 0 * inf = NaN even
    though the primal is correctly clipped below.
    """
    abs_tan = jnp.minimum(jnp.abs(frame.tan_theta(w)), 1e8)
    alpha = jnp.sqrt(frame.cos2_phi(w) * alphax * alphax
                     + frame.sin2_phi(w) * alphay * alphay)
    a = gsdiv(jnp.ones_like(abs_tan), jnp.maximum(alpha * abs_tan, 1e-16))
    # Evaluate the rational fit on a clamped argument (double-where): the
    # raw value at a->0 diverges and would poison gradients even on lanes
    # the outer where discards.
    a_safe = jnp.clip(a, 1e-4, 1.6)
    lam = ((1.0 - 1.259 * a_safe + 0.396 * a_safe * a_safe)
           / (3.535 * a_safe + 2.181 * a_safe * a_safe))
    lam = jnp.where(a > 1.6, 0.0, lam)
    return lam


def g1(w, alphax, alphay):
    return 1.0 / (1.0 + beckmann_lambda(w, alphax, alphay))


def g(wo, wi, alphax, alphay):
    return 1.0 / (1.0 + beckmann_lambda(wo, alphax, alphay)
                  + beckmann_lambda(wi, alphax, alphay))


def _beckmann_sample11(cos_theta_i, u1, u2, ref_parity: bool = False):
    """Sample P22 slopes for normal-incidence-stretched wi.

    Exact masked-lane transcription of ``BeckmannSample11``
    (microfacet_distribution.h:34-107): up to 9 Newton-bisection steps
    in the Erf domain with the reference's |value| < 1e-5 early-out
    (lanes FREEZE once converged — the reference breaks before the
    bounds update), and NO extra clipping of ``b``: its ErfInv already
    clamps at +-0.99999 (common.h:49), so diverged hard lanes saturate
    to ErfInv(0.99999) exactly as the reference's do. (Round-4 finding:
    our earlier +-0.9999 clip and free-running iterations produced a
    visibly different highlight lobe on every Beckmann sphere —
    concentric +-rings against the fresh C++ golden.)
    """
    # Normal-incidence special case (cosThetaI > .9999).
    r = jnp.sqrt(-jnp.log1p(-jnp.minimum(u1, 1.0 - 1e-7)))
    phi = 2.0 * jnp.pi * u2
    sx_normal = r * jnp.cos(phi)
    sy_normal = r * jnp.sin(phi)

    cos_t = jnp.clip(cos_theta_i, -1.0, 1.0)
    sin_t = safe_sqrt(1.0 - cos_t * cos_t)
    tan_t = gsdiv(sin_t, jnp.maximum(cos_t, 1e-20))
    cot_t = gsdiv(jnp.ones_like(tan_t), jnp.maximum(tan_t, 1e-20))

    a = jnp.full_like(u1, -1.0)
    # ref_parity: the reference's Erf is NOT erf — a typo adds the
    # exponential instead of multiplying (core/approx.py:
    # erf_reference_buggy), inflating the bisection bound c above 1 and
    # visibly reshaping every Beckmann lobe. Golden parity must
    # reproduce it; the physically-correct estimator uses real erf.
    c = (erf_reference_buggy if ref_parity else erf_as)(cos_t)
    sample_x = jnp.maximum(u1, 1e-6)

    theta_i = acos_as(jnp.clip(cos_t, -0.999999, 0.999999))
    fit = 1.0 + theta_i * (-0.876 + theta_i * (0.4265 - 0.0594 * theta_i))
    b = c - (1.0 + c) * jnp.exp(
        fit * jnp.log(jnp.maximum(1.0 - sample_x, 1e-30)))

    normalization = 1.0 / (1.0 + c + _SQRT_PI_INV * tan_t
                           * jnp.exp(-cot_t * cot_t))

    done = jnp.zeros_like(u1, bool)
    for _ in range(9):                       # while (++it < 10)
        b = jnp.where(done | ((b >= a) & (b <= c)), b, 0.5 * (a + c))
        inv_erf = erfinv(b)
        value = (normalization
                 * (1.0 + b
                    + _SQRT_PI_INV * tan_t * jnp.exp(-inv_erf * inv_erf))
                 - sample_x)
        derivative = normalization * (1.0 - inv_erf * tan_t)
        upd = ~done & (jnp.abs(value) >= 1e-5)
        c = jnp.where(upd & (value > 0.0), b, c)
        a = jnp.where(upd & (value <= 0.0), b, a)
        step = gsdiv(value, jnp.where(jnp.abs(derivative) < 1e-20,
                                      jnp.sign(derivative) * 1e-20 + 1e-30,
                                      derivative))
        b = jnp.where(upd, b - step, b)
        done = done | (jnp.abs(value) < 1e-5)
    slope_x = erfinv(b)
    slope_y = erfinv(2.0 * jnp.maximum(u2, 1e-6) - 1.0)

    normal_inc = cos_theta_i > 0.9999
    return (jnp.where(normal_inc, sx_normal, slope_x),
            jnp.where(normal_inc, sy_normal, slope_y))


def sample_wh_visible(wo, alphax, alphay, u1, u2,
                      ref_parity: bool = False):
    """Visible-normal Beckmann sampling (microfacet_distribution.h:12-32,
    203-210): stretch, sample P22 slopes, rotate, unstretch, renormalize."""
    flip = wo[..., 2] < 0.0
    wi = jnp.where(flip[..., None], -wo, wo)

    stretched = jnp.stack([alphax * wi[..., 0], alphay * wi[..., 1],
                           wi[..., 2]], axis=-1)
    stretched = gsdiv(stretched, jnp.maximum(
        jnp.linalg.norm(stretched, axis=-1, keepdims=True), 1e-20))

    sx, sy = _beckmann_sample11(frame.cos_theta(stretched), u1, u2,
                                ref_parity=ref_parity)
    cp, sp = frame.cos_phi(stretched), frame.sin_phi(stretched)
    tmp = cp * sx - sp * sy
    sy = sp * sx + cp * sy
    sx = tmp
    sx = alphax * sx
    sy = alphay * sy

    wh = jnp.stack([-sx, -sy, jnp.ones_like(sx)], axis=-1)
    wh = wh / jnp.maximum(jnp.linalg.norm(wh, axis=-1, keepdims=True), 1e-20)
    return jnp.where(flip[..., None], -wh, wh)


def pdf_wh_visible(wo, wh, alphax, alphay):
    """VNDF density: D(wh) G1(wo) |wo.wh| / |cos(wo)|
    (microfacet_distribution.h:130-135, sampleVisibleArea branch)."""
    return gsdiv(beckmann_d(wh, alphax, alphay) * g1(wo, alphax, alphay)
                 * jnp.abs(jnp.sum(wo * wh, axis=-1)),
                 jnp.maximum(frame.abs_cos_theta(wo), 1e-8))
