"""Fused per-bounce kernel: intersect + shade + NEE in one launch.

The XLA bounce (:func:`srt.render.integrator.bounce_step`) is a long chain
of fusions per ``while_loop`` iteration, each of which passes the
wavefront's ``(N, 3)`` lane state through device memory. This kernel runs
the entire bounce (sphere/rect closest-hit, emission, the Beckmann/
Lambertian/Oren-Nayar shading chain with mixture-PDF NEE, Russian
roulette) as ONE Pallas-Triton program per block of lanes, so every
intermediate stays in registers and the expensive Beckmann subexpressions
(``wh``, ``D``, ``Lambda``) are computed once and shared between sample,
pdf and weight — the fusion the reference's recursive estimator gets for
free inside a single C++ call tree (``Raytracing_n.cpp:55-106``).

Estimator-identical to :func:`srt.render.integrator.bounce_step`: the
same counter RNG streams (same dimension slots), the same intersection
order and tie-breaks, the same material math (``materials/materials.py``)
— images match the XLA path to float-associativity.

Layout (``pallas/common.py``): one lane per thread, ``BLOCK`` lanes per
program, lane state as 1-D arrays. The scene tables are whole arrays in
global memory that every lane of a block reads as the same scalar inside
the primitive/material loops (a dense sweep with broadcast primitives);
they are a few KB and stay in L1/L2.

Scope (gated statically by ``SceneFlags.fused_bounce``): sphere+rect
scenes, materials {lambertian, oren-nayar, beckmann, metal, dielectric,
diffuse_light}, constant/checker textures in-kernel, image textures on
emitters only — their atlas gather is *deferred*: the kernel emits
``(tex_id, u, v)`` and the caller adds ``beta * image(u, v)`` in XLA.
Triangles arrive as an external hit from the traversal kernel
(``pallas/intersect.py``). Everything else takes the XLA bounce.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from srt.core.vecmath import gsdiv as _gsdiv
from srt.core.vecmath import gsrecip as _gsrecip
from srt.core.vecmath import safe_sqrt as _grad_safe_sqrt
from srt.pallas.common import lane_call, pad_lanes, padded
from srt.scene.ir import LightKind, MaterialType, Scene, TextureType

_BIG = np.float32(3.0e38)
_T_POS_MAX = np.float32(1.0e7)
_U32 = jnp.uint32
_INV_PI = np.float32(1.0 / np.pi)
_SQRT_PI_INV = np.float32(0.5641895835477563)

# Sampler dimension slots — must match render/integrator.py.
_DIM_SPEC = 8
_DIM_MIX = 12
_DIM_LIGHT_PICK = 13
_DIM_SAMPLE = 14
_DIM_RR = 16
_DIM_RETRY = 17          # parity resample rounds (4 dims each)
_DIM_SLOT = 33           # parity heap-slot Bernoulli
_PARITY_RETRIES = 4      # = integrator._PARITY_RETRIES
_PARITY_SLOT_ZERO_P = np.float32(0.086)   # = integrator constants (the
_PARITY_KILL = np.float32(1e30)           # measured slot distribution)


def fused_bounce_available(flags, mode: str) -> bool:
    """Static dispatch gate: a kernel mode (``pallas/common.kernel_mode``)
    and a scene inside the kernel's scope (``SceneFlags.fused_bounce``).
    ref_parity runs in-kernel (the ``stale`` heap-slot carry and the
    as-implemented Beckmann/O-N variants are ported)."""
    return mode != "off" and flags is not None and flags.fused_bounce

# ---------------------------------------------------------------------------
# small component-wise vector helpers (tuples of lane arrays)
# ---------------------------------------------------------------------------

def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _scale3(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _add3(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _neg3(a):
    return (-a[0], -a[1], -a[2])


def _where3(m, a, b):
    return (jnp.where(m, a[0], b[0]), jnp.where(m, a[1], b[1]),
            jnp.where(m, a[2], b[2]))


def _normalize3(a):
    # exactly vecmath.normalize: reciprocal of the clamped length (rsqrt
    # rounds differently and decorrelates sample streams from XLA).
    # _grad_safe_sqrt: same value, no NaN tangent on exactly-zero vectors.
    inv = _gsrecip(jnp.maximum(_grad_safe_sqrt(_dot3(a, a)), 1e-20))
    return _scale3(a, inv)


def _safe_normalize3(a):
    # exactly vecmath.safe_normalize: +z fallback for degenerate input
    l2 = _dot3(a, a)
    ok = l2 > 1e-12
    inv_len = 1.0 / jnp.sqrt(jnp.where(ok, l2, 1.0))
    return (jnp.where(ok, a[0], 0.0) * inv_len,
            jnp.where(ok, a[1], 0.0) * inv_len,
            jnp.where(ok, a[2], 1.0) * inv_len)


def _axis_comp(vec, axis):
    """Component of ``vec`` selected by the (traced scalar) axis id."""
    return jnp.where(axis == 0.0, vec[0], jnp.where(axis == 1.0, vec[1],
                                                    vec[2]))


def _axis_compose(na, ua, va, vn, vu, vv):
    """Vector with value ``vn`` on axis ``na``, ``vu`` on ``ua``, ``vv`` on
    ``va`` (the three axis ids partition {0,1,2})."""
    out = []
    for c in (0.0, 1.0, 2.0):
        out.append(jnp.where(na == c, vn, jnp.where(ua == c, vu, vv)))
    return tuple(out)


# --- transcendental fallbacks ---------------------------------------------
# The shared reference-faithful fits in core/approx.py (common.h:26-78)
# are used on BOTH the XLA and kernel paths so their sample streams stay
# aligned.
from srt.core.approx import (acos_as as _acos_poly,          # noqa: E402
                             asin_as as _asin_poly,
                             atan2_poly as _atan2_poly,
                             cbrt_pos as _cbrt_pos,
                             erf_as as _erf_poly,
                             erf_reference_buggy as _erf_buggy,
                             erfinv_giles as _erfinv)


# --- counter RNG (exact port of core/rng.py on uint32 lanes) ---------------

def _mix(x):
    x = x ^ (x >> 16)
    x = x * _U32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * _U32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _hash_combine(a, b):
    return _mix(_mix(a) + (b ^ _U32(0x9E3779B9)))


def _uniform(salt, dim: int):
    bits = _hash_combine(
        salt, _U32((0xB5297A4D + 0x68E31DA4 * dim) & 0xFFFFFFFF))
    # the top-24-bit value fits in int32: bitcast (sign-safe), convert
    top = jax.lax.bitcast_convert_type(bits >> 8, jnp.int32)
    return top.astype(jnp.float32) * np.float32(1.0 / (1 << 24))


# --- local-frame trig (port of core/frame.py on component tuples) ----------

def _sin2_theta(w):
    return jnp.maximum(0.0, 1.0 - w[2] * w[2])


def _sin_theta(w):
    return _grad_safe_sqrt(1.0 - w[2] * w[2])


def _tan2_theta(w):
    return _gsdiv(_sin2_theta(w), jnp.maximum(w[2] * w[2], 1e-20))


def _cos_phi(w, st):
    return jnp.where(st == 0.0, 1.0,
                     jnp.clip(_gsdiv(w[0], jnp.maximum(st, 1e-20)),
                              -1.0, 1.0))


def _sin_phi(w, st):
    return jnp.where(st == 0.0, 0.0,
                     jnp.clip(_gsdiv(w[1], jnp.maximum(st, 1e-20)),
                              -1.0, 1.0))


def _beckmann_d(wh, ax, ay):
    """Anisotropic Beckmann NDF (materials/microfacet.py:beckmann_d)."""
    tan2 = jnp.minimum(_tan2_theta(wh), 1e8)
    cos2 = wh[2] * wh[2]
    cos4 = cos2 * cos2
    st = _sin_theta(wh)
    cp, sp = _cos_phi(wh, st), _sin_phi(wh, st)
    e = jnp.exp(-tan2 * (cp * cp / (ax * ax) + sp * sp / (ay * ay)))
    d = _gsdiv(e, np.float32(np.pi) * ax * ay * jnp.maximum(cos4, 1e-16))
    return jnp.where(tan2 < 1e8, d, 0.0)


def _beckmann_lambda(w, ax, ay):
    """Rational-approx Lambda (materials/microfacet.py:beckmann_lambda)."""
    c = w[2]
    st = _sin_theta(w)
    safe_c = jnp.where(jnp.abs(c) < 1e-8, jnp.sign(c) * 1e-8 + 1e-20, c)
    abs_tan = jnp.minimum(jnp.abs(st / safe_c), 1e8)
    cp, sp = _cos_phi(w, st), _sin_phi(w, st)
    alpha = jnp.sqrt(cp * cp * ax * ax + sp * sp * ay * ay)
    a = _gsdiv(jnp.float32(1.0) + 0.0 * abs_tan,
               jnp.maximum(alpha * abs_tan, 1e-16))
    a_safe = jnp.clip(a, 1e-4, 1.6)
    lam = ((1.0 - 1.259 * a_safe + 0.396 * a_safe * a_safe)
           / (3.535 * a_safe + 2.181 * a_safe * a_safe))
    return jnp.where(a > 1.6, 0.0, lam)


def _beckmann_sample11(cos_t_i, u1, u2, parity: bool = False):
    """Exact transcription of BeckmannSample11 (see
    materials/microfacet.py:_beckmann_sample11 — keep both in lockstep).
    ``parity`` selects the reference's broken Erf (common.h:40-44 typo)
    for as-implemented golden matching."""
    erfinv = _erfinv
    r = jnp.sqrt(-jnp.log1p(-jnp.minimum(u1, 1.0 - 1e-7)))
    phi = 2.0 * np.float32(np.pi) * u2
    sx_normal = r * jnp.cos(phi)
    sy_normal = r * jnp.sin(phi)

    cos_t = jnp.clip(cos_t_i, -1.0, 1.0)
    sin_t = _grad_safe_sqrt(1.0 - cos_t * cos_t)
    tan_t = _gsdiv(sin_t, jnp.maximum(cos_t, 1e-20))
    cot_t = _gsdiv(jnp.float32(1.0) + 0.0 * tan_t,
                   jnp.maximum(tan_t, 1e-20))

    a = jnp.full_like(u1, -1.0)
    c = (_erf_buggy if parity else _erf_poly)(cos_t)
    sample_x = jnp.maximum(u1, 1e-6)
    theta_i = _acos_poly(jnp.clip(cos_t, -0.999999, 0.999999))
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
        step = _gsdiv(value,
                      jnp.where(jnp.abs(derivative) < 1e-20,
                                jnp.sign(derivative) * 1e-20 + 1e-30,
                                derivative))
        b = jnp.where(upd, b - step, b)
        done = done | (jnp.abs(value) < 1e-5)
    slope_x = erfinv(b)
    slope_y = erfinv(2.0 * jnp.maximum(u2, 1e-6) - 1.0)
    normal_inc = cos_t_i > 0.9999
    return (jnp.where(normal_inc, sx_normal, slope_x),
            jnp.where(normal_inc, sy_normal, slope_y))


def _sample_wh_visible(wo, ax, ay, u1, u2, parity: bool = False):
    """VNDF Beckmann half-vector (materials/microfacet.py:sample_wh_visible)."""
    flip = wo[2] < 0.0
    wi = _where3(flip, _neg3(wo), wo)
    st = (ax * wi[0], ay * wi[1], wi[2])
    # divide (not multiply-by-reciprocal): a 1-ulp difference here flips
    # the cosThetaI > 0.9999 normal-incidence branch vs the XLA path
    nrm = jnp.maximum(jnp.sqrt(_dot3(st, st)), 1e-20)
    st = (_gsdiv(st[0], nrm), _gsdiv(st[1], nrm), _gsdiv(st[2], nrm))
    sx, sy = _beckmann_sample11(st[2], u1, u2, parity)
    s_t = _sin_theta(st)
    cp, sp = _cos_phi(st, s_t), _sin_phi(st, s_t)
    tmp = cp * sx - sp * sy
    sy = sp * sx + cp * sy
    sx = tmp
    sx = ax * sx
    sy = ay * sy
    whv = (-sx, -sy, jnp.ones_like(sx))
    nrm2 = jnp.maximum(jnp.sqrt(_dot3(whv, whv)), 1e-20)
    wh = (whv[0] / nrm2, whv[1] / nrm2, whv[2] / nrm2)
    return _where3(flip, _neg3(wh), wh)


def _sphere_uv(unit):
    """Spherical uv (render/intersect.py:_sphere_uv), NaN-safe poles."""
    x, y, z = unit
    r2 = x * x + z * z
    off_axis = r2 > 1e-12
    phi = _atan2_poly(jnp.where(off_axis, z, 0.0),
                      jnp.where(off_axis, x, 1.0))
    y = jnp.clip(y, -1.0, 1.0)
    inner = jnp.abs(y) < 0.999999
    theta = jnp.where(inner, _asin_poly(jnp.where(inner, y, 0.0)),
                      jnp.sign(y) * np.float32(0.5 * np.pi))
    u = 1.0 - (phi + np.float32(np.pi)) / np.float32(2.0 * np.pi)
    v = (theta + np.float32(np.pi / 2.0)) / np.float32(np.pi)
    return u, v


# ---------------------------------------------------------------------------
# kernel stages: primitive sweeps (fori loops over the scene tables),
# material resolve, media, shading
# ---------------------------------------------------------------------------

def _make_sphere_body(sph_ref, o, d, time, t_min, moving: bool):
    """Closest-hit sweep body over the sphere table. Carries select
    the *winner's* fields as the sweep goes; ties keep the first
    (lowest-index) primitive like the XLA argmin."""

    def body(s, carry):
        t_best, cx, cy, cz, r, flip, mat = carry
        c0 = (sph_ref[0, s], sph_ref[1, s], sph_ref[2, s])
        if moving:
            f = (time - sph_ref[6, s]) * sph_ref[7, s]
            cen = (c0[0] + f * sph_ref[3, s], c0[1] + f * sph_ref[4, s],
                   c0[2] + f * sph_ref[5, s])
        else:
            cen = c0
        rad = sph_ref[8, s]
        oc = _sub3(o, cen)
        b = _dot3(oc, d)
        c = _dot3(oc, oc) - rad * rad
        disc = b * b - c
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        t0, t1 = -b - sq, -b + sq
        ok = disc > 0.0
        t = jnp.where(ok & (t0 > t_min), t0,
                      jnp.where(ok & (t1 > t_min), t1, _BIG))
        # env_sphere always-hit at the far crossing (env_sphere.h:27-38,
        # intersect.py:117-120) — no discriminant test
        t = jnp.where(sph_ref[11, s] > 0.0,
                      jnp.where(t1 > t_min, t1, _BIG), t)
        better = t < t_best
        return (jnp.where(better, t, t_best),
                jnp.where(better, cen[0], cx),
                jnp.where(better, cen[1], cy),
                jnp.where(better, cen[2], cz),
                jnp.where(better, rad, r),
                jnp.where(better, sph_ref[10, s], flip),
                jnp.where(better, sph_ref[9, s], mat))

    return body


def _make_rect_body(rect_ref, o, d, t_min):
    """Closest-hit sweep body over the rect table (normal/uv computed
    in-loop)."""

    def body(rr, carry):
        t_best, nx, ny, nz, u, v, mat, is_rect = carry
        na, ua, va = rect_ref[0, rr], rect_ref[1, rr], rect_ref[2, rr]
        k = rect_ref[3, rr]
        a0, a1, b0, b1 = (rect_ref[4, rr], rect_ref[5, rr],
                          rect_ref[6, rr], rect_ref[7, rr])
        d_n = _axis_comp(d, na)
        o_n = _axis_comp(o, na)
        t = (k - o_n) / jnp.where(jnp.abs(d_n) < 1e-20, 1e-20, d_n)
        pu = _axis_comp(o, ua) + t * _axis_comp(d, ua)
        pv = _axis_comp(o, va) + t * _axis_comp(d, va)
        valid = ((pu >= a0) & (pu <= a1) & (pv >= b0) & (pv <= b1)
                 & (t > t_min))
        better = valid & (t < t_best)
        flip = rect_ref[9, rr]
        one = jnp.ones_like(t)
        return (jnp.where(better, t, t_best),
                jnp.where(better, jnp.where(na == 0.0, flip, 0.0) * one, nx),
                jnp.where(better, jnp.where(na == 1.0, flip, 0.0) * one, ny),
                jnp.where(better, jnp.where(na == 2.0, flip, 0.0) * one, nz),
                jnp.where(better, (pu - a0) / (a1 - a0), u),
                jnp.where(better, (pv - b0) / (b1 - b0), v),
                jnp.where(better, rect_ref[8, rr], mat),
                jnp.where(better, jnp.ones_like(is_rect), is_rect))

    return body


def _read_media(med_ref, n_media: int):
    """Hoist the media table into per-medium scalar lists."""
    return [[med_ref[j, m] for j in range(10)] for m in range(n_media)]


def _read_lights(light_ref, n_lights: int):
    return [[light_ref[j, li] for j in range(8)] for li in range(n_lights)]


def _media_sweep(salt, o, d, t_best, wn, w_u, w_v, w_mat, w_is_rect,
                 med_vals):
    """Participating media (integrator._apply_media, sphere/box analytic):
    a nearer stochastic in-scatter event overrides the hit."""
    w_nx, w_ny, w_nz = wn
    for m, mv in enumerate(med_vals):
        kind = mv[0]
        cen = (mv[1], mv[2], mv[3])
        rad = mv[4]
        half = (mv[5], mv[6], mv[7])
        dens = mv[8]
        oc = _sub3(o, cen)
        bq = _dot3(oc, d)
        cq = _dot3(oc, oc) - rad * rad
        disc = bq * bq - cq
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        s_in, s_out = -bq - sq, -bq + sq
        s_ok = disc > 0.0
        guarded = tuple(jnp.where(jnp.abs(dc) < 1e-20, 1e-20, dc)
                        for dc in d)
        inv = tuple(1.0 / g for g in guarded)
        tt0 = tuple((-h - c_) * iv for h, c_, iv in zip(half, oc, inv))
        tt1 = tuple((h - c_) * iv for h, c_, iv in zip(half, oc, inv))
        b_in = jnp.maximum(jnp.maximum(jnp.minimum(tt0[0], tt1[0]),
                                       jnp.minimum(tt0[1], tt1[1])),
                           jnp.minimum(tt0[2], tt1[2]))
        b_out = jnp.minimum(jnp.minimum(jnp.maximum(tt0[0], tt1[0]),
                                        jnp.maximum(tt0[1], tt1[1])),
                            jnp.maximum(tt0[2], tt1[2]))
        is_box = kind == 1.0
        t_in = jnp.where(is_box, b_in, s_in)
        t_out = jnp.where(is_box, b_out, s_out)
        ok_m = (is_box & (b_out > b_in)) | (~is_box & s_ok)
        t_enter = jnp.maximum(t_in, 0.0)
        t_exit = jnp.minimum(t_out, t_best)
        inside = ok_m & (t_exit > t_enter)
        um = jnp.maximum(_uniform(salt, m), 1e-12)   # _DIM_MEDIUM + m
        free = -jnp.log(um) / dens
        t_sc = t_enter + free
        mb = inside & (free < (t_exit - t_enter)) & (t_sc < t_best)
        t_best = jnp.where(mb, t_sc, t_best)
        w_nx = jnp.where(mb, 1.0, w_nx)
        w_ny = jnp.where(mb, 0.0, w_ny)
        w_nz = jnp.where(mb, 0.0, w_nz)
        w_u = jnp.where(mb, 0.0, w_u)
        w_v = jnp.where(mb, 0.0, w_v)
        w_mat = jnp.where(mb, mv[9], w_mat)
        w_is_rect = jnp.where(mb, 1.0, w_is_rect)
    return t_best, (w_nx, w_ny, w_nz), w_u, w_v, w_mat, w_is_rect


def _hit_frame(o, d, t_best, w_is_rect_f, w_cx, w_cy, w_cz, w_r, w_flip,
               w_nx, w_ny, w_nz):
    """Hit point, sphere unit vector, sanitized stored normal."""
    f32 = jnp.float32
    zero = jnp.zeros_like(o[0])
    w_is_rect = w_is_rect_f > 0.5
    hit = t_best < f32(1e30)
    p = _add3(o, _scale3(d, jnp.minimum(t_best, _T_POS_MAX)))

    # sphere lanes: stored normal from the winning center. The uv for
    # deferred image emission is NOT computed here — the kernel emits the
    # raw unit vector and the caller runs the exact _sphere_uv trig in
    # XLA (the in-kernel asin/atan2 polynomials flip ~2% of sky texels).
    inv_r = 1.0 / w_r
    unit = ((p[0] - w_cx) * inv_r, (p[1] - w_cy) * inv_r,
            (p[2] - w_cz) * inv_r)
    n_st = _where3(w_is_rect, (w_nx, w_ny, w_nz), _scale3(unit, w_flip))
    # miss-lane sanitation (integrator.py: zero normal -> +z, p -> origin)
    n_ok = hit & (_dot3(n_st, n_st) > 1e-12)
    n_st = _where3(n_ok, n_st, (zero, zero, jnp.ones_like(zero)))
    p = _where3(hit, p, o)
    return w_is_rect, hit, p, unit, n_st


def _resolve_material(mat_ref, w_mat, n_mat: int):
    """Per-lane material fields by sweeping the material table (primal)."""
    zero = jnp.zeros_like(w_mat)
    f32 = jnp.float32

    def mat_body(m, carry):
        (mt, p0, p1, p2, p3, tt, c0, c1, c2, d0, d1, d2, ti) = carry
        sel = w_mat == m.astype(f32)
        return (jnp.where(sel, mat_ref[0, m], mt),
                jnp.where(sel, mat_ref[1, m], p0),
                jnp.where(sel, mat_ref[2, m], p1),
                jnp.where(sel, mat_ref[3, m], p2),
                jnp.where(sel, mat_ref[4, m], p3),
                jnp.where(sel, mat_ref[5, m], tt),
                jnp.where(sel, mat_ref[6, m], c0),
                jnp.where(sel, mat_ref[7, m], c1),
                jnp.where(sel, mat_ref[8, m], c2),
                jnp.where(sel, mat_ref[9, m], d0),
                jnp.where(sel, mat_ref[10, m], d1),
                jnp.where(sel, mat_ref[11, m], d2),
                jnp.where(sel, mat_ref[13, m], ti))

    return jax.lax.fori_loop(
        0, n_mat, mat_body,
        (zero, zero, zero, zero, zero, zero, zero, zero, zero, zero, zero,
         zero, zero - 1.0))


def _shade_core(o, d, beta, radiance, alive, depth, salt,
                p, unit, n_st, hit, w_is_rect, w_u, w_v,
                m_type, m_p0, m_p1, m_p2, m_p3, m_textype, m_c, m_c2,
                m_timg, light_vals, stale_in, *,
                mat_kinds: tuple, tex_kinds: tuple, light_kinds: tuple,
                max_depth: int, rr_start: int, pdf_floor: float,
                parity: bool, parity_no_stale: bool):
    """Everything after closest-hit: albedo, emission, specular, the
    mixture-PDF NEE diffuse chain, merge + roulette, as jnp math on lane
    arrays (``light_vals`` is the hoisted light table). Returns
    ``(radiance, out_o, out_d, out_b, new_alive, dtex_tag_i32, du, dv, dw,
    stale_out)``."""
    f32 = jnp.float32
    zero = jnp.zeros_like(o[0])
    has = lambda k: int(k) in mat_kinds                       # noqa: E731
    has_beck = has(MaterialType.BECKMANN)
    has_on = has(MaterialType.OREN_NAYAR)
    has_metal = has(MaterialType.METAL)
    has_diel = has(MaterialType.DIELECTRIC)
    has_iso = has(MaterialType.ISOTROPIC)
    any_specular = has_metal or has_diel or has_iso
    has_checker = int(TextureType.CHECKER) in tex_kinds

    # texture color (constant / checker) — texture_value math. NOISE and
    # IMAGE textures on *scattering* materials are DEFERRED: the kernel
    # shades with albedo 1 and the caller multiplies the texture value
    # into beta afterwards (the same trick as deferred image emission —
    # atlas gathers and Perlin permutation gathers belong in XLA).
    if has_checker:
        sines = (jnp.sin(10.0 * p[0]) * jnp.sin(10.0 * p[1])
                 * jnp.sin(10.0 * p[2]))
        is_chk = m_textype == f32(int(TextureType.CHECKER))
        alb = _where3(is_chk & (sines < 0.0), m_c2, m_c)
    else:
        alb = m_c
    is_img = m_textype == f32(int(TextureType.IMAGE))
    is_noise = m_textype == f32(int(TextureType.NOISE))
    defer_tex = is_img | is_noise
    one3 = (jnp.ones_like(zero),) * 3
    alb = _where3(defer_tex, one3, alb)

    # --- emission (one-sided, material.h:348-354) -------------------------
    is_light = m_type == f32(int(MaterialType.DIFFUSE_LIGHT))
    facing = _dot3(n_st, d) < 0.0
    emit_lane = alive & hit & is_light & facing
    emit_now = emit_lane & ~defer_tex
    radiance = _add3(radiance,
                     _where3(emit_now, (beta[0] * alb[0], beta[1] * alb[1],
                                        beta[2] * alb[2]),
                             (zero, zero, zero)))
    scatters = hit & ~is_light
    # deferred texture evaluation: caller computes the texture in XLA.
    # Tag encoding: tex_id*4 | (albedo? 2 : 0) | (rect-style uv? 1 : 0);
    # -1 = nothing deferred. Emission lanes add beta*tex to radiance,
    # albedo lanes multiply tex into the outgoing beta.
    defer_emit = emit_lane & defer_tex
    defer_alb = alive & scatters & defer_tex
    tag = (m_timg * 4.0 + jnp.where(defer_alb, 2.0, 0.0)
           + jnp.where(w_is_rect, 1.0, 0.0))
    dtex_v = jnp.where(defer_emit | defer_alb, tag,
                       -1.0).astype(jnp.int32)
    du_v = jnp.where(w_is_rect, w_u, unit[0])
    dv_v = jnp.where(w_is_rect, w_v, unit[1])
    dw_v = unit[2]

    # --- specular branch (metal / dielectric) -----------------------------
    ddn = _dot3(d, n_st)
    refl = _sub3(d, _scale3(n_st, 2.0 * ddn))
    if any_specular:
        u_s = [_uniform(salt, _DIM_SPEC + i) for i in range(4)]
        spec_dir = refl
        spec_att = (jnp.ones_like(zero),) * 3
        if has_metal:
            # metal fuzz ball (materials.py:_uniform_in_sphere exact form)
            zz = 1.0 - 2.0 * u_s[0]
            phi = 2.0 * np.float32(np.pi) * u_s[1]
            r_xy = jnp.sqrt(jnp.maximum(0.0, 1.0 - zz * zz))
            radius = _cbrt_pos(jnp.maximum(u_s[2], 1e-12))
            ball = (radius * r_xy * jnp.cos(phi),
                    radius * r_xy * jnp.sin(phi), radius * zz)
            fuzz = m_p0
            mdir = _safe_normalize3(_add3(refl, _scale3(ball, fuzz)))
            is_metal = m_type == f32(int(MaterialType.METAL))
            spec_dir = _where3(is_metal, mdir, spec_dir)
            spec_att = _where3(is_metal, alb, spec_att)
        if has_diel:
            ref_idx = jnp.maximum(m_p0, 1e-2)
            going_out = ddn > 0.0
            out_n = _where3(going_out, _neg3(n_st), n_st)
            ni_over_nt = jnp.where(going_out, ref_idx, 1.0 / ref_idx)
            cosine = jnp.where(going_out, ddn, -ddn)
            # refract (vecmath.refract_dir math)
            dt = _dot3(d, out_n)
            disc_r = 1.0 - ni_over_nt * ni_over_nt * (1.0 - dt * dt)
            can = disc_r > 0.0
            sq_r = _grad_safe_sqrt(disc_r)
            refr = _sub3(_scale3(_sub3(d, _scale3(out_n, dt)), ni_over_nt),
                         _scale3(out_n, sq_r))
            r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
            r0 = r0 * r0
            omc = jnp.maximum(1.0 - cosine, 0.0)
            omc2 = omc * omc
            schlick = r0 + (1.0 - r0) * omc2 * omc2 * omc
            reflect_prob = jnp.where(can, schlick, 1.0)
            take_refl = u_s[3] < reflect_prob
            ddir = _normalize3(_where3(take_refl, refl, refr))
            is_diel = m_type == f32(int(MaterialType.DIELECTRIC))
            spec_dir = _where3(is_diel, ddir, spec_dir)
        if has_iso:
            # uniform phase function (materials.py scatter_specular ISO)
            zz2 = 1.0 - 2.0 * u_s[0]
            phi2 = 2.0 * np.float32(np.pi) * u_s[1]
            rxy2 = jnp.sqrt(jnp.maximum(0.0, 1.0 - zz2 * zz2))
            idir = _normalize3((rxy2 * jnp.cos(phi2),
                                rxy2 * jnp.sin(phi2), zz2))
            is_iso = m_type == f32(int(MaterialType.ISOTROPIC))
            spec_dir = _where3(is_iso, idir, spec_dir)
            spec_att = _where3(is_iso, alb, spec_att)
        spec_mask = zero < -1.0
        if has_iso:
            spec_mask = spec_mask | (m_type
                                     == f32(int(MaterialType.ISOTROPIC)))
        if has_metal:
            spec_mask = spec_mask | (m_type == f32(int(MaterialType.METAL)))
        if has_diel:
            spec_mask = spec_mask | (m_type
                                     == f32(int(MaterialType.DIELECTRIC)))
        specular = scatters & spec_mask
    else:
        specular = scatters & (zero < -1.0)
        spec_dir = d
        spec_att = (zero, zero, zero)

    # --- diffuse branch: mixture-PDF NEE ---------------------------------
    # face-forward shading basis (materials.py:_face_basis / core/onb.py).
    # from_w normalizes its input — sphere normals (p-c)/r are only
    # approximately unit, and skipping this skews directions by ~1e-4.
    nf = _normalize3(_where3(ddn > 0.0, _neg3(n_st), n_st))
    w_ax = _where3(jnp.abs(nf[0]) > 0.9,
                   (zero, jnp.ones_like(zero), zero),
                   (jnp.ones_like(zero), zero, zero))
    bv = _normalize3(_cross3(nf, w_ax))
    bu = _cross3(nf, bv)

    wo = (-_dot3(d, bu), -_dot3(d, bv), -_dot3(d, nf))
    n_lights = len(light_kinds)
    if has_beck:
        b_ax = jnp.maximum(m_p0, 1e-4)
        b_ay = jnp.maximum(m_p1, 1e-4)
        is_beck = m_type == f32(int(MaterialType.BECKMANN))
        if parity:
            # ref parity: the Beckmann frame is built from the RAW stored
            # normal (pdf.h:122-124, no face-forward flip) — identical on
            # front hits, rotates the anisotropy ellipse on backfacing /
            # grazing hits (materials.sample_bsdf; 48-case composition
            # probe vs the C++, GOLDEN.md r5)
            nr = _normalize3(n_st)
            w_ax2 = _where3(jnp.abs(nr[0]) > 0.9,
                            (zero, jnp.ones_like(zero), zero),
                            (jnp.ones_like(zero), zero, zero))
            bv_b = _normalize3(_cross3(nr, w_ax2))
            bu_b = _cross3(nr, bv_b)
            nf_b = nr
            wo_b = _normalize3((-_dot3(d, bu_b), -_dot3(d, bv_b),
                                -_dot3(d, nf_b)))
        else:
            bu_b, bv_b, nf_b, wo_b = bu, bv, nf, wo

    def sample_bsdf_dir(u1, u2):
        """materials.py:sample_bsdf — cosine lobe; Beckmann lanes VNDF."""
        phi_c = 2.0 * np.float32(np.pi) * u1
        sq_c = jnp.sqrt(u2)
        cosd = (jnp.cos(phi_c) * sq_c, jnp.sin(phi_c) * sq_c,
                jnp.sqrt(jnp.maximum(0.0, 1.0 - u2)))
        cos_world = _normalize3(_add3(_add3(_scale3(bu, cosd[0]),
                                            _scale3(bv, cosd[1])),
                                      _scale3(nf, cosd[2])))
        if not has_beck:
            return cos_world
        wh_s = _sample_wh_visible(wo_b, b_ax, b_ay, u1, u2, parity)
        beck_wi = _add3(_neg3(wo_b),
                        _scale3(wh_s, 2.0 * _dot3(wo_b, wh_s)))
        beck_world = _normalize3(_add3(_add3(_scale3(bu_b, beck_wi[0]),
                                             _scale3(bv_b, beck_wi[1])),
                                       _scale3(nf_b, beck_wi[2])))
        return _where3(is_beck, beck_world, cos_world)

    def sample_light_dir(u1, u2, u_pick):
        """lights.py:sample_lights, unrolled static kinds."""
        pick = jnp.minimum((u_pick * n_lights).astype(jnp.int32),
                           n_lights - 1)
        light_dir = (zero, zero, zero)
        for li, kind in enumerate(light_kinds):
            lv = light_vals[li]
            if kind == int(LightKind.RECT):
                na, ua, va = lv[0], lv[1], lv[2]
                k = lv[3]
                a0, a1, b0, b1 = lv[4], lv[5], lv[6], lv[7]
                pu = a0 + u1 * (a1 - a0)
                pv = b0 + u2 * (b1 - b0)
                point = _axis_compose(na, ua, va, k + zero, pu, pv)
                wl = _normalize3(_sub3(point, p))
            else:  # SPHERE: cone sampling (lights.py:_sphere_sample)
                cen = (lv[0], lv[1], lv[2])
                rad = lv[3]
                to_c = _sub3(cen, p)
                dist_sq = _dot3(to_c, to_c)
                inside = dist_sq <= rad * rad
                cmx = _grad_safe_sqrt(
                    1.0 - rad * rad / jnp.maximum(dist_sq, 1e-12))
                zq = jnp.where(inside, 1.0 - 2.0 * u2,
                               1.0 + u2 * (cmx - 1.0))
                phi_l = 2.0 * np.float32(np.pi) * u1
                sq_l = _grad_safe_sqrt(1.0 - zq * zq)
                lw = _normalize3(to_c)
                la = _where3(jnp.abs(lw[0]) > 0.9,
                             (zero, jnp.ones_like(zero), zero),
                             (jnp.ones_like(zero), zero, zero))
                lv_ = _normalize3(_cross3(lw, la))
                lu = _cross3(lw, lv_)
                local = (jnp.cos(phi_l) * sq_l, jnp.sin(phi_l) * sq_l, zq)
                wl = _add3(_add3(_scale3(lu, local[0]),
                                 _scale3(lv_, local[1])),
                           _scale3(lw, local[2]))
            light_dir = _where3(pick == li, wl, light_dir)
        return light_dir

    def lights_pdf_at(wi):
        """lights.py:lights_pdf — uniform mixture over lights."""
        lpdf = zero
        for li, kind in enumerate(light_kinds):
            lv = light_vals[li]
            if kind == int(LightKind.RECT):
                na, ua, va = lv[0], lv[1], lv[2]
                k = lv[3]
                a0, a1, b0, b1 = lv[4], lv[5], lv[6], lv[7]
                d_n = _axis_comp(wi, na)
                t_l = ((k - _axis_comp(p, na))
                       / jnp.where(jnp.abs(d_n) < 1e-12, 1e-12, d_n))
                hu = _axis_comp(p, ua) + t_l * _axis_comp(wi, ua)
                hv = _axis_comp(p, va) + t_l * _axis_comp(wi, va)
                inside_l = ((t_l > 1e-3) & (hu >= a0) & (hu <= a1)
                            & (hv >= b0) & (hv <= b1))
                area = (a1 - a0) * (b1 - b0)
                pdf_l = t_l * t_l / jnp.maximum(jnp.abs(d_n) * area, 1e-12)
                lpdf += jnp.where(inside_l, pdf_l, 0.0)
            else:  # lights.py:_sphere_pdf
                cen = (lv[0], lv[1], lv[2])
                rad = lv[3]
                oc = _sub3(p, cen)
                b_l = _dot3(oc, wi)
                c_l = _dot3(oc, oc) - rad * rad
                disc_l = b_l * b_l - c_l
                hits = disc_l > 0.0
                sq_d = _grad_safe_sqrt(disc_l)
                hits = hits & ((-b_l - sq_d > 1e-3) | (-b_l + sq_d > 1e-3))
                cmx = _grad_safe_sqrt(
                    1.0 - rad * rad / jnp.maximum(c_l + rad * rad, 1e-12))
                solid = 2.0 * np.float32(np.pi) * (1.0 - cmx)
                pdf_l = jnp.where(hits, 1.0 / jnp.maximum(solid, 1e-12),
                                  0.0)
                pdf_l = jnp.where(c_l <= 0.0,
                                  np.float32(1.0 / (4.0 * np.pi)), pdf_l)
                lpdf += pdf_l
        return lpdf / np.float32(n_lights)

    def oren_nayar_term(wil):
        """full A+B term at local wi (materials.py:_oren_nayar_term)."""
        sin_ti, sin_to = _sin_theta(wil), _sin_theta(wo)
        cp_i, sp_i = _cos_phi(wil, sin_ti), _sin_phi(wil, sin_ti)
        cp_o, sp_o = _cos_phi(wo, sin_to), _sin_phi(wo, sin_to)
        d_cos = cp_i * cp_o + sp_i * sp_o
        max_cos = jnp.where((sin_ti > 1e-4) & (sin_to > 1e-4),
                            jnp.maximum(0.0, d_cos), 0.0)
        abs_ci, abs_co = jnp.abs(wil[2]), jnp.abs(wo[2])
        i_bigger = abs_ci > abs_co
        sin_alpha = jnp.where(i_bigger, sin_to, sin_ti)
        tan_beta = jnp.where(i_bigger,
                             sin_ti / jnp.maximum(abs_ci, 1e-8),
                             sin_to / jnp.maximum(abs_co, 1e-8))
        return (jnp.maximum(wil[2], 0.0)
                * (m_p0 + m_p1 * max_cos * sin_alpha * tan_beta) * _INV_PI)

    u_mix = _uniform(salt, _DIM_MIX)
    u_pick = _uniform(salt, _DIM_LIGHT_PICK)
    u1 = _uniform(salt, _DIM_SAMPLE)
    u2 = _uniform(salt, _DIM_SAMPLE + 1)

    if not parity:
        stale_out = stale_in
        bsdf_dir = sample_bsdf_dir(u1, u2)
        if n_lights:
            light_dir = sample_light_dir(u1, u2, u_pick)
            pick_light = u_mix < 0.5
            wi = _where3(pick_light, light_dir, bsdf_dir)
            lpdf = lights_pdf_at(wi)
        else:
            wi = bsdf_dir
            lpdf = None

        # BSDF pdf + weight at wi — shared wh / D / Lambda subexpressions
        wil = (_dot3(wi, bu), _dot3(wi, bv), _dot3(wi, nf))
        cos_i = jnp.maximum(wil[2], 0.0)
        cos_pdf = cos_i * _INV_PI
        bpdf = cos_pdf
        wgt = cos_i * _INV_PI          # lambertian f*cos
        if has_on:
            on = oren_nayar_term(wil)
            wgt = jnp.where(m_type == f32(int(MaterialType.OREN_NAYAR)),
                            on, wgt)
        if has_beck:
            wh = _safe_normalize3(_add3(wil, wo))
            dD = _beckmann_d(wh, b_ax, b_ay)
            lam_o = _beckmann_lambda(wo, b_ax, b_ay)
            lam_i = _beckmann_lambda(wil, b_ax, b_ay)
            same_h = wil[2] * wo[2] > 0.0
            abs_woz = jnp.maximum(jnp.abs(wo[2]), 1e-8)
            g1_o = 1.0 / (1.0 + lam_o)
            # pdf: VNDF density / (4 |wo.wh|)  — the |wo.wh| cancels
            beck_pdf = _gsdiv(
                _gsdiv(dD * g1_o * jnp.abs(_dot3(wo, wh)), abs_woz),
                jnp.maximum(4.0 * jnp.abs(_dot3(wo, wh)), 1e-8))
            beck_pdf = jnp.where(same_h, beck_pdf, 0.0)
            bpdf = jnp.where(is_beck, beck_pdf, bpdf)
            # weight: D * G / (4 |woz|) (f * cos, materials.py:bsdf_weight)
            g_full = 1.0 / (1.0 + lam_o + lam_i)
            beck_w = _gsdiv(dD * g_full, jnp.maximum(4.0 * abs_woz, 1e-8))
            beck_w = jnp.where(same_h, beck_w, 0.0)
            wgt = jnp.where(is_beck, beck_w, wgt)

        pdf = 0.5 * lpdf + 0.5 * bpdf if n_lights else bpdf
    else:
        # --- ref-parity draw (integrator.bounce_step parity block):
        # diffuse lobes become light-sampling-only (the reference's
        # surface-flipped cosine/O-N generate() + while(pdf==0) retry,
        # pdf.h:47-110, Raytracing_n.cpp:79-83), the Beckmann mixture
        # term on the light branch reads the heap-recycled *previous*
        # Beckmann draw's pdf (the ``stale`` carry), and zero-pdf draws
        # resample on fresh dimensions for _PARITY_RETRIES rounds.
        is_lamb = m_type == f32(int(MaterialType.LAMBERTIAN))
        is_on_m = m_type == f32(int(MaterialType.OREN_NAYAR))
        light_only = is_lamb | is_on_m

        def bpdf_parity_at(wiw):
            """materials.bsdf_pdf under ref_parity at a world direction."""
            wil = (_dot3(wiw, bu), _dot3(wiw, bv), _dot3(wiw, nf))
            pdf_v = jnp.maximum(wil[2], 0.0) * _INV_PI
            if has_on:
                # parity: the *pdf* carries the full O-N formula
                pdf_v = jnp.where(is_on_m, oren_nayar_term(wil), pdf_v)
            if has_beck:
                # beckmann_pdf::generate's stored value (pdf.h:144):
                # D(wh) * G(wo_WORLD, wi_LOCAL) / (4 cosI cosO) — the
                # mixed frames are the reference's, reproduced verbatim
                # in its RAW-normal Beckmann frame
                wil_b = _normalize3((_dot3(wiw, bu_b), _dot3(wiw, bv_b),
                                     _dot3(wiw, nf_b)))
                wh = _safe_normalize3(_add3(wil_b, wo_b))
                dD = _beckmann_d(wh, b_ax, b_ay)
                lam_world = _beckmann_lambda(d, b_ax, b_ay)
                lam_i = _beckmann_lambda(wil_b, b_ax, b_ay)
                g_mixed = 1.0 / (1.0 + lam_world + lam_i)
                beck = dD * g_mixed / jnp.maximum(
                    4.0 * jnp.abs(wil_b[2]) * jnp.abs(wo_b[2]), 1e-8)
                beck = jnp.where(wil_b[2] * wo_b[2] > 0.0, beck, 0.0)
                pdf_v = jnp.where(is_beck, beck, pdf_v)
            return pdf_v

        # per-bounce heap-slot init (integrator.bounce_step: the slot
        # never survives the bounce boundary — free() clobbers it with
        # the tcache link; 8.6% zero pages, else contribution-killing
        # garbage). The carried stale plane is inert and kept only for
        # state-shape compatibility.
        u_slot = _uniform(salt, _DIM_SLOT)
        if parity_no_stale:
            stale = zero
        else:
            stale = jnp.where(u_slot < _PARITY_SLOT_ZERO_P, zero,
                              jnp.full_like(zero, _PARITY_KILL))
        wi = (zero, zero, jnp.ones_like(zero))
        pdf = zero
        need = zero > -1.0          # all lanes draw in round 0
        for rnd in range(1 + _PARITY_RETRIES):
            if rnd == 0:
                um, up = u_mix, u_pick
                v1, v2 = u1, u2
            else:
                base = _DIM_RETRY + 4 * (rnd - 1)
                um = _uniform(salt, base)
                up = _uniform(salt, base + 1)
                v1 = _uniform(salt, base + 2)
                v2 = _uniform(salt, base + 3)
            b_dir = sample_bsdf_dir(v1, v2)
            if len(light_kinds):
                l_dir = sample_light_dir(v1, v2, up)
                pick_light = (um < 0.5) | light_only
                wi_r = _where3(pick_light, l_dir, b_dir)
                bpdf_r = bpdf_parity_at(wi_r)
                bpdf_samp = bpdf_parity_at(b_dir)
                took_bsdf = is_beck & ~pick_light if has_beck \
                    else zero > 1.0
                stale_new = jnp.where(took_bsdf, bpdf_samp, stale)
                bpdf_use = jnp.where(is_beck & pick_light, stale,
                                     bpdf_r) \
                    if has_beck else bpdf_r
                pdf_r = 0.5 * lights_pdf_at(wi_r) + 0.5 * bpdf_use
            else:
                wi_r = b_dir
                pdf_r = bpdf_parity_at(wi_r)
                stale_new = stale
            wi = _where3(need, wi_r, wi)
            pdf = jnp.where(need, pdf_r, pdf)
            stale = jnp.where(need, stale_new, stale)
            need = need & (pdf <= 0.0)
        stale_out = stale

        # weight at the final wi (materials.bsdf_weight under ref_parity:
        # diffuse lobes plain cos/pi, Beckmann = the VNDF sampling
        # density D*G1(wo)/(4 cosO) used as the BRDF, material.h:160-185,
        # in its RAW-normal frame — and NO same-hemisphere clamp: the
        # reference's scattering_pdf has none, only its stored
        # *pdf_value* zeroes on !SameHemisphere)
        wil = (_dot3(wi, bu), _dot3(wi, bv), _dot3(wi, nf))
        cos_i = jnp.maximum(wil[2], 0.0)
        wgt = cos_i * _INV_PI
        if has_beck:
            wil_b = _normalize3((_dot3(wi, bu_b), _dot3(wi, bv_b),
                                 _dot3(wi, nf_b)))
            wh = _safe_normalize3(_add3(wil_b, wo_b))
            dD = _beckmann_d(wh, b_ax, b_ay)
            lam_o = _beckmann_lambda(wo_b, b_ax, b_ay)
            abs_woz = jnp.maximum(jnp.abs(wo_b[2]), 1e-8)
            beck_w = (dD * (1.0 / (1.0 + lam_o))
                      / jnp.maximum(4.0 * abs_woz, 1e-8))
            wgt = jnp.where(is_beck, beck_w, wgt)

    okp = pdf > pdf_floor
    inv_pdf = 1.0 / jnp.maximum(pdf, pdf_floor)
    scale = jnp.where(okp, wgt * inv_pdf, 0.0)
    diff_beta = _scale3(alb, scale)

    # --- merge branches, roulette, outputs --------------------------------
    new_dir = _where3(specular, spec_dir, wi)
    beta_scale = _where3(specular, spec_att, diff_beta)
    new_beta = (beta[0] * beta_scale[0], beta[1] * beta_scale[1],
                beta[2] * beta_scale[2])
    beta_max = jnp.maximum(jnp.maximum(new_beta[0], new_beta[1]),
                           new_beta[2])
    new_alive = alive & scatters & (beta_max > 0.0)
    if rr_start < max_depth:
        q = jnp.clip(beta_max, 0.05, 1.0)
        do_rr = depth >= rr_start
        survive = _uniform(salt, _DIM_RR) < q
        new_alive = new_alive & (~do_rr | survive)
        keep = do_rr & new_alive
        new_beta = _where3(keep, _scale3(new_beta, 1.0 / q), new_beta)

    upd = alive & scatters
    out_o = _where3(upd, p, o)
    out_d = _where3(upd, new_dir, d)
    out_b = _where3(alive, new_beta, beta)
    return (radiance, out_o, out_d, out_b, new_alive, dtex_v,
            du_v, dv_v, dw_v, stale_out)


def _kernel(sph_ref, rect_ref, mat_ref, light_ref, med_ref, *rest,
            n_sph: int, n_rect: int, n_mat: int, n_media: int,
            has_ext: bool, light_kinds: tuple,
            mat_kinds: tuple, tex_kinds: tuple, moving: bool,
            max_depth: int, rr_start: int, pdf_floor: float,
            parity: bool = False, parity_no_stale: bool = False):
    # operand unpacking: optional external-hit lanes precede the state
    i = 0
    if has_ext:
        (ext_t_ref, ext_nx_ref, ext_ny_ref, ext_nz_ref, ext_u_ref,
         ext_v_ref, ext_mat_ref) = rest[i:i + 7]
        i += 7
    (ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, time_ref,
     bx_ref, by_ref, bz_ref, rx_ref, ry_ref, rz_ref,
     salt_ref, depth_ref, alive_ref) = rest[i:i + 16]
    i += 16
    if parity:
        stale_ref = rest[i]
        i += 1
    (oxo, oyo, ozo, dxo, dyo, dzo, bxo, byo, bzo, rxo, ryo, rzo,
     alive_o, dtex_o, du_o, dv_o, dw_o) = rest[i:i + 17]
    i += 17
    if parity:
        stale_o = rest[i]
    f32 = jnp.float32
    o = (ox_ref[...], oy_ref[...], oz_ref[...])
    d = (dx_ref[...], dy_ref[...], dz_ref[...])
    beta = (bx_ref[...], by_ref[...], bz_ref[...])
    radiance = (rx_ref[...], ry_ref[...], rz_ref[...])
    alive = alive_ref[...] != 0
    depth = depth_ref[...]
    time = time_ref[...] if moving else None
    t_min = f32(1e-3)

    # per-lane sampler stream for this bounce
    salt = _hash_combine(salt_ref[...],
                         jax.lax.bitcast_convert_type(depth, _U32))

    # --- closest hit over spheres ---------------------------------------
    zero = jnp.zeros_like(o[0])
    t_best = jnp.full_like(o[0], _BIG)
    w_cx, w_cy, w_cz = zero, zero, zero        # sphere center (win)
    w_r = jnp.ones_like(o[0])                  # sphere radius (win)
    w_flip = jnp.ones_like(o[0])               # stored-normal sign
    w_mat = zero                               # material id (f32)
    w_is_rect = zero                           # 0/1 as f32

    if n_sph:
        t_best, w_cx, w_cy, w_cz, w_r, w_flip, w_mat = jax.lax.fori_loop(
            0, n_sph, _make_sphere_body(sph_ref, o, d, time, t_min, moving),
            (t_best, w_cx, w_cy, w_cz, w_r, w_flip, w_mat))

    # --- closest hit over rects (normal/uv computed in-loop) -------------
    w_nx, w_ny, w_nz = zero, zero, zero
    w_u, w_v = zero, zero

    if n_rect:
        (t_best, w_nx, w_ny, w_nz, w_u, w_v, w_mat,
         w_is_rect) = jax.lax.fori_loop(
            0, n_rect, _make_rect_body(rect_ref, o, d, t_min),
            (t_best, w_nx, w_ny, w_nz, w_u, w_v, w_mat, w_is_rect))

    # --- external hit (triangles, from the traversal kernel): behaves
    # like a rect lane — normal/uv/mat given ----------------------------
    if has_ext:
        et = ext_t_ref[...]
        eb = et < t_best
        t_best = jnp.where(eb, et, t_best)
        w_nx = jnp.where(eb, ext_nx_ref[...], w_nx)
        w_ny = jnp.where(eb, ext_ny_ref[...], w_ny)
        w_nz = jnp.where(eb, ext_nz_ref[...], w_nz)
        w_u = jnp.where(eb, ext_u_ref[...], w_u)
        w_v = jnp.where(eb, ext_v_ref[...], w_v)
        w_mat = jnp.where(eb, ext_mat_ref[...], w_mat)
        w_is_rect = jnp.where(eb, 1.0, w_is_rect)

    # --- participating media (a nearer in-scatter event overrides) -------
    if n_media:
        med_vals = _read_media(med_ref, n_media)
        (t_best, (w_nx, w_ny, w_nz), w_u, w_v, w_mat,
         w_is_rect) = _media_sweep(salt, o, d, t_best, (w_nx, w_ny, w_nz),
                                   w_u, w_v, w_mat, w_is_rect, med_vals)

    w_is_rect, hit, p, unit, n_st = _hit_frame(
        o, d, t_best, w_is_rect, w_cx, w_cy, w_cz, w_r, w_flip,
        w_nx, w_ny, w_nz)

    # --- material resolve -------------------------------------------------
    (m_type, m_p0, m_p1, m_p2, m_p3, m_textype, c0_, c1_, c2_, d0_, d1_,
     d2_, m_timg) = _resolve_material(mat_ref, w_mat, n_mat)
    m_c = (c0_, c1_, c2_)
    m_c2 = (d0_, d1_, d2_)

    # --- shading -----------------------------------------------------------
    light_vals = _read_lights(light_ref, len(light_kinds))
    stale_in = stale_ref[...] if parity else None
    (radiance, out_o, out_d, out_b, new_alive, dtex_v, du_v, dv_v, dw_v,
     stale_out) = _shade_core(
        o, d, beta, radiance, alive, depth, salt,
        p, unit, n_st, hit, w_is_rect, w_u, w_v,
        m_type, m_p0, m_p1, m_p2, m_p3, m_textype, m_c, m_c2, m_timg,
        light_vals, stale_in,
        mat_kinds=mat_kinds, tex_kinds=tex_kinds, light_kinds=light_kinds,
        max_depth=max_depth, rr_start=rr_start, pdf_floor=pdf_floor,
        parity=parity, parity_no_stale=parity_no_stale)
    dtex_o[...] = dtex_v
    du_o[...] = du_v
    dv_o[...] = dv_v
    dw_o[...] = dw_v
    if parity:
        stale_o[...] = stale_out

    oxo[...], oyo[...], ozo[...] = out_o
    dxo[...], dyo[...], dzo[...] = out_d
    bxo[...], byo[...], bzo[...] = out_b
    rxo[...], ryo[...], rzo[...] = radiance
    alive_o[...] = (new_alive & alive).astype(jnp.int32)


# ---------------------------------------------------------------------------
# XLA-side wrapper
# ---------------------------------------------------------------------------


def _build_tables(scene: Scene, flags):
    """Flatten scene SoA into the kernel's scalar tables (all f32)."""
    f32 = jnp.float32
    S, R, Mt = scene.n_spheres, scene.n_rects, scene.mat_type.shape[0]
    from srt.render.intersect import (_RECT_NAXIS, _RECT_UAXIS,
                                          _RECT_VAXIS)
    if S:
        dt = jnp.maximum(scene.sph_times[:, 1] - scene.sph_times[:, 0],
                         1e-20)
        # stored-normal sign: flip_normals XOR env (env domes shade with
        # the inward normal — intersect.py:290)
        flip_sign = jnp.where(scene.sph_flip ^ scene.sph_env,
                              -1.0, 1.0).astype(f32)
        sph = jnp.concatenate([
            scene.sph_center0.astype(f32),
            (scene.sph_center1 - scene.sph_center0).astype(f32),
            scene.sph_times[:, 0:1].astype(f32),
            (1.0 / dt)[:, None].astype(f32),
            scene.sph_radius[:, None].astype(f32),
            scene.sph_mat[:, None].astype(f32),
            flip_sign[:, None],
            scene.sph_env.astype(f32)[:, None],   # always-hit env dome
        ], axis=1)                                               # (S, 12)
    else:
        sph = jnp.zeros((1, 12), f32)
    if R:
        na = jnp.take(jnp.asarray(_RECT_NAXIS), scene.rect_axis)
        ua = jnp.take(jnp.asarray(_RECT_UAXIS), scene.rect_axis)
        va = jnp.take(jnp.asarray(_RECT_VAXIS), scene.rect_axis)
        rflip = jnp.where(scene.rect_flip, -1.0, 1.0).astype(f32)
        rect = jnp.stack([
            na.astype(f32), ua.astype(f32), va.astype(f32),
            scene.rect_k.astype(f32),
            scene.rect_bounds[:, 0].astype(f32),
            scene.rect_bounds[:, 1].astype(f32),
            scene.rect_bounds[:, 2].astype(f32),
            scene.rect_bounds[:, 3].astype(f32),
            scene.rect_mat.astype(f32), rflip,
        ], axis=1)                                               # (R, 10)
    else:
        rect = jnp.zeros((1, 10), f32)
    tex = scene.mat_tex
    mat = jnp.concatenate([
        scene.mat_type[:, None].astype(f32),
        scene.mat_params.astype(f32),
        scene.tex_type[tex][:, None].astype(f32),
        scene.tex_color[tex].astype(f32),
        scene.tex_color2[tex].astype(f32),
        jnp.zeros((Mt, 1), f32),            # (reserved: noise scale)
        tex[:, None].astype(f32),           # image tex id (deferred emit)
    ], axis=1)                                                   # (Mt, 14)
    rows = []
    for li, kind in enumerate(flags.light_kinds):
        idx = scene.light_index[li]
        if kind == int(LightKind.RECT):
            ic = jnp.clip(idx, 0, max(R - 1, 0))
            rows.append(jnp.stack([
                jnp.take(jnp.asarray(_RECT_NAXIS),
                         scene.rect_axis[ic]).astype(f32),
                jnp.take(jnp.asarray(_RECT_UAXIS),
                         scene.rect_axis[ic]).astype(f32),
                jnp.take(jnp.asarray(_RECT_VAXIS),
                         scene.rect_axis[ic]).astype(f32),
                scene.rect_k[ic].astype(f32),
                scene.rect_bounds[ic, 0].astype(f32),
                scene.rect_bounds[ic, 1].astype(f32),
                scene.rect_bounds[ic, 2].astype(f32),
                scene.rect_bounds[ic, 3].astype(f32),
            ]))
        else:
            ic = jnp.clip(idx, 0, max(scene.n_spheres - 1, 0))
            rows.append(jnp.concatenate([
                scene.sph_center0[ic].astype(f32),
                scene.sph_radius[ic][None].astype(f32),
                jnp.zeros((4,), f32),
            ]))
    light = (jnp.stack(rows) if rows else jnp.zeros((1, 8), f32))
    if scene.n_media:
        med = jnp.stack([
            scene.med_kind.astype(f32),
            scene.med_center[:, 0].astype(f32),
            scene.med_center[:, 1].astype(f32),
            scene.med_center[:, 2].astype(f32),
            scene.med_radius.astype(f32),
            scene.med_half[:, 0].astype(f32),
            scene.med_half[:, 1].astype(f32),
            scene.med_half[:, 2].astype(f32),
            scene.med_density.astype(f32),
            scene.med_mat.astype(f32),
        ], axis=1)                                              # (M, 10)
    else:
        med = jnp.zeros((1, 10), f32)
    # (fields, entries): the kernel reads field j of entry s as ref[j, s]
    return sph.T, rect.T, mat.T, light.T, med.T


def fused_bounce(scene: Scene, state: dict, max_depth: int, rr_start: int,
                 flags, pdf_floor: float = 1e-9, mode: str = "gpu"):
    """Drop-in for :func:`srt.render.integrator.bounce_step` on scenes
    gated by ``SceneFlags.fused_bounce``. ``mode`` is ``"gpu"`` or
    ``"interpret"`` (``pallas/common.kernel_mode``). Differentiable engines
    wrap it in the custom-VJP hybrid (pallas/bounce_vjp.py)."""
    n = state["o"].shape[0]
    n_pad = padded(n)

    def lane_f(x, fill=0.0):
        return pad_lanes(x, n_pad, jnp.float32, fill)

    o, d = state["o"], state["d"]
    beta, radiance = state["beta"], state["radiance"]
    has_ext = scene.n_tris > 0
    ext = []
    if has_ext:
        # triangles are intersected by the traversal kernel and fed in as
        # an external hit
        from srt.core.ray import Ray
        from srt.render.intersect import intersect_tris_any
        tri_hit = intersect_tris_any(
            scene, Ray(origin=o, direction=d, time=state["time"]),
            1e-3, _BIG, flags, mode=mode)
        ext = [lane_f(jnp.where(tri_hit.hit, tri_hit.t, _BIG), _BIG),
               lane_f(tri_hit.normal[:, 0]),
               lane_f(tri_hit.normal[:, 1]),
               lane_f(tri_hit.normal[:, 2]),
               lane_f(tri_hit.uv[:, 0]), lane_f(tri_hit.uv[:, 1]),
               lane_f(tri_hit.mat.astype(jnp.float32))]
    parity = bool(flags.ref_parity)
    ins = ext + [
        lane_f(o[:, 0]), lane_f(o[:, 1]), lane_f(o[:, 2]),
        lane_f(d[:, 0]), lane_f(d[:, 1]), lane_f(d[:, 2], 1.0),
        lane_f(state["time"]),
        lane_f(beta[:, 0]), lane_f(beta[:, 1]), lane_f(beta[:, 2]),
        lane_f(radiance[:, 0]), lane_f(radiance[:, 1]),
        lane_f(radiance[:, 2]),
        pad_lanes(state["salt"], n_pad, jnp.uint32),
        pad_lanes(state["depth"], n_pad, jnp.int32),
        pad_lanes(state["alive"], n_pad, jnp.int32),
    ]
    if parity:
        ins.append(lane_f(state["stale"]))     # heap-recycled pdf slot

    kernel = functools.partial(
        _kernel,
        n_sph=int(scene.n_spheres), n_rect=int(scene.n_rects),
        n_mat=int(scene.mat_type.shape[0]), n_media=int(scene.n_media),
        has_ext=has_ext, light_kinds=tuple(flags.light_kinds),
        mat_kinds=tuple(flags.mat_kinds), tex_kinds=tuple(flags.tex_kinds),
        moving=bool(flags.moving), max_depth=int(max_depth),
        rr_start=int(rr_start), pdf_floor=float(pdf_floor),
        parity=parity,
        parity_no_stale=bool(getattr(flags, "parity_no_stale", False)))

    f32, i32 = jnp.float32, jnp.int32
    out_dtypes = [f32] * 12 + [i32, i32, f32, f32, f32] + (
        [f32] if parity else [])
    outs = lane_call(kernel, list(_build_tables(scene, flags)), ins,
                     out_dtypes, mode=mode, name="fused_bounce")

    (ox, oy, oz, dx, dy, dz, bx, by, bz, rx, ry, rz,
     alive_o, dtex, du, dv, dw) = [a[:n] for a in outs[:17]]

    radiance_out = jnp.stack([rx, ry, rz], axis=-1)
    o_out = jnp.stack([ox, oy, oz], axis=-1)
    beta_out = jnp.stack([bx, by, bz], axis=-1)
    # deferred texture evaluation (image atlas gathers, Perlin marble):
    # tag = tex_id*4 | (albedo ? 2 : 0) | (rect-uv ? 1 : 0). Emission
    # lanes add beta_in * tex to radiance; albedo lanes shaded with
    # albedo 1 in-kernel, so multiply tex into the outgoing beta.
    needs_defer = (int(TextureType.IMAGE) in flags.tex_kinds
                   or int(TextureType.NOISE) in flags.tex_kinds)
    if needs_defer:
        radiance_out, beta_out = _deferred_texture(
            scene, flags, dtex, du, dv, dw,
            o_out, state["beta"], radiance_out, beta_out)

    out = dict(
        o=o_out,
        d=jnp.stack([dx, dy, dz], axis=-1),
        time=state["time"],
        beta=beta_out,
        radiance=radiance_out,
        alive=alive_o != 0,
        salt=state["salt"],
        depth=state["depth"] + 1,
    )
    if parity:
        out["stale"] = outs[17][:n]
    return out



def _deferred_texture(scene: Scene, flags, dtex, du, dv, dw, o_out,
                      beta_in, radiance_out, beta_out):
    """Evaluate the kernel's deferred-texture tags in XLA -> updated
    (radiance, beta), all flat (N, ...) arrays.

    Tag = tex_id*4 | (albedo ? 2 : 0) | (rect-uv ? 1 : 0); -1 = nothing
    deferred. Emission lanes add ``beta_in * tex`` to radiance; albedo
    lanes were shaded with albedo 1 in-kernel, so the texture multiplies
    into the outgoing beta. Without NOISE in the scene every deferred tag
    is an IMAGE lookup, evaluated full-width (3 gathers/lane; env-image
    scenes tag most of the wavefront, where compaction would only add
    overhead). With NOISE, the Perlin marble (7 octaves x 8 corners x 4
    gathers/lane — it alone halved ``final``'s throughput full-width,
    PERF.md) makes the whole deferred evaluation run on the
    stream-compacted tagged lanes (textures.texture_value_compact; exact
    full-width fallback above 1/8 wavefront occupancy). The hit position
    for Perlin: ``o_out`` IS the hit point on scatter lanes (the only
    lanes that can carry an albedo deferral).
    """
    from srt.render.intersect import _sphere_uv
    mask = dtex >= 0
    is_alb = (dtex & 2) == 2
    tex_id = jnp.clip(dtex >> 2, 0, scene.tex_type.shape[0] - 1)
    is_rect = (dtex & 1) == 1
    unit = jnp.stack([du, dv, dw], axis=-1)
    sph_uv = _sphere_uv(unit)
    u = jnp.where(is_rect, du, sph_uv[..., 0])
    v = jnp.where(is_rect, dv, sph_uv[..., 1])
    uv = jnp.stack([u, v], axis=-1)
    if int(TextureType.NOISE) in flags.tex_kinds:
        from srt.materials.textures import texture_value_compact
        cap = -(-max(256, dtex.shape[0] // 8) // 128) * 128
        col = texture_value_compact(scene, tex_id, uv, o_out, flags,
                                    mask, cap)
    else:
        from srt.materials.textures import _image_value
        col = _image_value(scene, tex_id, u, v)
    radiance_out = radiance_out + jnp.where((mask & ~is_alb)[:, None],
                                            beta_in * col, 0.0)
    beta_out = jnp.where((mask & is_alb)[:, None], beta_out * col, beta_out)
    return radiance_out, beta_out
