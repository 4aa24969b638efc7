"""Next-event-estimation light sampling (the reference's ``hitable_pdf``).

The reference samples one light list (``hlist``) through
``hitable_pdf::generate -> xz_rect::random`` / ``sphere::random`` and weights
through ``hitable_list::pdf_value`` (uniform mixture over lights,
``hitable_list.h:54-67``). Lights here are references into the rect/sphere
tables; sampling/pdf are closed-form and vectorized. The light count is tiny
and static, so the per-light loop unrolls at trace time.
"""
from __future__ import annotations

import jax.numpy as jnp

from srt.core.onb import OrthonormalBasis
from srt.core.vecmath import dot, normalize, safe_sqrt, where3
from srt.render.intersect import _RECT_NAXIS, _RECT_UAXIS, _RECT_VAXIS
from srt.scene.ir import LightKind, Scene


def _rect_sample(scene: Scene, ridx: int, p, u1, u2):
    """Uniform area point on rect -> unit direction (``aarect.h:57-60``)."""
    b = scene.rect_bounds[ridx]
    k = scene.rect_k[ridx]
    axis = scene.rect_axis[ridx]
    pu = b[0] + u1 * (b[1] - b[0])
    pv = b[2] + u2 * (b[3] - b[2])
    na = jnp.take(_RECT_NAXIS, axis)
    ua = jnp.take(_RECT_UAXIS, axis)
    va = jnp.take(_RECT_VAXIS, axis)
    point = (jnp.zeros_like(p)
             .at[..., na].set(k)
             .at[..., ua].set(pu)
             .at[..., va].set(pv))
    return normalize(point - p)


def _rect_pdf(scene: Scene, ridx: int, p, wi):
    """Solid-angle pdf of the rect as seen from p (``aarect.h:45-55``)."""
    b = scene.rect_bounds[ridx]
    k = scene.rect_k[ridx]
    axis = scene.rect_axis[ridx]
    na = jnp.take(_RECT_NAXIS, axis)
    ua = jnp.take(_RECT_UAXIS, axis)
    va = jnp.take(_RECT_VAXIS, axis)
    d_n = wi[..., na]
    t = (k - p[..., na]) / jnp.where(jnp.abs(d_n) < 1e-12, 1e-12, d_n)
    hu = p[..., ua] + t * wi[..., ua]
    hv = p[..., va] + t * wi[..., va]
    inside = ((t > 1e-3) & (hu >= b[0]) & (hu <= b[1])
              & (hv >= b[2]) & (hv <= b[3]))
    area = (b[1] - b[0]) * (b[3] - b[2])
    cosine = jnp.abs(d_n)  # wi unit; |dot(wi, plane normal)|
    pdf = t * t / jnp.maximum(cosine * area, 1e-12)
    return jnp.where(inside, pdf, 0.0)


def _sphere_sample(scene: Scene, sidx: int, p, u1, u2):
    """Cone sampling toward the sphere (``sphere.h:7-15,80-86``).

    From *inside* the sphere (``dist_sq <= r^2`` — e.g. an emissive dome
    registered as an NEE light, ``env_sphere.h:40-48``) the cone degenerates,
    so those lanes sample the full sphere of directions uniformly
    (pdf 1/4pi, mirrored in :func:`_sphere_pdf`).
    """
    center = scene.sph_center0[sidx]
    radius = scene.sph_radius[sidx]
    to_c = center - p
    dist_sq = jnp.sum(to_c * to_c, axis=-1)
    inside = dist_sq <= radius * radius
    cos_max = safe_sqrt(1.0 - radius * radius
                        / jnp.maximum(dist_sq, 1e-12))
    z = jnp.where(inside, 1.0 - 2.0 * u2, 1.0 + u2 * (cos_max - 1.0))
    phi = 2.0 * jnp.pi * u1
    sq = safe_sqrt(1.0 - z * z)
    local = jnp.stack([jnp.cos(phi) * sq, jnp.sin(phi) * sq, z], axis=-1)
    return OrthonormalBasis.from_w(to_c).to_world(local)


def _sphere_pdf(scene: Scene, sidx: int, p, wi):
    """1/solid-angle if wi hits the sphere (``sphere.h:69-78``)."""
    center = scene.sph_center0[sidx]
    radius = scene.sph_radius[sidx]
    oc = p - center
    b = dot(oc, wi)
    c = jnp.sum(oc * oc, axis=-1) - radius * radius
    disc = b * b - c
    hits = disc > 0.0
    sqd = safe_sqrt(disc)
    t0 = -b - sqd
    t1 = -b + sqd
    hits = hits & ((t0 > 1e-3) | (t1 > 1e-3))
    cos_max = safe_sqrt(
        1.0 - radius * radius / jnp.maximum(c + radius * radius, 1e-12))
    solid = 2.0 * jnp.pi * (1.0 - cos_max)
    pdf = jnp.where(hits, 1.0 / jnp.maximum(solid, 1e-12), 0.0)
    # Inside the sphere every direction hits it: uniform 1/4pi (matches
    # _sphere_sample's inside branch).
    inside = c <= 0.0  # c = dist_sq - r^2
    return jnp.where(inside, 1.0 / (4.0 * jnp.pi), pdf)


def sample_lights(scene: Scene, p, u_pick, u1, u2):
    """Uniformly pick a light, sample a unit direction toward it
    (``hitable_list::random``, ``hitable_list.h:64-67``)."""
    n_lights = scene.n_lights
    pick = jnp.minimum((u_pick * n_lights).astype(jnp.int32), n_lights - 1)
    wi = jnp.zeros_like(p)
    for li in range(n_lights):
        kind = scene.light_kind[li]
        idx = scene.light_index[li]
        # Gate each family on its (static) table size: a gather into a
        # 0-row table is invalid in XLA even when masked out. Clamp the
        # index per family — a sphere light's idx may exceed the rect
        # table (the clamped lane is masked out by `kind` below), and
        # out-of-range gather behavior is an XLA implementation detail
        # we must not rely on.
        w_li = None
        if scene.n_rects:
            w_li = _rect_sample(scene, jnp.clip(idx, 0, scene.n_rects - 1),
                                p, u1, u2)
        if scene.n_spheres:
            w_sph = _sphere_sample(
                scene, jnp.clip(idx, 0, scene.n_spheres - 1), p, u1, u2)
            w_li = (w_sph if w_li is None
                    else where3(kind == LightKind.RECT, w_li, w_sph))
        if w_li is None:
            continue
        wi = where3(pick == li, w_li, wi)
    return wi


def lights_pdf(scene: Scene, p, wi):
    """Uniform-mixture solid-angle pdf over all lights
    (``hitable_list::pdf_value``, ``hitable_list.h:54-62``)."""
    n_lights = scene.n_lights
    if n_lights == 0:
        return jnp.zeros_like(p[..., 0])
    acc = jnp.zeros_like(p[..., 0])
    for li in range(n_lights):
        kind = scene.light_kind[li]
        idx = scene.light_index[li]
        pdf = None
        if scene.n_rects:
            pdf = _rect_pdf(scene, jnp.clip(idx, 0, scene.n_rects - 1), p, wi)
        if scene.n_spheres:
            s_pdf = _sphere_pdf(
                scene, jnp.clip(idx, 0, scene.n_spheres - 1), p, wi)
            pdf = (s_pdf if pdf is None
                   else jnp.where(kind == LightKind.RECT, pdf, s_pdf))
        if pdf is None:
            continue
        acc = acc + pdf
    return acc / n_lights
