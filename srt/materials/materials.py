"""Material table shading: emission, specular scatter, BSDF sample/pdf/weight.

Implements every material model of the reference (``material.h``) as masked
vectorized math over a wavefront of hits. Conventions:

* ``ray_dir`` — unit propagation direction of the incoming ray (the
  reference's ``r_in.direction()``).
* The shading frame is built about the *face* normal (geometric normal
  flipped toward the viewer), making diffuse models two-sided — the
  reference reaches the same goal through per-sample hemisphere flips in
  ``cosine_pdf::generate`` (``pdf.h:47-56``).
* The MIS estimator contract: for a diffuse bounce the integrator multiplies
  throughput by ``bsdf_weight(wi) / pdf_mix(wi)`` where ``bsdf_weight`` is
  f·|cosθi| (the reference's ``attenuation * scattering_pdf``,
  ``Raytracing_n.cpp:94``) and ``pdf_mix`` is the 0.5/0.5 light/BSDF mixture
  (``pdf.h:173-193``).

Documented deviations from reference *bugs* (SURVEY §7):
* correct cosine sampling (the reference's ``random_cosine_direction`` has a
  stray factor 2, ``pdf.h:15-16``, biasing the lobe toward grazing);
* consistent generate/value hemispheres (the reference's flip in
  ``pdf.h:49-52`` samples into the surface for front hits, so BSDF samples
  were always rejected and retried);
* Beckmann pdf/value are the true VNDF pair instead of the stateful
  side-channel of ``pdf.h:119-156``;
* Oren–Nayar's full A+B term multiplies the weight (f) rather than living in
  the pdf denominator (``pdf.h:64-101`` vs ``material.h:134-138``).
"""
from __future__ import annotations

import jax.numpy as jnp

from srt.core import frame
from srt.core.onb import OrthonormalBasis
from srt.core.vecmath import (dot, floor_clamp, gsdiv, normalize, reflect,
                              refract_dir, safe_normalize, where3)
from srt.materials import merl as merl_mod
from srt.materials.microfacet import (
    beckmann_d, g, g1, pdf_wh_visible, sample_wh_visible)
from srt.materials.textures import texture_value
from srt.scene.ir import MaterialType, Scene, has_mat, has_tex

_INV_PI = 1.0 / jnp.pi


def _mtype(scene: Scene, mat_id):
    return scene.mat_type[mat_id]


def albedo(scene: Scene, mat_id, uv, p, flags=None):
    """Texture-evaluated albedo/emission color for the hit."""
    return texture_value(scene, scene.mat_tex[mat_id], uv, p, flags)


def emitted(scene: Scene, mat_id, uv, p, normal, ray_dir, flags=None):
    """One-sided emission (``material.h:348-354``): emit only when the stored
    normal faces the incoming ray."""
    if not has_mat(flags, MaterialType.DIFFUSE_LIGHT):
        return jnp.zeros_like(p)
    is_light = _mtype(scene, mat_id) == MaterialType.DIFFUSE_LIGHT
    facing = dot(normal, ray_dir) < 0.0
    e = albedo(scene, mat_id, uv, p, flags)
    return jnp.where((is_light & facing)[..., None], e, 0.0)


def is_specular(scene: Scene, mat_id):
    """Materials that take the one-sample specular branch
    (``Raytracing_n.cpp:66-70``): metal, dielectric, isotropic."""
    t = _mtype(scene, mat_id)
    return ((t == MaterialType.METAL) | (t == MaterialType.DIELECTRIC)
            | (t == MaterialType.ISOTROPIC))


def is_scattering(scene: Scene, mat_id):
    """False only for pure emitters (scatter() returns false,
    ``material.h:344``)."""
    return _mtype(scene, mat_id) != MaterialType.DIFFUSE_LIGHT


def _uniform_in_sphere(u1, u2, u3):
    """Uniform point in the unit ball — exact inverse-CDF version of the
    rejection loop in ``material.h:43-50``."""
    z = 1.0 - 2.0 * u1
    phi = 2.0 * jnp.pi * u2
    r_xy = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    radius = jnp.cbrt(jnp.maximum(u3, 1e-12))
    return radius[..., None] * jnp.stack(
        [r_xy * jnp.cos(phi), r_xy * jnp.sin(phi), z], axis=-1)


def _schlick(cosine, ref_idx):
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * jnp.power(jnp.maximum(1.0 - cosine, 0.0), 5.0)


def scatter_specular(scene: Scene, mat_id, p, normal, uv, ray_dir, u4,
                     flags=None):
    """Specular-branch scatter. ``u4``: (N, 4) uniforms.

    Returns (new_dir unit, attenuation (N,3)). Statically skips specular
    models the scene lacks (the integrator masks this branch to specular
    lanes, so skipped lanes' values are never selected).
    """
    t = _mtype(scene, mat_id)
    params = scene.mat_params[mat_id]
    refl = reflect(ray_dir, normal)
    new_dir = refl
    atten = jnp.ones_like(p)

    if has_mat(flags, MaterialType.METAL):
        # METAL (material.h:243-261): mirror + fuzz ball.
        fuzz = params[..., 0]
        metal_dir = safe_normalize(
            refl + fuzz[..., None]
            * _uniform_in_sphere(u4[..., 0], u4[..., 1], u4[..., 2]))
        new_dir = where3(t == MaterialType.METAL, metal_dir, new_dir)
        alb = albedo(scene, mat_id, uv, p, flags)
        atten = where3(t == MaterialType.METAL, alb, atten)

    if has_mat(flags, MaterialType.DIELECTRIC):
        # DIELECTRIC (material.h:282-324): one-sided Schlick + refraction.
        # Clamped: non-dielectric lanes read garbage params, and ref_idx=0
        # would put 1/0=inf in the graph and NaN the backward pass.
        ref_idx = floor_clamp(params[..., 0], 1e-2)
        going_out = dot(ray_dir, normal) > 0.0
        outward_n = where3(going_out, -normal, normal)
        ni_over_nt = jnp.where(going_out, ref_idx, 1.0 / ref_idx)
        cosine = jnp.where(going_out, dot(ray_dir, normal),
                           -dot(ray_dir, normal))
        refracted, can_refract = refract_dir(ray_dir, outward_n, ni_over_nt)
        reflect_prob = jnp.where(can_refract, _schlick(cosine, ref_idx), 1.0)
        take_reflect = u4[..., 3] < reflect_prob
        diel_dir = normalize(where3(take_reflect, refl, refracted))
        new_dir = where3(t == MaterialType.DIELECTRIC, diel_dir, new_dir)

    if has_mat(flags, MaterialType.ISOTROPIC):
        # ISOTROPIC (material.h:359-369): uniform phase function.
        iso_dir = normalize(_uniform_in_sphere(u4[..., 0], u4[..., 1],
                                               jnp.ones_like(u4[..., 2])))
        new_dir = where3(t == MaterialType.ISOTROPIC, iso_dir, new_dir)
        alb = albedo(scene, mat_id, uv, p, flags)
        atten = where3(t == MaterialType.ISOTROPIC, alb, atten)

    return new_dir, atten


def _face_basis(normal, ray_dir):
    """ONB about the normal oriented toward the viewer."""
    n_face = where3(dot(normal, ray_dir) > 0.0, -normal, normal)
    return OrthonormalBasis.from_w(n_face)


def _oren_nayar_term(wi, wo, A, B):
    """cosI * (A + B*maxCos*sinAlpha*tanBeta) / pi — the full Oren-Nayar
    value (onrennayar_pdf::value, pdf.h:64-101) in local-frame vectors."""
    sin_ti, sin_to = frame.sin_theta(wi), frame.sin_theta(wo)
    d_cos = (frame.cos_phi(wi) * frame.cos_phi(wo)
             + frame.sin_phi(wi) * frame.sin_phi(wo))
    max_cos = jnp.where((sin_ti > 1e-4) & (sin_to > 1e-4),
                        jnp.maximum(0.0, d_cos), 0.0)
    abs_ci, abs_co = frame.abs_cos_theta(wi), frame.abs_cos_theta(wo)
    i_bigger = abs_ci > abs_co
    sin_alpha = jnp.where(i_bigger, sin_to, sin_ti)
    tan_beta = jnp.where(i_bigger, sin_ti / jnp.maximum(abs_ci, 1e-8),
                         sin_to / jnp.maximum(abs_co, 1e-8))
    cos_i = jnp.maximum(wi[..., 2], 0.0)
    return cos_i * (A + B * max_cos * sin_alpha * tan_beta) * _INV_PI


def sample_bsdf(scene: Scene, mat_id, normal, ray_dir, u1, u2, flags=None):
    """Importance-sample the diffuse-branch BSDF; returns world wi (unit).

    Cosine lobe for Lambertian / Oren–Nayar / MERL (``pdf.h:30-59``),
    Beckmann VNDF half-vector sampling for the microfacet
    (``pdf.h:136-152``; skipped statically when the scene has none).
    """
    basis = _face_basis(normal, ray_dir)
    t = _mtype(scene, mat_id)
    params = scene.mat_params[mat_id]

    # Cosine hemisphere (correct sqrt form; see module docstring).
    phi = 2.0 * jnp.pi * u1
    sq = jnp.sqrt(u2)
    cos_dir = jnp.stack([jnp.cos(phi) * sq, jnp.sin(phi) * sq,
                         jnp.sqrt(jnp.maximum(0.0, 1.0 - u2))], axis=-1)
    wi_local = cos_dir

    if has_mat(flags, MaterialType.BECKMANN):
        # Beckmann: VNDF wh then reflect. Alphas clamped: lanes whose
        # material is not Beckmann read garbage params (e.g. a light's
        # zeros), and alpha=0 creates inf partials that would NaN the
        # backward pass.
        parity = flags is not None and flags.ref_parity
        # ref parity: the reference builds the Beckmann frame from the
        # RAW stored normal (beckmann_pdf ctor, pdf.h:122-124 — no
        # face-forward flip). Identical for front hits; on backfacing /
        # grazing hits the frames differ, which ROTATES the anisotropy
        # ellipse — confirmed by a 48-case composition probe against the
        # C++ (GOLDEN.md r5) where the face-forward frame mismatched 15
        # cases including opposite SameHemisphere verdicts.
        b_basis = OrthonormalBasis.from_w(normal) if parity else basis
        wo = b_basis.to_local(-ray_dir)
        if parity:
            wo = normalize(wo)     # the reference unit_vector()s wwo
        ax = floor_clamp(params[..., 0], 1e-4)
        ay = floor_clamp(params[..., 1], 1e-4)
        wh = sample_wh_visible(wo, ax, ay, u1, u2, ref_parity=parity)
        beck_wi = frame.local_reflect(wo, wh)
        beck_world = normalize(b_basis.to_world(beck_wi))
        cos_world = normalize(basis.to_world(cos_dir))
        return where3(t == MaterialType.BECKMANN, beck_world, cos_world)

    return normalize(basis.to_world(wi_local))


def bsdf_pdf(scene: Scene, mat_id, normal, ray_dir, wi_world, flags=None):
    """Density of :func:`sample_bsdf` at an arbitrary direction (for MIS)."""
    basis = _face_basis(normal, ray_dir)
    t = _mtype(scene, mat_id)
    params = scene.mat_params[mat_id]
    wi = basis.to_local(wi_world)
    wo = basis.to_local(-ray_dir)

    parity = flags is not None and flags.ref_parity
    cos_pdf = jnp.maximum(wi[..., 2], 0.0) * _INV_PI
    pdf = cos_pdf

    if parity and has_mat(flags, MaterialType.OREN_NAYAR):
        # ref parity: the *pdf* carries the full O-N formula
        # (onrennayar_pdf::value, pdf.h:64-101) while the weight is plain
        # cos/pi — the reference's swap, reproduced for golden matching.
        A, B = params[..., 0], params[..., 1]
        pdf_on = _oren_nayar_term(wi, wo, A, B)
        pdf = jnp.where(t == MaterialType.OREN_NAYAR, pdf_on, pdf)

    if not has_mat(flags, MaterialType.BECKMANN):
        return pdf

    wh = safe_normalize(wi + wo)
    ax = floor_clamp(params[..., 0], 1e-4)
    ay = floor_clamp(params[..., 1], 1e-4)
    if parity:
        # beckmann_pdf::generate stores *pdf_value = D(wh) *
        # G(wo_WORLD, wi_LOCAL) / (4 cosI cosO) (pdf.h:144) — note the
        # mixed frames: G's first argument is the raw world-space
        # incoming direction r.direction(), whose z *world* component is
        # treated as cos(theta). Reproduced verbatim, in the RAW-normal
        # frame the reference builds (pdf.h:122-124 — no face-forward
        # flip; see sample_bsdf). This value is what the mixture reads on
        # the BSDF branch (where wi == the sampled reflect(wo, wh), so
        # evaluating at the actual wi is exact); the light branch instead
        # reads the heap slot — see the integrator's slot model.
        from srt.materials.microfacet import beckmann_lambda
        r_basis = OrthonormalBasis.from_w(normal)
        wi_r = r_basis.to_local(wi_world)
        wo_r = normalize(r_basis.to_local(-ray_dir))
        wh_r = safe_normalize(wi_r + wo_r)
        lam_world = beckmann_lambda(ray_dir, ax, ay)
        lam_i = beckmann_lambda(wi_r, ax, ay)
        g_mixed = 1.0 / (1.0 + lam_world + lam_i)
        beck = (beckmann_d(wh_r, ax, ay) * g_mixed
                / jnp.maximum(4.0 * frame.abs_cos_theta(wi_r)
                              * frame.abs_cos_theta(wo_r), 1e-8))
        beck = jnp.where(frame.same_hemisphere(wo_r, wi_r), beck, 0.0)
        return jnp.where(t == MaterialType.BECKMANN, beck, pdf)
    else:
        beck = gsdiv(pdf_wh_visible(wo, wh, ax, ay),
                     jnp.maximum(4.0 * jnp.abs(jnp.sum(wo * wh, axis=-1)),
                                 1e-8))
    beck = jnp.where(frame.same_hemisphere(wo, wi), beck, 0.0)

    return jnp.where(t == MaterialType.BECKMANN, beck, pdf)


def bsdf_weight(scene: Scene, mat_id, uv, p, normal, ray_dir, wi_world,
                flags=None):
    """f(wo, wi) * |cosθi| — the reference's attenuation*scattering_pdf."""
    basis = _face_basis(normal, ray_dir)
    t = _mtype(scene, mat_id)
    params = scene.mat_params[mat_id]
    alb = albedo(scene, mat_id, uv, p, flags)
    wi = basis.to_local(wi_world)
    wo = basis.to_local(-ray_dir)
    cos_i = jnp.maximum(wi[..., 2], 0.0)

    # LAMBERTIAN (material.h:100-105): albedo * cos/pi.
    w = cos_i * _INV_PI

    parity = flags is not None and flags.ref_parity

    if has_mat(flags, MaterialType.OREN_NAYAR) and not parity:
        # OREN_NAYAR full term (pdf.h:64-101), A/B precomputed at build.
        # (Under ref parity the full term lives in bsdf_pdf instead and the
        # weight is plain cos/pi, matching material.h:134-138.)
        A, B = params[..., 0], params[..., 1]
        w_on = _oren_nayar_term(wi, wo, A, B)
        w = jnp.where(t == MaterialType.OREN_NAYAR, w_on, w)

    if has_mat(flags, MaterialType.BECKMANN):
        wh = safe_normalize(wi + wo)
        ax = floor_clamp(params[..., 0], 1e-4)
        ay = floor_clamp(params[..., 1], 1e-4)
        if parity:
            # ref parity: scattering_pdf = Pdf(wo,wh)/(4 wo.wh)
            # = D*G1(wo)/(4 cosO) — the VNDF sampling density used as the
            # "BRDF" (material.h:160-185); no cosI, G1 not G; RAW-normal
            # frame (the onb is built from rec.normal, material.h:161-162
            # — see sample_bsdf). Note the reference's scattering_pdf has
            # NO same-hemisphere clamp (material.h:183-184 — only the
            # stored *pdf_value* zeroes on !SameHemisphere), and its
            # signed Pdf/(4 dot(wo,wh)) denominator is always positive
            # because dot(wo, wo+wi) = 1 + wo.wi >= 0 — so below-horizon
            # light samples keep their (tiny-D) positive weight.
            r_basis = OrthonormalBasis.from_w(normal)
            wi_r = normalize(r_basis.to_local(wi_world))
            wo_r = normalize(r_basis.to_local(-ray_dir))
            wh_r = safe_normalize(wi_r + wo_r)
            w_beck = (beckmann_d(wh_r, ax, ay) * g1(wo_r, ax, ay)
                      / jnp.maximum(4.0 * frame.abs_cos_theta(wo_r), 1e-8))
        else:
            # BECKMANN microfacet with F=1: D*G/(4 cosO cosI) * cosI.
            w_beck = gsdiv(beckmann_d(wh, ax, ay) * g(wo, wi, ax, ay),
                           jnp.maximum(4.0 * frame.abs_cos_theta(wo), 1e-8))
            w_beck = jnp.where(frame.same_hemisphere(wo, wi), w_beck, 0.0)
        w = jnp.where(t == MaterialType.BECKMANN, w_beck, w)

    weight = alb * w[..., None]

    # MERL measured BRDF: f from the Rusinkiewicz-indexed table, tinted by
    # the albedo texture (brdf.h:106-214; the reference's brdfmaterial
    # falls back to constant albedo, material.h:232).
    if scene.merl.shape[0] > 0:
        table_id = scene.mat_params[mat_id][..., 0].astype(jnp.int32)
        f_merl = merl_mod.lookup(scene.merl, table_id, wo, wi)
        w_merl = alb * f_merl * cos_i[..., None]
        weight = where3(t == MaterialType.MERL, w_merl, weight)
    return weight
