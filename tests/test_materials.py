"""Material/pdf consistency tests (SURVEY §4): sample<->pdf agreement via
Monte-Carlo, Beckmann D normalization, energy conservation checks."""
import numpy as np
import jax.numpy as jnp

from srt.core.rng import RaySampler
from srt.materials import materials as mats
from srt.materials.microfacet import (beckmann_d, pdf_wh_visible,
                                          sample_wh_visible, g1)
from srt.scene.build import SceneBuilder, roughness_to_alpha


def _scene_with(mat_fn):
    b = SceneBuilder()
    mid = mat_fn(b)
    return b.build(), mid


def test_beckmann_d_normalizes():
    """∫ D(wh) cosθ dwh = 1 over the hemisphere (NDF property)."""
    rng = np.random.default_rng(0)
    n = 1 << 17
    # Uniform hemisphere sample.
    z = rng.uniform(0, 1, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    sq = np.sqrt(1 - z * z)
    wh = jnp.asarray(np.stack([sq * np.cos(phi), sq * np.sin(phi), z], -1),
                     jnp.float32)
    for rough in (0.1, 0.3, 0.8):
        a = roughness_to_alpha(rough)
        d = np.asarray(beckmann_d(wh, jnp.float32(a), jnp.float32(a)))
        est = (d * z).mean() * 2 * np.pi   # / uniform-pdf (1/2pi)
        assert abs(est - 1.0) < 0.05, (rough, est)


def test_beckmann_vndf_sample_pdf_consistency():
    """E[f(wh)] under sample_wh equals ∫ f * pdf via uniform MC."""
    n = 1 << 16
    rng = np.random.default_rng(1)
    ax = ay = jnp.float32(roughness_to_alpha(0.4))
    wo = jnp.asarray(np.broadcast_to(
        np.array([0.3, 0.1, 0.95]) / np.linalg.norm([0.3, 0.1, 0.95]),
        (n, 3)), jnp.float32)
    u1 = jnp.asarray(rng.uniform(1e-6, 1, n), jnp.float32)
    u2 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    wh = sample_wh_visible(wo, ax, ay, u1, u2)
    # Test statistic: mean of f(wh) = wh_z under the sampler.
    f_sampled = float(jnp.mean(wh[..., 2]))

    # Same expectation by uniform-hemisphere MC with the claimed pdf.
    z = rng.uniform(0, 1, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    sq = np.sqrt(1 - z * z)
    wh_u = jnp.asarray(np.stack([sq * np.cos(phi), sq * np.sin(phi), z], -1),
                       jnp.float32)
    pdf = np.asarray(pdf_wh_visible(wo[:1], wh_u, ax, ay))
    f_quad = float((np.asarray(wh_u[..., 2]) * pdf).mean() * 2 * np.pi)
    assert abs(f_sampled - f_quad) < 0.02, (f_sampled, f_quad)


def test_cosine_sample_matches_pdf():
    """sample_bsdf for Lambertian draws from cos/pi: check E[cos θ] = 2/3."""
    scene, mid = _scene_with(lambda b: b.lambertian(b.constant((1, 1, 1))))
    n = 1 << 16
    rng = np.random.default_rng(2)
    normal = jnp.asarray(np.broadcast_to([0.0, 0.0, 1.0], (n, 3)), jnp.float32)
    ray_dir = jnp.asarray(np.broadcast_to([0.0, 0.0, -1.0], (n, 3)), jnp.float32)
    mat = jnp.zeros((n,), jnp.int32) + mid
    u1 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    u2 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    wi = mats.sample_bsdf(scene, mat, normal, ray_dir, u1, u2)
    cos = np.asarray(wi[..., 2])
    assert np.all(cos >= -1e-6)
    assert abs(cos.mean() - 2.0 / 3.0) < 0.01
    # pdf at the samples is cos/pi.
    pdf = np.asarray(mats.bsdf_pdf(scene, mat, normal, ray_dir, wi))
    assert np.allclose(pdf, np.maximum(cos, 0) / np.pi, atol=1e-4)


def test_lambertian_weight_white_furnace():
    """∫ f cosθ dω = albedo: the weight/pdf ratio has expectation = albedo."""
    scene, mid = _scene_with(lambda b: b.lambertian(b.constant((0.7, 0.5, 0.3))))
    n = 1 << 16
    rng = np.random.default_rng(3)
    normal = jnp.asarray(np.broadcast_to([0.0, 0.0, 1.0], (n, 3)), jnp.float32)
    ray_dir = jnp.asarray(np.broadcast_to([0.0, 0.0, -1.0], (n, 3)), jnp.float32)
    mat = jnp.zeros((n,), jnp.int32) + mid
    u1 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    u2 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    wi = mats.sample_bsdf(scene, mat, normal, ray_dir, u1, u2)
    w = np.asarray(mats.bsdf_weight(scene, mat,
                                    jnp.zeros((n, 2)), jnp.zeros((n, 3)),
                                    normal, ray_dir, wi))
    pdf = np.asarray(mats.bsdf_pdf(scene, mat, normal, ray_dir, wi))
    est = (w / np.maximum(pdf, 1e-9)[:, None]).mean(axis=0)
    assert np.allclose(est, [0.7, 0.5, 0.3], atol=0.01), est


def test_beckmann_estimator_white_furnace():
    """Beckmann with F=1 loses only shadow-masking energy: estimator mean
    ∈ (0.6, 1.0] per channel, finite, non-negative."""
    scene, mid = _scene_with(
        lambda b: b.beckmann(b.constant((1.0, 1.0, 1.0)), 0.3, 0.3))
    n = 1 << 16
    rng = np.random.default_rng(4)
    normal = jnp.asarray(np.broadcast_to([0.0, 0.0, 1.0], (n, 3)), jnp.float32)
    d = np.array([0.4, 0.0, -0.9]); d /= np.linalg.norm(d)
    ray_dir = jnp.asarray(np.broadcast_to(d, (n, 3)), jnp.float32)
    mat = jnp.zeros((n,), jnp.int32) + mid
    u1 = jnp.asarray(rng.uniform(1e-6, 1, n), jnp.float32)
    u2 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    wi = mats.sample_bsdf(scene, mat, normal, ray_dir, u1, u2)
    w = np.asarray(mats.bsdf_weight(scene, mat, jnp.zeros((n, 2)),
                                    jnp.zeros((n, 3)), normal, ray_dir, wi))
    pdf = np.asarray(mats.bsdf_pdf(scene, mat, normal, ray_dir, wi))
    ok = pdf > 1e-8
    est = (w[ok] / pdf[ok, None]).mean(axis=0)
    assert np.all(np.isfinite(est))
    assert np.all(est > 0.6) and np.all(est < 1.05), est


def test_metal_mirror_reflection():
    scene, mid = _scene_with(lambda b: b.metal((0.9, 0.8, 0.7), fuzz=0.0))
    n = 4
    normal = jnp.asarray(np.broadcast_to([0.0, 1.0, 0.0], (n, 3)), jnp.float32)
    d = np.array([1.0, -1.0, 0.0]) / np.sqrt(2)
    ray_dir = jnp.asarray(np.broadcast_to(d, (n, 3)), jnp.float32)
    mat = jnp.zeros((n,), jnp.int32) + mid
    u = jnp.zeros((n, 4))
    out, att = mats.scatter_specular(scene, mat, jnp.zeros((n, 3)), normal,
                                     jnp.zeros((n, 2)), ray_dir, u)
    expect = np.array([1.0, 1.0, 0.0]) / np.sqrt(2)
    assert np.allclose(np.asarray(out), np.broadcast_to(expect, (n, 3)), atol=1e-5)
    assert np.allclose(np.asarray(att), [0.9, 0.8, 0.7], atol=1e-6)


def test_dielectric_straight_through_and_energy():
    scene, mid = _scene_with(lambda b: b.dielectric(1.5))
    n = 1 << 12
    rng = np.random.default_rng(5)
    normal = jnp.asarray(np.broadcast_to([0.0, 0.0, 1.0], (n, 3)), jnp.float32)
    ray_dir = jnp.asarray(np.broadcast_to([0.0, 0.0, -1.0], (n, 3)), jnp.float32)
    mat = jnp.zeros((n,), jnp.int32) + mid
    u = jnp.asarray(rng.uniform(0, 1, (n, 4)), jnp.float32)
    out, att = mats.scatter_specular(scene, mat, jnp.zeros((n, 3)), normal,
                                     jnp.zeros((n, 2)), ray_dir, u)
    out = np.asarray(out)
    # Normal incidence: refraction goes straight, reflection straight back.
    assert np.allclose(np.abs(out[:, 2]), 1.0, atol=1e-5)
    frac_reflected = (out[:, 2] > 0).mean()
    # Schlick R0 at n=1.5 is 4%.
    assert abs(frac_reflected - 0.04) < 0.02
    assert np.allclose(np.asarray(att), 1.0)


def test_emitted_one_sided():
    scene, mid = _scene_with(lambda b: b.diffuse_light(b.constant((5, 5, 5))))
    n = 2
    normal = jnp.asarray([[0.0, 0.0, 1.0]] * n, jnp.float32)
    # Ray 0 approaches against the normal (sees light), ray 1 from behind.
    rd = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0]], jnp.float32)
    mat = jnp.zeros((n,), jnp.int32) + mid
    e = np.asarray(mats.emitted(scene, mat, jnp.zeros((n, 2)),
                                jnp.zeros((n, 3)), normal, rd))
    assert np.allclose(e[0], 5.0) and np.allclose(e[1], 0.0)


def test_oren_nayar_sigma0_equals_lambertian():
    b = SceneBuilder()
    on = b.oren_nayar(b.constant((0.6, 0.6, 0.6)), 0.0)
    lam = b.lambertian(b.constant((0.6, 0.6, 0.6)))
    scene = b.build()
    n = 1 << 10
    rng = np.random.default_rng(6)
    normal = jnp.asarray(np.broadcast_to([0.0, 0.0, 1.0], (n, 3)), jnp.float32)
    ray_dir = jnp.asarray(np.broadcast_to([0.3, 0.2, -0.93], (n, 3)), jnp.float32)
    u1 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    u2 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    m_on = jnp.zeros((n,), jnp.int32) + on
    m_lam = jnp.zeros((n,), jnp.int32) + lam
    wi = mats.sample_bsdf(scene, m_on, normal, ray_dir, u1, u2)
    w_on = np.asarray(mats.bsdf_weight(scene, m_on, jnp.zeros((n, 2)),
                                       jnp.zeros((n, 3)), normal, ray_dir, wi))
    w_lam = np.asarray(mats.bsdf_weight(scene, m_lam, jnp.zeros((n, 2)),
                                        jnp.zeros((n, 3)), normal, ray_dir, wi))
    assert np.allclose(w_on, w_lam, atol=1e-5)


def test_ref_parity_estimator_formulas():
    """ref_parity (SceneFlags.ref_parity) swaps numerator/denominator like
    the reference: Beckmann weight = D*G1/(4 cosO) (material.h:160-185) with
    pdf = D*G/(4 cosI cosO) (pdf.h:133-140); Oren-Nayar weight = cos/pi
    (material.h:134-138) with the full A+B formula as pdf (pdf.h:64-101)."""
    from srt.core import frame
    from srt.materials.microfacet import beckmann_d, g, g1
    from srt.scene.ir import SceneFlags

    n = 1 << 12
    rng = np.random.default_rng(7)
    normal = jnp.asarray(np.broadcast_to([0.0, 0.0, 1.0], (n, 3)), jnp.float32)
    ray_dir = jnp.asarray(np.broadcast_to(
        np.array([0.4, 0.2, -0.8]) / np.linalg.norm([0.4, 0.2, -0.8]),
        (n, 3)), jnp.float32)
    u1 = jnp.asarray(rng.uniform(1e-6, 1, n), jnp.float32)
    u2 = jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
    uv = jnp.zeros((n, 2))
    p = jnp.zeros((n, 3))

    # --- Beckmann ---------------------------------------------------------
    # isotropic roughness: the recomputation below ignores the ONB's
    # azimuthal rotation, which only cancels when alphax == alphay
    scene, mid = _scene_with(
        lambda b: b.beckmann(b.constant((1.0, 1.0, 1.0)), 0.9, 0.9))
    mat = jnp.zeros((n,), jnp.int32) + mid
    flags = SceneFlags.of(scene)
    parity = flags._replace(ref_parity=True)
    wi = mats.sample_bsdf(scene, mat, normal, ray_dir, u1, u2, flags)

    w_par = np.asarray(mats.bsdf_weight(scene, mat, uv, p, normal, ray_dir,
                                        wi, parity))[:, 0]
    pdf_par = np.asarray(mats.bsdf_pdf(scene, mat, normal, ray_dir, wi,
                                       parity))
    # With the z-up frame, local == world here.
    wo = -ray_dir
    wh = wi + wo
    wh = wh / jnp.linalg.norm(wh, axis=-1, keepdims=True)
    ax = ay = scene.mat_params[mid, 0]
    want_w = np.asarray(beckmann_d(wh, ax, ay) * g1(wo, ax, ay)
                        / (4.0 * frame.abs_cos_theta(wo)))
    want_pdf = np.asarray(
        beckmann_d(wh, ax, ay) * g(wo, wi, ax, ay)
        / (4.0 * frame.abs_cos_theta(wi) * frame.abs_cos_theta(wo)))
    ok = np.asarray(frame.same_hemisphere(wo, wi))
    np.testing.assert_allclose(w_par[ok], want_w[ok], rtol=1e-4)
    np.testing.assert_allclose(pdf_par[ok], want_pdf[ok], rtol=1e-4)

    # Parity weight is >= the physically-correct one (G1 >= G, cosI <= 1)
    # up to the Lambda rational fit's tiny negative dip near a = 1.6 (same
    # dip as microfacet_distribution.h:172): the reference's soldier
    # renders *brighter* than the correct estimator.
    w_std = np.asarray(mats.bsdf_weight(scene, mat, uv, p, normal, ray_dir,
                                        wi, flags))[:, 0]
    assert np.all(w_par[ok] >= w_std[ok] * (1.0 - 1e-3))
    assert w_par[ok].mean() > w_std[ok].mean()

    # --- Oren-Nayar -------------------------------------------------------
    scene, mid = _scene_with(
        lambda b: b.oren_nayar(b.constant((1.0, 1.0, 1.0)), 20.0))
    mat = jnp.zeros((n,), jnp.int32) + mid
    flags = SceneFlags.of(scene)
    parity = flags._replace(ref_parity=True)
    wi = mats.sample_bsdf(scene, mat, normal, ray_dir, u1, u2, flags)
    cos_i = np.maximum(np.asarray(wi[..., 2]), 0.0)

    w_par = np.asarray(mats.bsdf_weight(scene, mat, uv, p, normal, ray_dir,
                                        wi, parity))[:, 0]
    np.testing.assert_allclose(w_par, cos_i / np.pi, rtol=1e-4, atol=1e-7)
    # pdf under parity carries the full O-N term = standard-mode weight.
    pdf_par = np.asarray(mats.bsdf_pdf(scene, mat, normal, ray_dir, wi,
                                       parity))
    w_std = np.asarray(mats.bsdf_weight(scene, mat, uv, p, normal, ray_dir,
                                        wi, flags))[:, 0]
    np.testing.assert_allclose(pdf_par, w_std, rtol=1e-4, atol=1e-7)
