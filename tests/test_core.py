"""Unit tests for L0: vec math, ONB, RNG, Sobol (SURVEY §4 'Unit')."""
import numpy as np
import jax.numpy as jnp

from srt.core.vecmath import (cross, de_nan, dot, length, normalize,
                                  reflect, refract_dir)
from srt.core.onb import OrthonormalBasis
from srt.core.rng import RaySampler, bits_to_uniform, hash_combine
from srt.core.sobol import sobol_points


def test_normalize_unit_length():
    v = np.random.default_rng(0).normal(size=(128, 3)).astype(np.float32)
    n = np.asarray(normalize(jnp.asarray(v)))
    assert np.allclose(np.linalg.norm(n, axis=-1), 1.0, atol=1e-5)


def test_normalize_zero_safe():
    out = np.asarray(normalize(jnp.zeros((4, 3))))
    assert np.all(np.isfinite(out))


def test_reflect_mirror():
    v = jnp.asarray([[1.0, -1.0, 0.0]])
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    r = np.asarray(reflect(v, n))
    assert np.allclose(r, [[1.0, 1.0, 0.0]], atol=1e-6)


def test_refract_snell_and_tir():
    # Straight-through at normal incidence.
    v = jnp.asarray([[0.0, -1.0, 0.0]])
    n = jnp.asarray([[0.0, 1.0, 0.0]])
    refr, ok = refract_dir(v, n, jnp.asarray([1.0 / 1.5]))
    assert bool(ok[0])
    assert np.allclose(np.asarray(refr), [[0.0, -1.0, 0.0]], atol=1e-5)
    # Total internal reflection at grazing exit from dense medium.
    v = normalize(jnp.asarray([[1.0, -0.1, 0.0]]))
    refr, ok = refract_dir(v, n, jnp.asarray([1.5]))
    assert not bool(ok[0])


def test_onb_orthonormal():
    w = normalize(jnp.asarray(np.random.default_rng(1).normal(size=(64, 3)),
                              jnp.float32))
    b = OrthonormalBasis.from_w(w)
    for a, c in [(b.u, b.v), (b.v, b.w), (b.u, b.w)]:
        assert np.allclose(np.asarray(dot(a, c)), 0.0, atol=1e-5)
    for a in (b.u, b.v, b.w):
        assert np.allclose(np.asarray(length(a)), 1.0, atol=1e-5)
    # Round trip local -> world -> local.
    loc = normalize(jnp.asarray(np.random.default_rng(2).normal(size=(64, 3)),
                                jnp.float32))
    back = b.to_local(b.to_world(loc))
    assert np.allclose(np.asarray(back), np.asarray(loc), atol=1e-4)


def test_de_nan():
    x = jnp.asarray([[np.nan, 1.0, 2.0]])
    assert np.allclose(np.asarray(de_nan(x)), [[0.0, 1.0, 2.0]])


def test_rng_deterministic_and_uniform():
    pix = jnp.arange(10000, dtype=jnp.uint32)
    s = RaySampler.create(0, pix, jnp.zeros_like(pix))
    u1 = np.asarray(s.uniform(3))
    u2 = np.asarray(RaySampler.create(0, pix, jnp.zeros_like(pix)).uniform(3))
    assert np.array_equal(u1, u2)                      # deterministic
    assert 0.0 <= u1.min() and u1.max() < 1.0
    assert abs(u1.mean() - 0.5) < 0.01                 # uniform-ish
    # Different dimensions decorrelated.
    v = np.asarray(s.uniform(4))
    assert abs(np.corrcoef(u1, v)[0, 1]) < 0.05


def test_rng_fold_changes_stream():
    pix = jnp.arange(100, dtype=jnp.uint32)
    s = RaySampler.create(0, pix, jnp.zeros_like(pix))
    assert not np.array_equal(np.asarray(s.uniform(0)),
                              np.asarray(s.fold(1).uniform(0)))


def test_sobol_first_points():
    """Gray-code Sobol: dim 0 is van der Corput; first points are the classic
    sequence (matches the reference construction, Raytracing_n.cpp:721-812)."""
    pts = sobol_points(8, 2)
    assert pts.shape == (8, 2)
    # Van der Corput in gray-code order starts 0, .5, .75, .25, ...
    assert np.allclose(pts[:4, 0], [0.0, 0.5, 0.75, 0.25])
    # Dimension 2 of Joe-Kuo also starts 0, .5, .25, .75
    assert np.allclose(pts[:4, 1], [0.0, 0.5, 0.25, 0.75])
    # Low-discrepancy: stratified mean converges fast.
    pts = sobol_points(256, 2)
    assert abs(pts[:, 0].mean() - 0.5) < 1e-2
    assert abs(pts[:, 1].mean() - 0.5) < 1e-2


def test_sobol_matches_reference_direction_file():
    """If the reference's Joe-Kuo file is present, deep dims must agree with
    the embedded head table (both from the public new-joe-kuo-6 dataset)."""
    import os
    path = "/root/reference/contents/sobol/new-joe-kuo-6.21201"
    if not os.path.exists(path):
        import pytest
        pytest.skip("reference sobol data not present")
    a = sobol_points(64, 16)
    b = sobol_points(64, 16, dir_file=path)
    assert np.allclose(a, b)


def test_hash_combine_avalanche():
    a = hash_combine(jnp.arange(1 << 14, dtype=jnp.uint32), jnp.uint32(7))
    bits = np.asarray(a)
    assert len(np.unique(bits)) > (1 << 14) * 0.999    # virtually no collisions
    u = np.asarray(bits_to_uniform(a))
    assert abs(u.mean() - 0.5) < 0.01
