"""Native C++ runtime components vs their numpy fallbacks."""
import os

import numpy as np
import pytest

from srt.accel import bvh as B


def _build_both(verts, leaf_size=4):
    prev = os.environ.pop("SRT_NO_NATIVE", None)
    try:
        os.environ["SRT_NO_NATIVE"] = "1"
        py = B.build_bvh(verts, leaf_size)
        del os.environ["SRT_NO_NATIVE"]
        nat = B._build_bvh_native(verts, leaf_size)
    finally:
        if prev is not None:
            os.environ["SRT_NO_NATIVE"] = prev
    return py, nat


@pytest.mark.parametrize("t", [1, 4, 5, 64, 777])
def test_native_bvh_matches_numpy(t):
    rng = np.random.default_rng(t)
    verts = rng.standard_normal((t, 3, 3)).astype(np.float32)
    (fb_py, ord_py), nat = _build_both(verts)
    if nat is None:
        pytest.skip("native builder unavailable (no g++?)")
    fb_c, ord_c = nat
    assert np.array_equal(fb_py.skip, fb_c.skip)
    assert np.array_equal(fb_py.first, fb_c.first)
    assert np.array_equal(fb_py.count, fb_c.count)
    assert np.array_equal(ord_py, ord_c)
    np.testing.assert_allclose(fb_py.lo, fb_c.lo, rtol=0, atol=0)
    np.testing.assert_allclose(fb_py.hi, fb_c.hi, rtol=0, atol=0)


def test_native_bvh_degenerate_centroids():
    # All-identical triangles force the median-split fallback path.
    verts = np.tile(np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]],
                             np.float32), (33, 1, 1))
    (fb_py, ord_py), nat = _build_both(verts)
    if nat is None:
        pytest.skip("native builder unavailable")
    fb_c, ord_c = nat
    assert np.array_equal(fb_py.skip, fb_c.skip)
    assert np.array_equal(ord_py, ord_c)
    # Every triangle appears exactly once.
    assert sorted(ord_c.tolist()) == list(range(33))
