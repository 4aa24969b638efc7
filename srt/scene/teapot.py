"""Procedural Utah teapot: Bézier-patch tessellation -> triangle soup.

Capability match for the reference's ``teapot.h:10-172``: 32 bicubic Bézier
patches over Newell's public-domain control-point dataset
(``teapot_data.npz`` holds the same 32x16 patch indices and 306 vertices the
reference vendors in ``teapotdata.h`` — standard published data, not code).

Differences from the reference, by design:

* fully vectorized tensor-product evaluation (one einsum per teapot instead
  of 32 * (divs+1)^2 scalar curve evaluations);
* exact analytic patch normals are available (``smooth=True``) via the
  Bernstein derivative — the reference computes flat per-triangle normals
  only (its ``dUBezier`` is dead code with a broken loop, ``teapot.h:48-61``);
* ``divs`` is a parameter (the reference hardcodes ``divs = 100`` inside
  ``createPloyTeapot``, ``teapot.h:77``, giving 640k triangles).
"""
from __future__ import annotations

import os

import numpy as np

from srt.io.mesh import TriMesh

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "teapot_data.npz")


def _bernstein(t: np.ndarray) -> np.ndarray:
    """Cubic Bernstein basis: (n,) -> (n, 4)."""
    t = np.asarray(t, np.float64)
    u = 1.0 - t
    return np.stack([u ** 3, 3 * t * u ** 2, 3 * t ** 2 * u, t ** 3], axis=-1)


def _bernstein_d(t: np.ndarray) -> np.ndarray:
    """Cubic Bernstein derivative basis: (n,) -> (n, 4)."""
    t = np.asarray(t, np.float64)
    u = 1.0 - t
    return np.stack([-3 * u ** 2, 3 * u ** 2 - 6 * t * u,
                     6 * t * u - 3 * t ** 2, 3 * t ** 2], axis=-1)


def create_teapot(scale: float = 1.0, divs: int = 100,
                  smooth: bool = False) -> TriMesh:
    """Tessellate the teapot -> :class:`TriMesh` with (u, v) texture coords.

    Grid topology and quad->2-triangle split match ``teapot.h:88-135``:
    each (divs x divs) quad (v0, v1, v2, v3) emits (v0, v1, v2), (v0, v2, v3).
    """
    data = np.load(_DATA)
    patches = data["patches"]          # (32, 16) 1-based vertex indices
    cps = data["vertices"]             # (306, 3)
    cp = cps[patches - 1].reshape(32, 4, 4, 3).astype(np.float64)  # [v][u]

    t = np.linspace(0.0, 1.0, divs + 1)
    bu = _bernstein(t)                 # (G, 4)
    bv = _bernstein(t)
    # P[p, j(v), i(u)] = sum_{a,b} bv[j,a] * bu[i,b] * cp[p, a, b]
    grid = np.einsum("ja,ib,pabc->pjic", bv, bu, cp)   # (32, G, G, 3)

    if smooth:
        du = np.einsum("ja,ib,pabc->pjic", bv, _bernstein_d(t), cp)
        dv = np.einsum("ja,ib,pabc->pjic", _bernstein_d(t), bu, cp)
        nrm = np.cross(du, dv)
        ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
        # Degenerate patch corners (collapsed control points, e.g. the lid
        # tip rows 204/211): fall back to the patch-center normal direction.
        nrm = np.where(ln > 1e-9, nrm / np.maximum(ln, 1e-9), 0.0)
    else:
        nrm = None

    g = divs + 1
    j, i = np.meshgrid(np.arange(divs), np.arange(divs), indexing="ij")
    v0 = (j * g + i).reshape(-1)
    v1 = (j * g + i + 1).reshape(-1)
    v2 = ((j + 1) * g + i + 1).reshape(-1)
    v3 = ((j + 1) * g + i).reshape(-1)
    tri_idx = np.concatenate(
        [np.stack([v0, v1, v2], -1), np.stack([v0, v2, v3], -1)])  # (2*d*d, 3)

    flat = grid.reshape(32, g * g, 3)
    pos = flat[:, tri_idx].reshape(-1, 3, 3) * scale

    uu, vv = np.meshgrid(t, t, indexing="xy")
    uvflat = np.stack([uu, vv], -1).reshape(g * g, 2)
    uv = np.broadcast_to(uvflat[tri_idx], (32,) + tri_idx.shape + (2,))
    uv = uv.reshape(-1, 3, 2)

    if nrm is not None:
        nflat = nrm.reshape(32, g * g, 3)
        n = nflat[:, tri_idx].reshape(-1, 3, 3)
        # Collapsed-corner fallback: replace zero normals with the triangle's
        # geometric normal.
        gn = np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0])
        gn = gn / np.maximum(np.linalg.norm(gn, axis=1, keepdims=True), 1e-20)
        bad = np.linalg.norm(n, axis=-1) < 0.5
        n = np.where(bad[..., None], gn[:, None, :], n)
    else:
        n = None

    # Drop zero-area triangles from collapsed patch edges (the reference
    # keeps them; they cost BVH nodes and can produce det=0 rays).
    area2 = np.linalg.norm(
        np.cross(pos[:, 1] - pos[:, 0], pos[:, 2] - pos[:, 0]), axis=1)
    keep = area2 > 1e-12 * max(scale, 1.0) ** 2
    return TriMesh(
        np.ascontiguousarray(pos[keep], np.float32),
        np.ascontiguousarray(uv[keep], np.float32),
        None if n is None else np.ascontiguousarray(n[keep], np.float32))
