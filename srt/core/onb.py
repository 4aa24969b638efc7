"""Orthonormal basis for world<->shading-frame transforms.

Batched equivalent of the reference's ``onb`` (``Raytracing_n/onb.h:6-30``),
using the same branch rule (pick the up-vector by |w.x| > 0.9) so sampled
directions match the reference bit-for-bit in distribution.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from srt.core.vecmath import cross, dot, normalize, where3


class OrthonormalBasis(NamedTuple):
    u: jnp.ndarray  # (..., 3) tangent
    v: jnp.ndarray  # (..., 3) bitangent
    w: jnp.ndarray  # (..., 3) normal

    @staticmethod
    def from_w(n):
        w = normalize(n)
        a = where3(jnp.abs(w[..., 0]) > 0.9,
                   jnp.broadcast_to(np.array([0.0, 1.0, 0.0], np.float32), w.shape),
                   jnp.broadcast_to(np.array([1.0, 0.0, 0.0], np.float32), w.shape))
        v = normalize(cross(w, a))
        u = cross(w, v)
        return OrthonormalBasis(u=u, v=v, w=w)

    def to_world(self, a):
        """Local (x,y,z) -> world: x*u + y*v + z*w (``onb.h:15``)."""
        return (a[..., 0:1] * self.u + a[..., 1:2] * self.v + a[..., 2:3] * self.w)

    def to_local(self, a):
        """World -> local frame components (dot with each axis)."""
        return jnp.stack([dot(a, self.u), dot(a, self.v), dot(a, self.w)], axis=-1)
