"""Thin-lens camera with shutter interval.

Math of the reference ``camera`` (``Raytracing_n/camera.h:16-71``): film plane
placed at the focus distance, aperture disk sampling, per-ray time jitter,
normalized directions. The camera is a pytree, so it can be differentiated
through (e.g. optimizing lookfrom) and replicated across the device mesh.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import jax.numpy as jnp

from srt.core.ray import Ray
from srt.core.vecmath import cross, normalize


class Camera(NamedTuple):
    origin: jnp.ndarray            # (3,)
    lower_left: jnp.ndarray        # (3,)
    horizontal: jnp.ndarray        # (3,)
    vertical: jnp.ndarray          # (3,)
    u: jnp.ndarray                 # (3,) right
    v: jnp.ndarray                 # (3,) up
    lens_radius: jnp.ndarray       # ()
    time0: jnp.ndarray             # ()
    time1: jnp.ndarray             # ()

    @staticmethod
    def look_at(lookfrom, lookat, vup=(0.0, 1.0, 0.0), vfov=40.0,
                aspect=1.0, aperture=0.0, focus_dist=10.0,
                time0=0.0, time1=1.0) -> "Camera":
        lookfrom = jnp.asarray(lookfrom, jnp.float32)
        lookat = jnp.asarray(lookat, jnp.float32)
        vup = jnp.asarray(vup, jnp.float32)
        theta = vfov * math.pi / 180.0
        half_height = jnp.tan(theta / 2.0)
        half_width = aspect * half_height
        w = normalize(lookfrom - lookat)
        u = normalize(cross(vup, w))
        v = cross(w, u)
        lower_left = (lookfrom - half_width * focus_dist * u
                      - half_height * focus_dist * v - focus_dist * w)
        return Camera(
            origin=lookfrom, lower_left=lower_left,
            horizontal=2.0 * half_width * focus_dist * u,
            vertical=2.0 * half_height * focus_dist * v,
            u=u, v=v,
            lens_radius=jnp.asarray(aperture / 2.0, jnp.float32),
            time0=jnp.asarray(time0, jnp.float32),
            time1=jnp.asarray(time1, jnp.float32))

    def rays(self, s, t, u_lens1, u_lens2, u_time) -> Ray:
        """Primary rays for film coords (s, t) in [0,1]² (``camera.h:51-59``).

        Lens disk sampled exactly (r = R·sqrt(u)) instead of the reference's
        rejection loop (``camera.h:8-14``).
        """
        r = self.lens_radius * jnp.sqrt(u_lens1)
        phi = 2.0 * jnp.pi * u_lens2
        offset = (self.u * (r * jnp.cos(phi))[..., None]
                  + self.v * (r * jnp.sin(phi))[..., None])
        time = self.time0 + u_time * (self.time1 - self.time0)
        origin = self.origin + offset
        direction = normalize(self.lower_left + s[..., None] * self.horizontal
                              + t[..., None] * self.vertical
                              - self.origin - offset)
        return Ray(origin=origin, direction=direction, time=time)
