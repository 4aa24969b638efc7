"""Host-side scene construction: Python builder -> device SoA buffers.

The reference builds scenes by newing a ``hitable*`` graph inside hardcoded
functions (``Raytracing_n.cpp:108-711``). Here scene construction is a small
host API producing the :class:`~srt.scene.ir.Scene` pytree; scenes are
data, and the eight reference scenes are plain functions over this builder
(``srt/scene/library.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import jax.numpy as jnp

from srt.accel.bvh import build_bvh
from srt.scene.ir import LightKind, MaterialType, Scene, TextureType


def rotation_y(angle_deg: float) -> np.ndarray:
    """World-space matrix matching the reference's ``rotate_y`` instancing
    (object->world map implied by ``hitable.h:109-132``)."""
    r = math.radians(angle_deg)
    c, s = math.cos(r), math.sin(r)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float32)


def rotation_x(angle_deg: float) -> np.ndarray:
    """Matches ``rotate_x`` (``hitable.h:151-203``)."""
    r = math.radians(angle_deg)
    c, s = math.cos(r), math.sin(r)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, s], [0.0, -s, c]], np.float32)


@dataclass
class SceneBuilder:
    """Accumulates primitives/materials/textures on the host, then
    :meth:`build` packs them into the device Scene pytree."""

    bvh_leaf_size: int = 4
    perlin_seed: int = 7
    sphere_bvh_min: int = 64   # build a sphere BVH at/above this count

    # textures
    _tex_type: list = field(default_factory=list)
    _tex_color: list = field(default_factory=list)
    _tex_color2: list = field(default_factory=list)
    _tex_scale: list = field(default_factory=list)
    _tex_img: list = field(default_factory=list)
    _atlas: list = field(default_factory=list)
    _atlas_len: int = 0

    # materials
    _mat_type: list = field(default_factory=list)
    _mat_tex: list = field(default_factory=list)
    _mat_params: list = field(default_factory=list)

    # geometry
    _sph: list = field(default_factory=list)
    _rect: list = field(default_factory=list)
    _tris: list = field(default_factory=list)   # list of (p, uv, n, mat) chunks
    _med: list = field(default_factory=list)
    _med_tris: list = field(default_factory=list)  # (world tris, medium id)
    _lights: list = field(default_factory=list)
    _merl: list = field(default_factory=list)

    # ------------------------------------------------------------------ tex
    def constant(self, color) -> int:
        return self._push_tex(TextureType.CONSTANT, color=color)

    def checker(self, even, odd) -> int:
        return self._push_tex(TextureType.CHECKER, color=even, color2=odd)

    def noise(self, scale: float) -> int:
        return self._push_tex(TextureType.NOISE, scale=scale)

    def image(self, pixels: np.ndarray) -> int:
        """Register an image texture. ``pixels``: (ny, nx, 3) uint8 or f32."""
        px = np.asarray(pixels)
        if px.dtype == np.uint8:
            px = px.astype(np.float32) / 255.0
        if px.ndim == 2:
            px = np.repeat(px[:, :, None], 3, axis=2)
        px = np.ascontiguousarray(px[:, :, :3], np.float32)
        ny, nx, _ = px.shape
        offset = self._atlas_len
        self._atlas.append(px.reshape(-1))
        self._atlas_len += px.size
        return self._push_tex(TextureType.IMAGE, img=(offset, nx, ny))

    def _push_tex(self, ttype, color=(0, 0, 0), color2=(0, 0, 0), scale=0.0,
                  img=(0, 0, 0)) -> int:
        self._tex_type.append(int(ttype))
        self._tex_color.append(np.asarray(color, np.float32))
        self._tex_color2.append(np.asarray(color2, np.float32))
        self._tex_scale.append(float(scale))
        self._tex_img.append(np.asarray(img, np.int32))
        return len(self._tex_type) - 1

    # ------------------------------------------------------------------ mat
    def _push_mat(self, mtype, tex, params=(0.0, 0.0, 0.0, 0.0)) -> int:
        self._mat_type.append(int(mtype))
        self._mat_tex.append(int(tex))
        self._mat_params.append(np.asarray(params, np.float32))
        return len(self._mat_type) - 1

    def lambertian(self, tex: int) -> int:
        return self._push_mat(MaterialType.LAMBERTIAN, tex)

    def oren_nayar(self, tex: int, sigma_deg: float) -> int:
        # A/B precomputation identical to material.h:129-133.
        s = sigma_deg / 180.0 * math.pi
        a = 1.0 - 0.5 * s * s / (s * s + 0.33)
        b = 0.45 * s * s / (s * s + 0.09)
        return self._push_mat(MaterialType.OREN_NAYAR, tex, (a, b, 0, 0))

    def beckmann(self, tex: int, roughx: float, roughy: float) -> int:
        ax = roughness_to_alpha(roughx)
        ay = roughness_to_alpha(roughy)
        return self._push_mat(MaterialType.BECKMANN, tex, (ax, ay, 0, 0))

    def metal(self, albedo, fuzz: float = 0.0) -> int:
        tex = self.constant(albedo)
        return self._push_mat(MaterialType.METAL, tex, (min(fuzz, 1.0), 0, 0, 0))

    def dielectric(self, ref_idx: float) -> int:
        tex = self.constant((1.0, 1.0, 1.0))
        return self._push_mat(MaterialType.DIELECTRIC, tex, (ref_idx, 0, 0, 0))

    def diffuse_light(self, tex: int) -> int:
        return self._push_mat(MaterialType.DIFFUSE_LIGHT, tex)

    def isotropic(self, tex: int) -> int:
        return self._push_mat(MaterialType.ISOTROPIC, tex)

    def merl(self, table: np.ndarray, albedo) -> int:
        """Measured-BRDF material; ``table`` is (3, N) f32 in MERL layout
        (already scaled), from :func:`srt.io.merl.read_merl`."""
        tex = self.constant(albedo)
        self._merl.append(np.asarray(table, np.float32))
        return self._push_mat(MaterialType.MERL, tex,
                              (float(len(self._merl) - 1), 0, 0, 0))

    # ------------------------------------------------------------------ geo
    def sphere(self, center, radius, mat, flip=False, env=False,
               center1=None, t0=0.0, t1=1.0) -> int:
        c0 = np.asarray(center, np.float32)
        c1 = c0 if center1 is None else np.asarray(center1, np.float32)
        self._sph.append((c0, c1, (t0, t1), float(radius), int(mat),
                          bool(flip), bool(env)))
        return len(self._sph) - 1

    def rect(self, axis: int, a0, a1, b0, b1, k, mat, flip=False) -> int:
        self._rect.append((int(axis), (a0, a1, b0, b1), float(k), int(mat),
                           bool(flip)))
        return len(self._rect) - 1

    def xy_rect(self, x0, x1, y0, y1, k, mat, flip=False) -> int:
        return self.rect(0, x0, x1, y0, y1, k, mat, flip)

    def xz_rect(self, x0, x1, z0, z1, k, mat, flip=False) -> int:
        return self.rect(1, x0, x1, z0, z1, k, mat, flip)

    def yz_rect(self, y0, y1, z0, z1, k, mat, flip=False) -> int:
        return self.rect(2, y0, y1, z0, z1, k, mat, flip)

    def box(self, pmin, pmax, mat, as_tris: bool = False,
            rotate: np.ndarray | None = None,
            translate=(0.0, 0.0, 0.0)) -> None:
        """Axis-aligned box = 6 rects (reference ``box.h:5-33``).

        ``as_tris=True`` lowers the box to 12 BVH triangles instead —
        essential for box-heavy scenes (``final`` has 400 ground boxes,
        ``Raytracing_n.cpp:483-494``) where the brute-force rect sweep
        would dominate; the rect path keeps exact reference parity for
        the handful of walls/lights other scenes use.

        ``rotate``/``translate`` bake the reference's instancing wrappers
        (``translate(rotate_y(new box(...)))``, ``hitable.h:35-132``) at
        build time — a transformed box is no longer axis-aligned, so it
        always takes the triangle path.
        """
        x0, y0, z0 = [float(v) for v in pmin]
        x1, y1, z1 = [float(v) for v in pmax]
        instanced = rotate is not None or any(float(t) != 0.0
                                              for t in translate)
        if as_tris or instanced:
            c = np.array([[x0, y0, z0], [x1, y0, z0], [x0, y1, z0],
                          [x1, y1, z0], [x0, y0, z1], [x1, y0, z1],
                          [x0, y1, z1], [x1, y1, z1]], np.float32)
            if rotate is not None:
                c = c @ np.asarray(rotate, np.float32).T
            c = c + np.asarray(translate, np.float32)
            # Outward-wound faces: -z +z -y +y -x +x.
            quads = np.array([[0, 2, 3, 1], [4, 5, 7, 6], [0, 1, 5, 4],
                              [2, 6, 7, 3], [0, 4, 6, 2], [1, 3, 7, 5]])
            f = np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])
            self.triangles(c[f], mat)
            return
        self.xy_rect(x0, x1, y0, y1, z1, mat)
        self.xy_rect(x0, x1, y0, y1, z0, mat, flip=True)
        self.xz_rect(x0, x1, z0, z1, y1, mat)
        self.xz_rect(x0, x1, z0, z1, y0, mat, flip=True)
        self.yz_rect(y0, y1, z0, z1, x1, mat)
        self.yz_rect(y0, y1, z0, z1, x0, mat, flip=True)

    def trimesh(self, mesh, mat: int, scale=(1.0, 1.0, 1.0),
                rotate: np.ndarray | None = None,
                translate=(0.0, 0.0, 0.0), flip_winding: bool = False,
                flip_uvs: bool = False) -> None:
        """Add a :class:`~srt.io.mesh.TriMesh` soup, baking
        scale -> rotate -> translate into world space (the reference's
        ``translate(rotate(bvh_node(model)))``, ``Raytracing_n.cpp:642``).
        ``flip_winding``/``flip_uvs`` mirror the assimp import flags
        (``model.h:33-42``)."""
        if isinstance(scale, (int, float)):
            scale = (scale, scale, scale)
        m = mesh.transformed(scale=scale, rotate=rotate, translate=translate,
                             flip_winding=flip_winding, flip_uvs=flip_uvs)
        p = m.positions
        if m.normals is not None:
            n = m.normals
        else:
            # Flat shading (the reference's normal-less PLY path).
            gn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
            gn = gn / np.maximum(np.linalg.norm(gn, axis=1, keepdims=True),
                                 1e-20)
            n = np.repeat(gn[:, None, :], 3, axis=1)
        uv = (m.uvs if m.uvs is not None
              else np.zeros((len(p), 3, 2), np.float32))
        self._tris.append((np.ascontiguousarray(p, np.float32),
                           np.ascontiguousarray(uv, np.float32),
                           np.ascontiguousarray(n, np.float32),
                           np.full(len(p), int(mat), np.int32)))

    def mesh(self, vertices: np.ndarray, faces: np.ndarray, mat: int,
             uvs: np.ndarray | None = None, normals: np.ndarray | None = None,
             scale=(1.0, 1.0, 1.0), rotate: np.ndarray | None = None,
             translate=(0.0, 0.0, 0.0), flip_winding: bool = False) -> None:
        """Add a triangle mesh, baking scale -> rotate -> translate into world
        space (the reference's ``translate(rotate_y(bvh_node(...)))`` wrapping,
        e.g. ``Raytracing_n.cpp:642``; scale applied at load, ``geometry.h:67``).
        """
        v = np.asarray(vertices, np.float32) * np.asarray(scale, np.float32)
        if rotate is not None:
            v = v @ np.asarray(rotate, np.float32).T
        v = v + np.asarray(translate, np.float32)
        f = np.asarray(faces, np.int64)
        if flip_winding:
            f = f[:, ::-1]
        p = v[f]  # (T, 3, 3)
        if normals is not None:
            n = np.asarray(normals, np.float32)
            if rotate is not None:
                n = n @ np.asarray(rotate, np.float32).T
            n = n[f]
        else:
            gn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
            gn = gn / np.maximum(np.linalg.norm(gn, axis=1, keepdims=True), 1e-20)
            n = np.repeat(gn[:, None, :], 3, axis=1)
        if uvs is not None:
            uv = np.asarray(uvs, np.float32)[:, :2][f]
        else:
            uv = np.zeros((len(f), 3, 2), np.float32)
        self._tris.append((p.astype(np.float32), uv.astype(np.float32),
                           n.astype(np.float32),
                           np.full(len(f), int(mat), np.int32)))

    def triangles(self, p: np.ndarray, mat: int, uv=None, n=None) -> None:
        """Add raw world-space triangles, p: (T, 3, 3)."""
        p = np.asarray(p, np.float32)
        t = len(p)
        if n is None:
            gn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
            gn = gn / np.maximum(np.linalg.norm(gn, axis=1, keepdims=True), 1e-20)
            n = np.repeat(gn[:, None, :], 3, axis=1)
        if uv is None:
            uv = np.zeros((t, 3, 2), np.float32)
        self._tris.append((p, np.asarray(uv, np.float32),
                           np.asarray(n, np.float32),
                           np.full(t, int(mat), np.int32)))

    def medium_sphere(self, center, radius, density, albedo_tex: int) -> None:
        """constant_medium with a sphere boundary (``constant_medium.h``)."""
        mat = self.isotropic(albedo_tex)
        self._med.append((0, np.asarray(center, np.float32), float(radius),
                          np.zeros(3, np.float32), float(density), mat))

    def medium_box(self, p0, p1, density, albedo_tex: int) -> None:
        """constant_medium with an axis-aligned box boundary — the generic
        convex-hitable case of ``constant_medium.h:4-50`` (the reference
        accepts any hitable; its two-crossing free-flight logic is only
        correct for convex boundaries)."""
        mat = self.isotropic(albedo_tex)
        p0 = np.asarray(p0, np.float32)
        p1 = np.asarray(p1, np.float32)
        center = 0.5 * (p0 + p1)
        half = np.abs(0.5 * (p1 - p0))
        self._med.append((1, center, 0.0, half, float(density), mat))

    def medium_mesh(self, tri_verts: np.ndarray, density, albedo_tex: int,
                    scale=(1.0, 1.0, 1.0),
                    rotate: np.ndarray | None = None,
                    translate=(0.0, 0.0, 0.0)) -> None:
        """constant_medium with an arbitrary (convex) triangle-mesh
        boundary — the reference's ``new constant_medium(hitable*, ...)``
        over a model, supported there by the triangle ``is_medium``
        two-sided retry (``triangle.h:108-115``). ``tri_verts``: (T, 3, 3)
        object-space; instancing baked like :meth:`trimesh`."""
        mat = self.isotropic(albedo_tex)
        self._med.append((2, np.zeros(3, np.float32), 0.0,
                          np.zeros(3, np.float32), float(density), mat))
        p = np.asarray(tri_verts, np.float32) * np.asarray(scale, np.float32)
        if rotate is not None:
            p = p @ np.asarray(rotate, np.float32).T
        p = p + np.asarray(translate, np.float32)
        self._med_tris.append((p, len(self._med) - 1))

    # NEE light registration (the reference's hlist, Raytracing_n.cpp:930).
    def light_rect(self, rect_id: int) -> None:
        self._lights.append((LightKind.RECT, rect_id))

    def light_sphere(self, sph_id: int) -> None:
        self._lights.append((LightKind.SPHERE, sph_id))

    # ---------------------------------------------------------------- build
    def build(self) -> Scene:
        f32, i32 = np.float32, np.int32

        # Gathers into 0-length tables are invalid in XLA; a degenerate scene
        # (or one with untextured materials only) still needs one row of each.
        if not self._tex_type:
            self.constant((0.0, 0.0, 0.0))
        if not self._mat_type:
            self.lambertian(0)

        def arr(rows, dtype, shape_tail):
            if rows:
                return np.asarray(rows, dtype)
            return np.zeros((0,) + shape_tail, dtype)

        # spheres
        s_c0 = arr([s[0] for s in self._sph], f32, (3,))
        s_c1 = arr([s[1] for s in self._sph], f32, (3,))
        s_t = arr([s[2] for s in self._sph], f32, (2,))
        s_r = arr([s[3] for s in self._sph], f32, ())
        s_m = arr([s[4] for s in self._sph], i32, ())
        s_f = arr([s[5] for s in self._sph], bool, ())
        s_e = arr([s[6] for s in self._sph], bool, ())

        # rects
        r_a = arr([r[0] for r in self._rect], i32, ())
        r_b = arr([r[1] for r in self._rect], f32, (4,))
        r_k = arr([r[2] for r in self._rect], f32, ())
        r_m = arr([r[3] for r in self._rect], i32, ())
        r_f = arr([r[4] for r in self._rect], bool, ())

        # triangles + BVH
        if self._tris:
            p = np.concatenate([t[0] for t in self._tris])
            uv = np.concatenate([t[1] for t in self._tris])
            n = np.concatenate([t[2] for t in self._tris])
            tm = np.concatenate([t[3] for t in self._tris])
        else:
            p = np.zeros((0, 3, 3), f32)
            uv = np.zeros((0, 3, 2), f32)
            n = np.zeros((0, 3, 3), f32)
            tm = np.zeros((0,), i32)
        bvh, order = build_bvh(p, leaf_size=self.bvh_leaf_size)
        p, uv, n, tm = p[order], uv[order], n[order], tm[order]

        # sphere BVH (skip-link over non-env sphere AABBs): reuses the
        # triangle builder by feeding one synthetic triangle per sphere
        # whose AABB/centroid equal the sphere's motion-union bounds
        # (p0 = lo, p1 = hi, p2 = midpoint).
        sbvh_kw: dict = {}
        if len(self._sph) >= self.sphere_bvh_min:
            c0s = np.stack([s[0] for s in self._sph])
            c1s = np.stack([s[1] for s in self._sph])
            rs = np.asarray([s[3] for s in self._sph], f32)[:, None]
            envs = np.asarray([s[6] for s in self._sph], bool)
            lo = np.minimum(c0s, c1s) - rs
            hi = np.maximum(c0s, c1s) + rs
            ids = np.nonzero(~envs)[0].astype(np.int64)
            if len(ids) >= self.sphere_bvh_min:
                synth = np.stack(
                    [lo[ids], hi[ids], 0.5 * (lo[ids] + hi[ids])],
                    axis=1).astype(f32)
                sbvh, sorder = build_bvh(synth,
                                         leaf_size=self.bvh_leaf_size)
                sbvh_kw = dict(
                    sbvh_lo=jnp.asarray(sbvh.lo),
                    sbvh_hi=jnp.asarray(sbvh.hi),
                    sbvh_skip=jnp.asarray(sbvh.skip),
                    sbvh_first=jnp.asarray(sbvh.first),
                    sbvh_count=jnp.asarray(sbvh.count),
                    sbvh_ids=jnp.asarray(ids[sorder].astype(np.int32)),
                    sph_env_ids=jnp.asarray(
                        np.nonzero(envs)[0].astype(np.int32)))

        # mesh-medium boundary triangles
        med_tri_kw: dict = {}
        if self._med_tris:
            mp = np.concatenate([t[0] for t in self._med_tris])
            mid = np.concatenate([np.full((len(t[0]),), t[1], i32)
                                  for t in self._med_tris])
            med_tri_kw = dict(
                med_tri_p0=jnp.asarray(mp[:, 0]),
                med_tri_p1=jnp.asarray(mp[:, 1]),
                med_tri_p2=jnp.asarray(mp[:, 2]),
                med_tri_mid=jnp.asarray(mid))

        # media
        m_k = arr([m[0] for m in self._med], i32, ())
        m_c = arr([m[1] for m in self._med], f32, (3,))
        m_r = arr([m[2] for m in self._med], f32, ())
        m_h = arr([m[3] for m in self._med], f32, (3,))
        m_d = arr([m[4] for m in self._med], f32, ())
        m_m = arr([m[5] for m in self._med], i32, ())

        # perlin tables, fixed host seed (reference generates from racy
        # drand48 at static-init, perlin.h:94-97 — per-run random; we pin it)
        prng = np.random.default_rng(self.perlin_seed)
        pv = prng.uniform(-1.0, 1.0, (256, 3)).astype(f32)
        pv /= np.maximum(np.linalg.norm(pv, axis=1, keepdims=True), 1e-9)
        perm = np.stack([prng.permutation(256) for _ in range(3)]).astype(i32)

        atlas = (np.concatenate(self._atlas) if self._atlas
                 else np.zeros((0,), f32))
        # Packed rgb8 twin for 1-gather texel lookups (ir.Scene.atlas_u32):
        # exact iff every value is a u8/255 multiple (true for decoded
        # image assets; float-sourced atlases keep the 3-gather f32 path).
        atlas_u32 = None
        if atlas.size:
            q = np.round(atlas * 255.0)
            if (q.astype(f32) / np.float32(255.0) == atlas).all():
                rgb = q.astype(np.uint32).reshape(-1, 3)
                atlas_u32 = ((rgb[:, 0] << 16) | (rgb[:, 1] << 8)
                             | rgb[:, 2]).astype(np.int32)
        if self._merl:
            merl = np.stack(self._merl)
        else:
            merl = np.zeros((0, 3, 1), f32)

        lk = arr([l[0] for l in self._lights], i32, ())
        li = arr([l[1] for l in self._lights], i32, ())

        j = jnp.asarray
        return Scene(
            sph_center0=j(s_c0), sph_center1=j(s_c1), sph_times=j(s_t),
            sph_radius=j(s_r), sph_mat=j(s_m), sph_flip=j(s_f), sph_env=j(s_e),
            rect_axis=j(r_a), rect_bounds=j(r_b), rect_k=j(r_k),
            rect_mat=j(r_m), rect_flip=j(r_f),
            tri_p0=j(p[:, 0]), tri_p1=j(p[:, 1]), tri_p2=j(p[:, 2]),
            tri_uv=j(uv), tri_n=j(n), tri_mat=j(tm),
            bvh_lo=j(bvh.lo), bvh_hi=j(bvh.hi), bvh_skip=j(bvh.skip),
            bvh_first=j(bvh.first), bvh_count=j(bvh.count),
            med_kind=j(m_k), med_center=j(m_c), med_radius=j(m_r),
            med_half=j(m_h), med_density=j(m_d), med_mat=j(m_m),
            mat_type=j(arr(self._mat_type, i32, ())),
            mat_tex=j(arr(self._mat_tex, i32, ())),
            mat_params=j(arr(self._mat_params, f32, (4,))),
            tex_type=j(arr(self._tex_type, i32, ())),
            tex_color=j(arr(self._tex_color, f32, (3,))),
            tex_color2=j(arr(self._tex_color2, f32, (3,))),
            tex_scale=j(arr(self._tex_scale, f32, ())),
            tex_img=j(arr(self._tex_img, i32, (3,))),
            atlas=j(atlas),
            atlas_u32=(j(atlas_u32) if atlas_u32 is not None else None),
            perlin_vec=j(pv), perlin_perm=j(perm),
            merl=j(merl), light_kind=j(lk), light_index=j(li),
            **med_tri_kw,
            **sbvh_kw,
        )


def roughness_to_alpha(roughness: float) -> float:
    """PBRT roughness remap (math of ``microfacet_distribution.h:139-144``)."""
    r = max(roughness, 1e-3)
    x = math.log(r)
    return (1.62162 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x ** 3
            + 0.000640711 * x ** 4)
