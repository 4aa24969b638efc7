"""Scene intermediate representation: flat SoA buffers + integer tags.

This replaces the reference's pointer-chasing virtual-dispatch scene graph
(``hitable*`` trees with ``material*`` leaves, ``Raytracing_n/hitable.h:27-33``)
with a fixed set of dense arrays, one per primitive family. Design rules:

* Every per-primitive attribute is a contiguous array ⇒ intersection is a
  vectorized map over (rays × primitives) or a BVH gather, never a virtual
  call. Static shapes keep everything jit-compilable and shardable.
* Instancing (``translate`` / ``rotate_x`` / ``rotate_y``, ``hitable.h:35-203``)
  is baked into world space at build time — the reference only ever uses
  static transforms, so carrying a transform tree to the device would buy
  nothing and cost a matmul per ray.
* Materials and textures are tables indexed by integer ids; shading evaluates
  all material models on masked lanes and selects (cheap elementwise, no
  divergence), rather than branching per ray.
* The whole Scene is a pytree of arrays: it can be donated, replicated across
  a mesh with ``shard_map`` (scene is broadcast, rays are sharded), and
  differentiated through (gradients flow to centers, colors, emission, ...).
"""
from __future__ import annotations

import enum
from typing import NamedTuple

import jax.numpy as jnp


class MaterialType(enum.IntEnum):
    """Tags for the material table (reference classes in ``material.h``)."""
    LAMBERTIAN = 0     # material.h:95-114
    OREN_NAYAR = 1     # material.h:127-149
    BECKMANN = 2       # material.h:151-199 (anisotropic microfacet)
    METAL = 3          # material.h:243-261 (mirror + fuzz)
    DIELECTRIC = 4     # material.h:282-339 (Schlick + refract)
    DIFFUSE_LIGHT = 5  # material.h:341-356 (one-sided emitter)
    ISOTROPIC = 6      # material.h:359-369 (volume phase function)
    MERL = 7           # material.h:201-241 (measured BRDF table)


class TextureType(enum.IntEnum):
    """Tags for the texture table (reference classes in ``texture.h``)."""
    CONSTANT = 0  # texture.h:25-33
    CHECKER = 1   # texture.h:9-23 (3-D sine parity of two colors)
    NOISE = 2     # texture.h:35-46 (marble: 0.5*(1+sin(scale*z+5*turb)))
    IMAGE = 3     # texture.h:48-70 (nearest-neighbor, y-flip)


class LightKind(enum.IntEnum):
    RECT = 0    # area light sampling, aarect.h:45-60
    SPHERE = 1  # solid-angle cone sampling, sphere.h:69-86


class SceneFlags(NamedTuple):
    """Static shader-specialization key: which texture/material models a
    scene actually uses.

    The wavefront shader evaluates every model on masked lanes and selects
    by tag — correct but wasteful when a family is absent (e.g. 7-octave
    Perlin turbulence in a constant-texture Cornell). ``SceneFlags`` is
    hashable and threaded through the jit boundary as a *static* argument,
    so each scene compiles a shader with only its own families; skipped
    families have all-False masks, making specialization bit-identical.
    ``None`` anywhere means "evaluate everything" (the safe default when
    the scene is a traced value and its tables can't be inspected).
    """
    tex_kinds: tuple
    mat_kinds: tuple
    bvh_leaf: int = 4   # widest triangle-BVH leaf (static traversal bound)
    sbvh_leaf: int = 4  # widest sphere-BVH leaf (independent of bvh_leaf)
    # Static facts for the fused-bounce kernel (pallas/bounce.py):
    # whether the scene qualifies, per-light kinds (so the kernel's light
    # loop is branch-free), and whether any sphere actually moves.
    fused_bounce: bool = False
    light_kinds: tuple = ()
    moving: bool = False
    # any scattering material carries a deferred (NOISE/IMAGE) albedo:
    # in-kernel Russian roulette would then see an albedo-less beta, so
    # dispatch keeps the kernel off when roulette is enabled
    fused_deferred_albedo: bool = False
    # Reproduce the reference's *as-implemented* estimator instead of the
    # physically-correct one (for golden-image comparison against its
    # checked-in renders). Concretely (see materials.bsdf_weight/bsdf_pdf):
    # Beckmann's per-bounce numerator is its VNDF sampling pdf
    # (material.h:160-185) and its mixture-pdf term is the BRDF-shaped
    # D*G/(4 cosI cosO) that beckmann_pdf::generate stores (pdf.h:133-152);
    # Oren-Nayar's numerator is plain cos/pi (material.h:134-138) while the
    # full A+B formula sits in the pdf (pdf.h:64-101).
    ref_parity: bool = False
    # Diagnostic variant of ref_parity: the light branch reads 0 from the
    # heap slot instead of the previous Beckmann draw's pdf (paired with
    # a C++ build whose beckmann_pdf ctor zero-initializes its malloc —
    # the A/B that isolates the stale-distribution term, GOLDEN.md r5).
    parity_no_stale: bool = False

    @staticmethod
    def of(scene) -> "SceneFlags | None":
        """Flags from a concrete scene; None if the tables are traced."""
        import numpy as np
        try:
            tt = np.asarray(scene.tex_type)
            mt = np.asarray(scene.mat_type)
            leaf = int(np.asarray(scene.bvh_count).max(initial=0)) or 4
            sleaf = 4
            if scene.sbvh_count is not None:
                sleaf = int(np.asarray(scene.sbvh_count).max(initial=0)) or 4
        except Exception:
            return None
        # The fused-bounce fields inspect *geometry* tables, which may be
        # traced even when the type tables are concrete (e.g. optimizing a
        # light position, diff/inverse.py:splice). Degrade per-field: an
        # undeterminable scene just keeps the kernel off — it must NOT
        # void the whole flags object (that would de-specialize the shader
        # and re-introduce garbage-lane NaNs in gradients).
        try:
            light_kinds = tuple(np.asarray(scene.light_kind).tolist())
            moving = bool((np.asarray(scene.sph_center0)
                           != np.asarray(scene.sph_center1)).any())
            fused = _fused_bounce_eligible(scene, mt, tt)
            scat = mt != int(MaterialType.DIFFUSE_LIGHT)
            defer = bool(np.isin(
                tt[np.asarray(scene.mat_tex)][scat],
                [int(TextureType.NOISE), int(TextureType.IMAGE)]).any())
        except Exception:
            light_kinds, moving, fused, defer = (), True, False, False
        return SceneFlags(tex_kinds=tuple(sorted(set(tt.tolist()))),
                          mat_kinds=tuple(sorted(set(mt.tolist()))),
                          bvh_leaf=leaf, sbvh_leaf=sleaf,
                          fused_bounce=fused, light_kinds=light_kinds,
                          moving=moving, fused_deferred_albedo=defer)


def _fused_bounce_eligible(scene, mat_types, tex_types) -> bool:
    """Static gate for the fused per-bounce kernel.

    The kernel (``pallas/bounce.py``) covers analytic-primitive scenes:
    spheres + rects, the non-volumetric material families, constant/checker
    textures in-kernel, and image textures only as *deferred emission*
    (the atlas gather stays in XLA). Everything else falls back to the
    XLA bounce.
    """
    import numpy as np
    if scene.merl.shape[0]:
        return False
    if scene.n_spheres + scene.n_rects + scene.n_tris == 0:
        return False
    # No sphere cap: the kernel's sphere sweep is brute force like the
    # XLA sweep it replaces, over a table in global memory. Lights and
    # media are unrolled statically, so their counts stay bounded.
    if scene.n_rects > 64 or scene.n_lights > 8:
        return False
    if scene.mat_type.shape[0] > 512:
        return False
    if scene.n_media:
        # analytic sphere/box media run in-kernel; mesh-bounded media
        # (kind 2) keep the XLA bounce
        if bool((np.asarray(scene.med_kind) == 2).any()):
            return False
        if scene.n_media > 8:
            return False
    allowed = {int(MaterialType.LAMBERTIAN), int(MaterialType.OREN_NAYAR),
               int(MaterialType.BECKMANN), int(MaterialType.METAL),
               int(MaterialType.DIELECTRIC), int(MaterialType.DIFFUSE_LIGHT),
               int(MaterialType.ISOTROPIC)}
    if not set(mat_types.tolist()) <= allowed:
        return False
    # Texture families: constant/checker in-kernel; NOISE and IMAGE are
    # deferred (the kernel emits a tag, XLA evaluates the texture).
    return bool(np.isin(tex_types,
                        [int(TextureType.CONSTANT), int(TextureType.CHECKER),
                         int(TextureType.NOISE),
                         int(TextureType.IMAGE)]).all())


def has_tex(flags, kind) -> bool:
    return flags is None or int(kind) in flags.tex_kinds


def has_mat(flags, kind) -> bool:
    return flags is None or int(kind) in flags.mat_kinds


class Scene(NamedTuple):
    """All-device scene state. Leading dims are static per compiled scene."""

    # --- spheres (static, moving, env-dome; S entries) -------------------
    sph_center0: jnp.ndarray   # (S, 3) center at time0
    sph_center1: jnp.ndarray   # (S, 3) center at time1 (== center0 if static)
    sph_times: jnp.ndarray     # (S, 2) (time0, time1) for the motion lerp
    sph_radius: jnp.ndarray    # (S,)
    sph_mat: jnp.ndarray       # (S,) int32 material id
    sph_flip: jnp.ndarray      # (S,) bool — flip_normals wrapper (aarect.h:149)
    sph_env: jnp.ndarray       # (S,) bool — env_sphere always-hit variant
                               #   (env_sphere.h:27-38)

    # --- axis-aligned rects (R entries) ----------------------------------
    rect_axis: jnp.ndarray     # (R,) int32: 0=xy(z=k) 1=xz(y=k) 2=yz(x=k)
    rect_bounds: jnp.ndarray   # (R, 4) (a0, a1, b0, b1) in the rect plane
    rect_k: jnp.ndarray        # (R,) plane offset
    rect_mat: jnp.ndarray      # (R,) int32
    rect_flip: jnp.ndarray     # (R,) bool

    # --- triangles, world-space baked (T entries) ------------------------
    tri_p0: jnp.ndarray        # (T, 3)
    tri_p1: jnp.ndarray        # (T, 3)
    tri_p2: jnp.ndarray        # (T, 3)
    tri_uv: jnp.ndarray        # (T, 3, 2) per-vertex uv
    tri_n: jnp.ndarray         # (T, 3, 3) per-vertex shading normals
    tri_mat: jnp.ndarray       # (T,) int32

    # --- flattened stackless BVH over the triangles (B nodes) ------------
    # Depth-first layout with skip links: on AABB hit descend to node i+1,
    # on miss (or after a leaf) jump to bvh_skip[i]. Replaces the pointer
    # tree of bvh.h:9-119 with two gathers per traversal step.
    bvh_lo: jnp.ndarray        # (B, 3)
    bvh_hi: jnp.ndarray        # (B, 3)
    bvh_skip: jnp.ndarray      # (B,) int32 miss/continue link (B = end)
    bvh_first: jnp.ndarray     # (B,) int32 first triangle of a leaf, -1 internal
    bvh_count: jnp.ndarray     # (B,) int32 leaf triangle count (<= leaf_size)

    # --- homogeneous participating media (M) -----------------------------
    # constant_medium.h:19-50: exponential free-flight between the two
    # boundary crossings. The reference accepts any hitable boundary
    # (meshes via the triangle is_medium two-sided path, triangle.h:108-115);
    # here: analytic sphere/box + MESH boundaries whose triangles live in
    # the med_tri_* tables below. Non-convex boundaries under the
    # reference's two-crossing logic are already wrong there
    # (constant_medium.h:23-27); convex boundaries are exact.
    med_kind: jnp.ndarray      # (M,) int32: 0 = sphere, 1 = box, 2 = mesh
    med_center: jnp.ndarray    # (M, 3) sphere center / box center
    med_radius: jnp.ndarray    # (M,) sphere radius (0 for boxes)
    med_half: jnp.ndarray      # (M, 3) box half-extents (0 for spheres)
    med_density: jnp.ndarray   # (M,)
    med_mat: jnp.ndarray       # (M,) int32 (an ISOTROPIC material)

    # --- material table (Mt entries) --------------------------------------
    mat_type: jnp.ndarray      # (Mt,) int32 MaterialType
    mat_tex: jnp.ndarray       # (Mt,) int32 albedo/emission texture id
    mat_params: jnp.ndarray    # (Mt, 4) f32:
                               #  OREN_NAYAR: (A, B, 0, 0) precomputed
                               #  BECKMANN:   (alphax, alphay, 0, 0)
                               #  METAL:      (fuzz, 0, 0, 0)
                               #  DIELECTRIC: (ref_idx, 0, 0, 0)
                               #  MERL:       (table_id, 0, 0, 0)

    # --- texture table (Tx entries) ---------------------------------------
    tex_type: jnp.ndarray      # (Tx,) int32 TextureType
    tex_color: jnp.ndarray     # (Tx, 3) constant / checker even color
    tex_color2: jnp.ndarray    # (Tx, 3) checker odd color
    tex_scale: jnp.ndarray     # (Tx,) noise scale
    tex_img: jnp.ndarray       # (Tx, 3) int32 (atlas offset, nx, ny)

    # --- image atlas: all image textures flattened rgb f32 ----------------
    atlas: jnp.ndarray         # (A,) f32 (3 floats per texel, row-major)
    # Packed rgb8-in-i32 twin of ``atlas`` (A/3,), built iff every atlas
    # value is exactly a u8/255 multiple (always true for decoded image
    # assets). One texel = ONE gather instead of three.
    # ``diff.splice`` drops it when the f32 atlas itself is optimized.
    # Declared after the required fields (see end of class).

    # --- Perlin tables (perlin.h:28-97), fixed-seed host generated --------
    perlin_vec: jnp.ndarray    # (256, 3) random unit gradients
    perlin_perm: jnp.ndarray   # (3, 256) int32 permutations (x, y, z)

    # --- measured MERL BRDF tables (brdf.h:63-214) ------------------------
    merl: jnp.ndarray          # (Nm, 3, 90*90*180/2...) f32, possibly (0, 3, n)

    # --- light list for NEE (the reference's hlist) -----------------------
    light_kind: jnp.ndarray    # (L,) int32 LightKind
    light_index: jnp.ndarray   # (L,) int32 index into rects / spheres

    # --- mesh-medium boundary triangles (K entries; None when unused) ----
    med_tri_p0: jnp.ndarray | None = None    # (K, 3)
    med_tri_p1: jnp.ndarray | None = None    # (K, 3)
    med_tri_p2: jnp.ndarray | None = None    # (K, 3)
    med_tri_mid: jnp.ndarray | None = None   # (K,) int32 medium id

    # --- sphere BVH (built when the scene has many spheres; None else) ---
    # Skip-link layout like the triangle BVH; leaves reference original
    # sphere ids through ``sbvh_ids`` (no sphere reordering, so light /
    # medium indices stay valid). Env spheres (always-hit) are excluded
    # and swept brute-force via ``sph_env_ids``.
    sbvh_lo: jnp.ndarray | None = None       # (Bs, 3)
    sbvh_hi: jnp.ndarray | None = None       # (Bs, 3)
    sbvh_skip: jnp.ndarray | None = None     # (Bs,) i32
    sbvh_first: jnp.ndarray | None = None    # (Bs,) i32 (into sbvh_ids)
    sbvh_count: jnp.ndarray | None = None    # (Bs,) i32
    sbvh_ids: jnp.ndarray | None = None      # (Sn,) i32 original sphere id
    sph_env_ids: jnp.ndarray | None = None   # (Se,) i32 env sphere ids

    # --- packed rgb8 atlas twin (see comment at ``atlas``) ----------------
    atlas_u32: jnp.ndarray | None = None     # (A/3,) i32 (r<<16|g<<8|b)

    @property
    def n_spheres(self) -> int:
        return self.sph_radius.shape[0]

    @property
    def n_rects(self) -> int:
        return self.rect_k.shape[0]

    @property
    def n_tris(self) -> int:
        return self.tri_p0.shape[0]

    @property
    def n_bvh_nodes(self) -> int:
        return self.bvh_skip.shape[0]

    @property
    def n_media(self) -> int:
        return self.med_radius.shape[0]

    @property
    def n_lights(self) -> int:
        return self.light_kind.shape[0]
