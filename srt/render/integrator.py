"""Wavefront path integrator: bounded ``lax.scan`` over bounces.

This is the wavefront re-design of the reference's recursive ``color()``
estimator (``Raytracing_n/Raytracing_n.cpp:55-106``): recursion becomes one
uniform loop state (throughput, ray, alive-mask), the specular-vs-diffuse
branch becomes masked lane math, and the mixture-PDF NEE
(``mixture_pdf``/``hitable_pdf``, ``pdf.h:159-193``) is evaluated in closed
form. Per SURVEY §7 the reference's unbounded ``while (pdf == 0)`` retry
(``Raytracing_n.cpp:79-83``) is replaced by one sample with a
zero-contribution fallback, and the depth cap is a static scan length.

Participating media (``constant_medium.h:19-50``) are folded in here — their
"hit" is a stochastic free-flight sample, so it lives with the RNG rather
than in the deterministic intersector.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from srt.core.ray import Ray
from srt.core.rng import RaySampler
from srt.core.vecmath import de_nan, dot, safe_sqrt, where3
from srt.materials import materials as mats
from srt.render import lights
from srt.render.intersect import Hit, intersect_scene, _BIG
from srt.scene.ir import Scene

# Static sampler dimension slots per bounce (one decision per slot).
_DIM_MEDIUM = 0       # free-flight exponential (one per medium, +index)
_DIM_SPEC = 8         # 4 specular uniforms
_DIM_MIX = 12         # light-vs-bsdf pick
_DIM_LIGHT_PICK = 13
_DIM_SAMPLE = 14      # u1, u2 for light point / bsdf lobe
_DIM_RR = 16          # russian roulette
_DIM_RETRY = 17       # parity-mode resample rounds (4 dims each: mix, pick, u1, u2)
_DIM_SLOT = 33        # parity heap-slot Bernoulli (see bounce_step)
_DIM_RETRY_EXT = 40   # retry rounds 4+ (17..32 holds rounds 0-3)
_PARITY_RETRIES = int(__import__('os').environ.get('SRT_PARITY_RETRIES', '4'))
_PARITY_SLOT_ZERO_P = 0.086   # measured: fraction of light-branch slot
                              # reads that see 0.0 instead of the tcache
                              # pointer garbage (GOLDEN.md r5 BPLOG)
_PARITY_KILL = 1e30           # the garbage read: |pdf| ~ 1e38 kills the
                              # sample's contribution without a retry


def _mesh_medium_crossings(scene: Scene, ray: Ray, m: int):
    """(t_in, t_out, ok) for medium ``m``'s triangle boundary.

    The reference finds the first crossing from -FLT_MAX and the next one
    after it (``constant_medium.h:23-27``, enabled by the two-sided
    triangle ``is_medium`` path, ``triangle.h:108-115``) — for a convex
    boundary that is the smallest and second-smallest signed crossing.
    """
    n = ray.origin.shape[0]
    big = jnp.float32(_BIG)
    t1 = jnp.full((n,), big)
    t2 = jnp.full((n,), big)
    k = scene.med_tri_p0.shape[0]
    chunk = min(512, k)
    # One lax.fori_loop over fixed-size chunks (NOT a Python loop: a
    # bunny-scale medium mesh would otherwise unroll ~k/512 traced
    # Möller–Trumbore blocks into *every* bounce). Static trip count →
    # scan lowering, so the reverse-diff path stays intact.
    n_chunks = -(-k // chunk)
    pad = n_chunks * chunk - k
    p0a = jnp.pad(scene.med_tri_p0, ((0, pad), (0, 0)))
    p1a = jnp.pad(scene.med_tri_p1, ((0, pad), (0, 0)))
    p2a = jnp.pad(scene.med_tri_p2, ((0, pad), (0, 0)))
    mida = jnp.pad(scene.med_tri_mid, (0, pad), constant_values=-1)

    def chunk_body(ci, carry):
        t1, t2 = carry
        c0 = ci * chunk
        p0 = jax.lax.dynamic_slice_in_dim(p0a, c0, chunk)
        e1 = jax.lax.dynamic_slice_in_dim(p1a, c0, chunk) - p0
        e2 = jax.lax.dynamic_slice_in_dim(p2a, c0, chunk) - p0
        mine = jax.lax.dynamic_slice_in_dim(mida, c0, chunk) == m
        d = ray.direction[:, None, :]
        pv = jnp.cross(d, e2[None])
        det = jnp.sum(e1[None] * pv, axis=-1)
        inv = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
        tv = ray.origin[:, None, :] - p0[None]
        u = jnp.sum(tv * pv, axis=-1) * inv
        qv = jnp.cross(tv, e1[None])
        v = jnp.sum(d * qv, axis=-1) * inv
        t = jnp.sum(e2[None] * qv, axis=-1) * inv
        # two-sided, any sign of t (crossings behind the origin count:
        # a ray starting inside clamps its entry to 0 below)
        valid = (mine[None] & (jnp.abs(det) > 1e-10) & (u >= 0.0)
                 & (v >= 0.0) & (u + v <= 1.0) & (t > -1e30))
        tt = jnp.where(valid, t, big)
        # merge this chunk's two smallest into the running (t1, t2)
        c_min = jnp.min(tt, axis=1)
        tt2 = jnp.where(tt <= c_min[:, None] + 1e-4, big, tt)
        c_second = jnp.min(tt2, axis=1)
        all4 = jnp.stack([t1, t2, c_min, c_second], axis=1)
        t1 = jnp.min(all4, axis=1)
        all4b = jnp.where(all4 <= t1[:, None] + 1e-4, big, all4)
        t2 = jnp.min(all4b, axis=1)
        return t1, t2

    t1, t2 = jax.lax.fori_loop(0, n_chunks, chunk_body, (t1, t2))
    ok = (t1 < big) & (t2 < big)
    return t1, t2, ok


def _apply_media(scene: Scene, ray: Ray, sampler: RaySampler, surf: Hit) -> Hit:
    """Override the surface hit with a nearer in-scattering event, if any.

    Exponential free-flight inside each homogeneous medium (math of
    ``constant_medium.h:19-50``; sphere/box analytic, mesh boundaries via
    :func:`_mesh_medium_crossings`); with unit ray directions the
    t-parameter *is* the distance, so no length rescaling is needed.
    """
    hit = surf
    for m in range(scene.n_media):
        oc = ray.origin - scene.med_center[m]
        # Sphere boundary crossings.
        b = dot(oc, ray.direction)
        c = jnp.sum(oc * oc, axis=-1) - scene.med_radius[m] ** 2
        disc = b * b - c
        sq = safe_sqrt(disc)  # NaN-free backward on miss lanes
        sph_in, sph_out = -b - sq, -b + sq
        sph_ok = disc > 0.0
        # Box boundary crossings (slab test against the half-extents).
        inv_d = 1.0 / jnp.where(jnp.abs(ray.direction) < 1e-20, 1e-20,
                                ray.direction)
        tt0 = (-scene.med_half[m] - oc) * inv_d
        tt1 = (scene.med_half[m] - oc) * inv_d
        box_in = jnp.max(jnp.minimum(tt0, tt1), axis=-1)
        box_out = jnp.min(jnp.maximum(tt0, tt1), axis=-1)
        box_ok = box_out > box_in

        is_box = scene.med_kind[m] == 1
        t_in = jnp.where(is_box, box_in, sph_in)
        t_out = jnp.where(is_box, box_out, sph_out)
        ok = jnp.where(is_box, box_ok, sph_ok)
        if scene.med_tri_p0 is not None:
            mesh_in, mesh_out, mesh_ok = _mesh_medium_crossings(scene, ray, m)
            is_mesh = scene.med_kind[m] == 2
            t_in = jnp.where(is_mesh, mesh_in, t_in)
            t_out = jnp.where(is_mesh, mesh_out, t_out)
            ok = jnp.where(is_mesh, mesh_ok, ok)
        # Boundary crossings from -inf (constant_medium.h:23): entry clamps
        # to 0 when the ray starts inside.
        t_enter = jnp.maximum(t_in, 0.0)
        t_exit = jnp.minimum(t_out, hit.t)
        inside = ok & (t_exit > t_enter)

        u = jnp.maximum(sampler.uniform(_DIM_MEDIUM + m), 1e-12)
        free_flight = -jnp.log(u) / scene.med_density[m]
        t_sc = t_enter + free_flight
        scatters = inside & (free_flight < (t_exit - t_enter))

        med_hit = Hit(
            t=t_sc, hit=scatters, p=ray.at(t_sc),
            normal=jnp.broadcast_to(np.array([1.0, 0.0, 0.0], np.float32),
                                    ray.origin.shape),
            uv=np.zeros(ray.origin.shape[:-1] + (2,), np.float32),
            mat=jnp.full(ray.origin.shape[:-1], scene.med_mat[m], jnp.int32))
        hit = hit.closer_of(med_hit)
    return hit


def bounce_step(scene: Scene, state: dict, max_depth: int,
                rr_start: int, flags=None,
                pdf_floor: float = 1e-9, pallas_mode: str = "off") -> dict:
    """One path-tracing bounce for every lane of a wavefront.

    ``state`` keys: ``o d time beta radiance alive salt depth`` — ``salt``
    is the per-lane RaySampler stream (a pure function of pixel/sample ids)
    and ``depth`` the per-lane bounce index, so the same step serves both
    the fixed ``lax.scan`` integrator (:func:`trace`, all lanes in depth
    lockstep) and the regeneration engine (:mod:`srt.render.regen`,
    lanes at different depths). ``pallas_mode`` (static) selects the
    triangle traversal kernel; this function is the XLA reference of the
    fused bounce kernel (``pallas/bounce.py``).
    """
    depth = state["depth"]
    s = RaySampler(salt=state["salt"]).fold(depth)
    r = Ray(origin=state["o"], direction=state["d"], time=state["time"])
    alive = state["alive"]
    beta = state["beta"]
    radiance = state["radiance"]

    hit = intersect_scene(scene, r, 1e-3, _BIG, flags, pallas_mode)
    if scene.n_media:
        hit = _apply_media(scene, r, s, hit)
    # Sanitize miss lanes before shading: a zero normal (degenerate
    # ONB) or far-plane position would create inf/NaN *intermediates*
    # whose backward partials poison gradients even under masking.
    up = jnp.broadcast_to(np.array([0.0, 0.0, 1.0], np.float32),
                          hit.normal.shape)
    hit = hit._replace(
        p=where3(hit.hit, hit.p, r.origin),
        normal=where3(hit.hit & (jnp.sum(hit.normal * hit.normal, -1)
                                 > 1e-12), hit.normal, up))

    # Emission (added whether or not the path continues,
    # Raytracing_n.cpp:61,94,99).
    emit = mats.emitted(scene, hit.mat, hit.uv, hit.p, hit.normal,
                        r.direction, flags)
    radiance = radiance + jnp.where((alive & hit.hit)[:, None],
                                    beta * emit, 0.0)

    scatters = hit.hit & mats.is_scattering(scene, hit.mat)
    from srt.scene.ir import MaterialType, has_mat
    any_specular = (has_mat(flags, MaterialType.METAL)
                    or has_mat(flags, MaterialType.DIELECTRIC)
                    or has_mat(flags, MaterialType.ISOTROPIC))
    specular = scatters & mats.is_specular(scene, hit.mat) \
        if any_specular else jnp.zeros_like(scatters)
    diffuse = scatters & ~specular

    # --- specular branch (Raytracing_n.cpp:66-70) -------------------
    if any_specular:
        u_spec = jnp.stack([s.uniform(_DIM_SPEC + i) for i in range(4)], -1)
        spec_dir, spec_atten = mats.scatter_specular(
            scene, hit.mat, hit.p, hit.normal, hit.uv, r.direction, u_spec,
            flags)
    else:
        spec_dir, spec_atten = r.direction, jnp.zeros_like(beta)

    # --- diffuse branch: mixture-PDF NEE (Raytracing_n.cpp:71-94) ---
    parity = flags is not None and flags.ref_parity
    if parity:
        # Reference parity: cosine_pdf/onrennayar_pdf::generate flip the
        # lobe *into* the surface for front hits (pdf.h:47-52, 103-110),
        # so their value() is 0 and the integrator's while(pdf==0) loop
        # (Raytracing_n.cpp:79-83) retries until the mixture picks the
        # light. Net behavior for Lambertian and Oren-Nayar:
        # light-sampling only, weighted by the full 50/50 mixture pdf.
        # Beckmann's own frame is consistent, so it keeps real BSDF
        # sampling — but its below-horizon samples (pdf 0) are *also*
        # retried, which the resample rounds below emulate.
        from srt.scene.ir import MaterialType as MT
        t_mat = scene.mat_type[hit.mat]
        light_only = ((t_mat == MT.LAMBERTIAN)
                      | (t_mat == MT.OREN_NAYAR))
        is_beck = t_mat == MT.BECKMANN
        # beckmann_pdf is STATEFUL through the heap: generate() writes
        # *pdf_value (a 4-byte malloc), value() reads it, and color()
        # deletes the object every bounce (Raytracing_n.cpp:92). Round 4
        # modeled the slot as carrying the previous draw's pdf; round-5
        # instrumentation of the actual binary (GOLDEN.md r5: a BPLOG
        # build logging every slot construction/store/read) FALSIFIED
        # that: free() overwrites the chunk's first bytes with glibc's
        # safe-linked tcache next pointer, so the previous value survives
        # construction only 1.8% of the time (coincidence). Measured
        # as-implemented distribution at construction: 91.4% a constant
        # garbage float (|x| ~ 1e38 — the scrambled pointer; the mixture
        # pdf becomes ~ +-1e38 and the sample contributes ~0 WITHOUT
        # retrying) and 8.6% exactly 0.0 (fresh zero page; the mixture
        # term drops to 0.5*light_pdf). Within one bounce's retry loop
        # the slot DOES hold this bounce's last stored pdf (same chunk,
        # no intervening free). Model: per-bounce Bernoulli slot init
        # (_PARITY_SLOT_ZERO_P) with _PARITY_KILL as the garbage;
        # BSDF-branch rounds refresh it for later rounds of the SAME
        # bounce. No cross-bounce carry.
        u_slot = s.uniform(_DIM_SLOT)
        if getattr(flags, "parity_no_stale", False):
            # diagnostic pairing with the zero-init C++ A/B build
            stale = jnp.zeros_like(r.time)
        else:
            stale = jnp.where(u_slot < _PARITY_SLOT_ZERO_P, 0.0,
                              _PARITY_KILL)

    def draw(dim_mix, dim_pick, dim_s, stale_in=None):
        """One mixture draw -> (wi, pdf, stale'). Fresh dims per round."""
        u1 = s.uniform(dim_s)
        u2 = s.uniform(dim_s + 1)
        # Both samples are attached, so the gradient is the derivative of
        # this exact estimator (what central finite differences of the
        # loss measure, and what the backward kernel computes): the
        # Beckmann VNDF direction moves with alpha, and cone/area light
        # directions move with light position/size (BASELINE config 5).
        # Detaching the BSDF lobe dropped the first term and gave a wrong
        # roughness gradient; the sampler's sqrt/divide guards are
        # grad-safe (core/vecmath.safe_sqrt, gsdiv) so the backward stays
        # finite at its clamps.
        bsdf_dir = mats.sample_bsdf(scene, hit.mat, hit.normal, r.direction,
                                    u1, u2, flags)
        if scene.n_lights:
            light_dir = lights.sample_lights(scene, hit.p,
                                             s.uniform(dim_pick), u1, u2)
            pick_light = s.uniform(dim_mix) < 0.5
            if parity:
                pick_light = pick_light | light_only
            wi = where3(pick_light, light_dir, bsdf_dir)
            bpdf = mats.bsdf_pdf(scene, hit.mat, hit.normal,
                                 r.direction, wi, flags)
            if parity and stale_in is not None:
                # At the sampled direction bpdf equals the stored
                # *pdf_value; light-branch Beckmann lanes read the stale
                # heap value instead (see above). Evaluate bpdf at the
                # BSDF direction for the stale refresh even on light
                # lanes — the reference's generate() is only skipped on
                # the light branch, so only BSDF draws refresh.
                bpdf_at_sample = mats.bsdf_pdf(scene, hit.mat, hit.normal,
                                               r.direction, bsdf_dir, flags)
                took_bsdf = is_beck & ~pick_light
                stale_out = jnp.where(took_bsdf, bpdf_at_sample, stale_in)
                bpdf = jnp.where(is_beck & pick_light, stale_in, bpdf)
            else:
                stale_out = stale_in
            pdf = 0.5 * lights.lights_pdf(scene, hit.p, wi) + 0.5 * bpdf
        else:
            wi = bsdf_dir
            pdf = mats.bsdf_pdf(scene, hit.mat, hit.normal, r.direction,
                                wi, flags)
            stale_out = stale_in
        return wi, pdf, stale_out

    wi, pdf, stale_new = draw(_DIM_MIX, _DIM_LIGHT_PICK, _DIM_SAMPLE,
                              stale if parity else None)
    if parity:
        # Emulate the reference's unbounded while(pdf==0) retry
        # (Raytracing_n.cpp:79-83) with a bounded resample: rounds
        # re-draw branch + sample for still-zero lanes (residual
        # probability of all rounds failing is ~(p_fail)^K, negligible).
        for rnd in range(_PARITY_RETRIES):
            base = (_DIM_RETRY + 4 * rnd if rnd < 4
                    else _DIM_RETRY_EXT + 4 * (rnd - 4))
            need = pdf <= 0.0
            wi2, pdf2, stale2 = draw(base, base + 1, base + 2, stale_new)
            wi = where3(need, wi2, wi)
            pdf = jnp.where(need, pdf2, pdf)
            # retried lanes' generate() calls also refresh the heap slot
            stale_new = jnp.where(need, stale2, stale_new)
    weight = mats.bsdf_weight(scene, hit.mat, hit.uv, hit.p, hit.normal,
                              r.direction, wi, flags)
    # Below-floor pdfs contribute zero (the reference instead retries,
    # Raytracing_n.cpp:79-83). The default 1e-9 floor is effectively
    # unbiased; a larger floor (RenderConfig.pdf_floor) trades a little
    # dim bias for killing the weight/pdf fireflies that near-zero
    # mixture pdfs produce on specular-coat + textured paths.
    ok = pdf > pdf_floor
    diff_beta = jnp.where(ok[:, None],
                          weight / jnp.maximum(pdf, pdf_floor)[:, None], 0.0)

    # --- merge branches ---------------------------------------------
    new_dir = where3(specular, spec_dir, wi)
    beta_scale = where3(specular, spec_atten, diff_beta)
    new_beta = beta * beta_scale
    new_alive = alive & scatters & (jnp.max(new_beta, axis=-1) > 0.0)

    # Russian roulette (ours; reference uses only the depth cap).
    if rr_start < max_depth:
        q = jnp.clip(jnp.max(new_beta, axis=-1), 0.05, 1.0)
        do_rr = depth >= rr_start
        survive = s.uniform(_DIM_RR) < q
        new_alive = new_alive & (~do_rr | survive)
        new_beta = jnp.where((do_rr & new_alive)[:, None],
                             new_beta / q[:, None], new_beta)

    out = dict(
        o=where3(alive & scatters, hit.p, state["o"]),
        d=where3(alive & scatters, new_dir, state["d"]),
        time=state["time"],
        beta=jnp.where(alive[:, None], new_beta, beta),
        radiance=radiance,
        alive=new_alive & alive,
        salt=state["salt"],
        depth=depth + 1,
    )
    if parity:
        out["stale"] = stale_new
    return out


def trace(scene: Scene, ray: Ray, sampler: RaySampler, max_depth: int = 16,
          rr_start: int = 64, with_aux: bool = False, flags=None,
          pdf_floor: float = 1e-9, stale0=None, return_stale: bool = False,
          pallas_mode: str = "off"):
    """Estimate radiance for a wavefront of primary rays -> (N, 3).

    Bounded ``lax.scan`` over :func:`bounce_step` with every lane in depth
    lockstep — the reverse-differentiable engine (the regeneration engine
    in :mod:`srt.render.regen` is the faster forward-only one).

    ``rr_start``: bounce index where Russian roulette begins (the reference
    uses a hard depth-50 cap and no roulette, ``Raytracing_n.cpp:42,63``;
    set ``rr_start >= max_depth`` for reference-equivalent behavior).

    ``with_aux``: also return device-side metrics counters
    (``alive_per_bounce`` (max_depth,), ``path_vertices``, ``nan_scrubbed``)
    for :class:`srt.utils.RenderMetrics`.

    ``stale0``/``return_stale``: thread the parity heap-slot carry in and
    out (the thread-faithful sequential-sample golden mode,
    ``api.RenderConfig.seq_stale``). ``pallas_mode`` (static,
    ``pallas/common.kernel_mode``) dispatches the fused bounce and
    traversal kernels for eligible scenes — forward-only, so the
    differentiable engines must keep the default.
    """
    n = ray.origin.shape[0]
    state = dict(
        o=ray.origin, d=ray.direction, time=ray.time,
        beta=np.ones((n, 3), np.float32),
        radiance=np.zeros((n, 3), np.float32),
        alive=np.ones((n,), bool),
        salt=sampler.salt,
        depth=np.zeros((n,), np.int32),
    )
    if flags is not None and flags.ref_parity:
        # the heap-recycled beckmann_pdf slot (see bounce_step parity)
        state["stale"] = (stale0 if stale0 is not None
                          else np.zeros((n,), np.float32))

    from srt.pallas.bounce import fused_bounce, fused_bounce_available
    use_kernel = fused_bounce_available(flags, pallas_mode)

    def step(state):
        if use_kernel:
            return fused_bounce(scene, state, max_depth, rr_start, flags,
                                pdf_floor, mode=pallas_mode)
        return bounce_step(scene, state, max_depth, rr_start, flags,
                           pdf_floor, pallas_mode)

    if return_stale:
        # forward-only sequential-golden path: a while_loop with early
        # exit skips the ~max_depth/mean-depth dead-lane bounces the
        # static scan would grind through (the diff engines need the
        # scan; this path never differentiates)
        assert not with_aux, "return_stale and with_aux are exclusive"

        def w_cond(carry):
            i, st = carry
            return (i < max_depth) & jnp.any(st["alive"])

        def w_body(carry):
            i, st = carry
            return i + 1, step(st)

        _, state = jax.lax.while_loop(w_cond, w_body, (jnp.int32(0), state))
        return de_nan(state["radiance"]), state.get("stale")

    def bounce(state, _):
        n_alive = jnp.sum(state["alive"].astype(jnp.int32))
        return step(state), n_alive

    state, alive_hist = jax.lax.scan(bounce, state, None, length=max_depth)
    # NaN scrub, as in de_nan (Raytracing_n.cpp:47-53) — counted, not silent.
    radiance = state["radiance"]
    out = de_nan(radiance)
    if not with_aux:
        return out
    aux = {
        "alive_per_bounce": alive_hist,
        "path_vertices": jnp.sum(alive_hist.astype(jnp.uint32)),
        "nan_scrubbed": jnp.sum(jnp.isnan(radiance), dtype=jnp.uint32),
    }
    return out, aux
