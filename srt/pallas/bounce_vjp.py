"""Custom VJP for the fused bounce: kernel forward, XLA backward.

The reverse-differentiable regeneration engine
(:mod:`srt.render.regen_scan`) runs the fused bounce kernel
(``pallas/bounce.py``) forward; the kernel has no transpose, so ``bwd``
linearizes the XLA ``bounce_step`` at the saved input and applies the
cotangents — the exact gradient of the estimator with none of it
re-derived by hand.

(A one-launch backward kernel — ``jax.vjp`` of the shading core inside a
Triton kernel — matched this backward and finite differences on the card
but was 5% slower per train step and compiled for ~2 minutes per scene;
it was removed, PERF.md.)

No reference analogue (the C++ renderer is forward-only,
``Raytracing_n/Raytracing_n.cpp``); this serves the BASELINE config-5
inverse-rendering capability.
"""
from __future__ import annotations

from functools import partial

import jax

from srt.pallas.bounce import fused_bounce


@partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4, 5, 6, 7))
def bounce_step_hybrid(scene, state, max_depth, rr_start, flags,
                       pdf_floor, mode="gpu", frozen_geometry=False):
    """Drop-in for ``bounce_step`` on kernel-eligible scenes, reverse-
    differentiable (kernel forward / XLA backward). Statics (depth/
    roulette/flags/floor/kernel mode/frozen-geometry) are nondiff
    positional args so the VJP pair sees them unchanged."""
    return fused_bounce(scene, state, max_depth, rr_start, flags,
                        pdf_floor, mode=mode)


def _fwd(scene, state, max_depth, rr_start, flags, pdf_floor, mode,
         frozen_geometry):
    out = fused_bounce(scene, state, max_depth, rr_start, flags,
                       pdf_floor, mode=mode)
    return out, (scene, state)


def _bwd(max_depth, rr_start, flags, pdf_floor, mode, frozen_geometry,
         res, ct):
    from srt.render.integrator import bounce_step
    scene, state = res

    if frozen_geometry:
        # Caller guarantees no geometric param is optimized, so those
        # cotangents are zero by definition — detaching geometry INSIDE
        # the backward recompute lets XLA dead-code-eliminate the whole
        # intersection transpose. (Detaching it on the *primal* scene
        # instead turns the values into checkpoint-saved residuals and
        # measured slower — see diff/inverse.image_loss.)
        from srt.diff.inverse import freeze_geometry

        def f(sc, st):
            return bounce_step(freeze_geometry(sc), st, max_depth,
                               rr_start, flags, pdf_floor, pallas_mode=mode)
    else:
        def f(sc, st):
            return bounce_step(sc, st, max_depth, rr_start, flags,
                               pdf_floor, pallas_mode=mode)

    _, vjp_fn = jax.vjp(f, scene, state)
    return vjp_fn(ct)


bounce_step_hybrid.defvjp(_fwd, _bwd)
