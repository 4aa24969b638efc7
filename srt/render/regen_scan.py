"""Reverse-differentiable path regeneration: ``lax.scan`` over a persistent
wavefront with a *static* step budget.

Round-2 VERDICT item 4: the differentiable engine
(:func:`srt.render.integrator.trace`) marches every lane through all
``max_depth`` bounces — at the reference's depth 50 the wavefront is ~95%
dead lanes and the train step crawls (104k rays/s measured). The forward
regen engine (:mod:`srt.render.regen`) fixes that with a
work-queue ``while_loop``, which JAX cannot reverse-differentiate.

This engine is the bridge: the same lane-regeneration body, but driven by a
``lax.scan`` of **static length** ``n_steps`` — reverse-differentiable, and
each step does useful work on a (nearly) full wavefront. The step budget is
sized from a mean-depth estimate: ``n_steps = ceil(N * depth_budget / M) +
max_depth`` (the ``+ max_depth`` drains the tail). Paths that exhaust the
budget are *truncated*: their partial radiance is flushed and counted — the
estimator stays consistent (same contract as a depth cap), and with a sane
budget the truncated fraction is ~0 (asserted in tests by exact agreement
with the scan engine).

Per-step ``jax.checkpoint`` keeps backward memory at one wavefront state
per step boundary with the bounce recomputed, instead of storing every
intermediate of every bounce.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from srt.core.ray import Ray
from srt.core.vecmath import where3
from srt.render.integrator import bounce_step
from srt.scene.ir import Scene


@partial(jax.jit, static_argnames=("n_steps", "wavefront", "max_depth",
                                   "rr_start", "flags", "pdf_floor",
                                   "checkpoint", "unroll", "pallas_mode",
                                   "frozen_geometry"))
def trace_queue(scene: Scene, rays: Ray, salts, *, n_steps: int,
                wavefront: int, max_depth: int, rr_start: int = 1 << 30,
                flags=None, pdf_floor: float = 1e-9,
                checkpoint: bool | None = None,
                unroll: int = 1, pallas_mode: str = "off",
                frozen_geometry: bool = False):
    """Trace a queue of N primary rays -> ((N, 3) radiance, (N,) finished).

    ``finished`` is 1.0 for rays whose path terminated naturally inside the
    budget, else the ray's entry is its truncated partial radiance with
    ``finished`` still counted (= 1.0) once flushed at the end; rays never
    started (budget far too small) report 0 radiance / 0 finished.

    ``pallas_mode`` (static, ``pallas/common.kernel_mode``) selects the
    kernel forward (``pallas/bounce_vjp.bounce_step_hybrid``; its backward
    is the XLA linearization).
    """
    n = rays.origin.shape[0]
    m = min(wavefront, n)

    # Fused-kernel forward with an XLA backward (pallas/bounce_vjp.py):
    # same static dispatch story as regen.py — `pallas_mode` rides the jit
    # cache key, the heavy eligibility test is in SceneFlags. The diff
    # engines run roulette-free (rr_start default).
    from srt.pallas.bounce import fused_bounce_available
    from srt.pallas.bounce_vjp import bounce_step_hybrid
    use_hybrid = fused_bounce_available(flags, pallas_mode)
    if checkpoint is None:
        # With the hybrid custom-VJP bounce the saved residuals are just
        # the input states (small), and skipping jax.checkpoint's forward
        # replay measured +11% train throughput; the pure-XLA bounce's
        # residuals are every shading intermediate, where rematerializing
        # is the only thing that fits in HBM at 256^2-scale queues.
        checkpoint = not use_hybrid

    parity = flags is not None and flags.ref_parity
    zeros3 = jnp.zeros((m, 3), jnp.float32)
    state = dict(
        cursor=jnp.int32(0),
        rid=jnp.zeros((m,), jnp.int32),
        o=zeros3, d=zeros3.at[:, 2].set(1.0),
        time=jnp.zeros((m,), jnp.float32),
        beta=zeros3, radiance=zeros3,
        alive=jnp.zeros((m,), bool),
        salt=jnp.zeros((m,), jnp.uint32),
        depth=jnp.zeros((m,), jnp.int32),
    )
    if parity:
        state["stale"] = jnp.zeros((m,), jnp.float32)

    def substep(st):
        # --- regenerate dead lanes from the queue (regen.py:88-114) ------
        prev_stale = st.get("stale")
        need = ~st["alive"]
        k = jnp.cumsum(need.astype(jnp.int32))
        wid = st["cursor"] + k - 1
        take = need & (wid < n)
        src = jnp.clip(wid, 0, n - 1)
        rid = jnp.where(take, src, st["rid"])
        st = dict(
            cursor=st["cursor"] + jnp.sum(take.astype(jnp.int32)),
            rid=rid,
            o=where3(take, rays.origin[src], st["o"]),
            d=where3(take, rays.direction[src], st["d"]),
            time=jnp.where(take, rays.time[src], st["time"]),
            beta=where3(take, jnp.ones_like(st["beta"]), st["beta"]),
            radiance=where3(take, jnp.zeros_like(st["radiance"]),
                            st["radiance"]),
            alive=st["alive"] | take,
            salt=jnp.where(take, salts[src], st["salt"]),
            depth=jnp.where(take, 0, st["depth"]),
        )
        if parity:
            st["stale"] = prev_stale
        started_ids = jnp.where(take, src, n)  # n = no-op slot

        # --- one bounce ---------------------------------------------------
        was_alive = st["alive"]
        subkeys = ("o", "d", "time", "beta", "radiance", "alive", "salt",
                   "depth") + (("stale",) if parity else ())
        substate = {k2: st[k2] for k2 in subkeys}
        if use_hybrid:
            nxt = bounce_step_hybrid(scene, substate, max_depth, rr_start,
                                     flags, pdf_floor, pallas_mode,
                                     frozen_geometry)
        else:
            nxt = bounce_step(scene, substate, max_depth, rr_start, flags,
                              pdf_floor, pallas_mode)
        alive = nxt["alive"] & (nxt["depth"] < max_depth)

        # --- emit finished paths as stacked scan outputs -----------------
        # (NOT via a (N,3) accumulator in the carry: the carry is saved per
        # step for the backward pass, which at 256^2-scale queues overflows
        # HBM; stacked (steps, m, 3) outputs are small and scatter once.)
        finished = was_alive & ~alive
        contrib = jnp.where(finished[:, None], nxt["radiance"], 0.0)
        contrib = jnp.where(jnp.isnan(contrib), 0.0, contrib)

        new_st = dict(cursor=st["cursor"], rid=st["rid"], o=nxt["o"],
                      d=nxt["d"], time=nxt["time"], beta=nxt["beta"],
                      radiance=nxt["radiance"], alive=alive,
                      salt=nxt["salt"], depth=nxt["depth"])
        if parity:
            new_st["stale"] = nxt["stale"]
        return new_st, (st["rid"], contrib, started_ids)

    def step(st, _):
        # ``unroll`` bounces per scanned (and checkpointed) step: the
        # per-step fixed overhead and the checkpoint state save amortize
        # over K bounces at the cost of K recomputed bounces in the
        # backward pass (recompute is forward-cost, cheap next to the
        # saved-state traffic at small wavefronts).
        outs = []
        for _k in range(unroll):
            st, out = substep(st)
            outs.append(out)
        stacked = jax.tree.map(lambda *x: jnp.stack(x), *outs)
        return st, stacked

    body = jax.checkpoint(step) if checkpoint else step
    n_outer = -(-n_steps // unroll)
    state, (rids, contribs, started_ids) = jax.lax.scan(
        body, state, None, length=n_outer)

    # Budget-exhausted lanes: flush their truncated partial radiance.
    tail = jnp.where(state["alive"][:, None], state["radiance"], 0.0)
    tail = jnp.where(jnp.isnan(tail), 0.0, tail)

    out = jnp.zeros((n, 3), jnp.float32)
    out = out.at[rids.reshape(-1)].add(contribs.reshape(-1, 3))
    out = out.at[state["rid"]].add(tail)
    started = jnp.zeros((n + 1,), jnp.float32)
    started = started.at[started_ids.reshape(-1)].add(1.0)[:n]
    return out, started


def steps_for(n_rays: int, wavefront: int, depth_budget: float,
              max_depth: int, drain: int | None = None) -> int:
    """Static step budget: queue-drain steps at the expected mean path
    length plus a ``drain`` tail for the last wavefront's stragglers.

    ``drain=None`` uses the bias-free full ``max_depth`` tail; training
    typically passes a small drain (paths past the budget are truncated —
    same contract as a depth cap, negligible at sane budgets) because a
    full tail can dominate the step count when ``n_rays/wavefront`` is
    small (e.g. +50 steps on a 9-step queue — the round-3 trainbench
    regression)."""
    m = min(wavefront, n_rays)
    tail = max_depth if drain is None else min(drain, max_depth)
    return int(-(-int(n_rays * depth_budget) // m)) + tail
