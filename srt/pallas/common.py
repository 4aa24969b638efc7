"""Kernel choice and the launch shape shared by the GPU kernels.

Every kernel in this package is written for Pallas' Triton route: one
program per block of ``BLOCK`` lanes, lane state as 1-D ``(n,)`` arrays,
scene tables as whole arrays in global memory read as scalars (uniform
loads) or per-lane gathers. On the CPU the same kernels run through the
Pallas interpreter, which is how the tests reach them.

The kernel choice is one static string, resolved outside ``jit`` by
:func:`kernel_mode` and passed down the engines' static arguments
(``pallas_mode``), so it is part of every jit cache key:

* ``"gpu"``       — compiled Triton kernels (the default on a GPU);
* ``"interpret"`` — the same kernels through the interpreter (CPU only);
* ``"off"``       — the plain XLA reference everywhere.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

# Lanes per program. Power of two (Triton's block rule); 128 lanes at
# 4 warps is one lane per thread, which keeps the big shading kernels'
# register demand per thread at its minimum.
BLOCK = 128
NUM_WARPS = 4


def kernel_mode(requested: str | None = None) -> str:
    """Resolve ``SRT_PALLAS`` (``auto`` | ``off`` | ``interpret``) to the
    static kernel choice for this process's backend.

    ``auto`` selects the compiled kernels on a GPU and the XLA path
    elsewhere. ``interpret`` is refused off the CPU: the interpreter is a
    test vehicle, and a GPU run must never time it by accident."""
    req = requested or os.environ.get("SRT_PALLAS", "auto")
    backend = jax.default_backend()
    if req == "auto":
        return "gpu" if backend == "gpu" else "off"
    if req == "interpret":
        if backend != "cpu":
            raise ValueError(
                f"SRT_PALLAS=interpret runs kernels on the CPU interpreter "
                f"only; this process's backend is {backend!r}")
        return "interpret"
    if req == "off":
        return "off"
    raise ValueError(f"SRT_PALLAS={req!r}: expected auto, off or interpret")


def pad_lanes(x, n_pad: int, dtype, fill=0):
    """``(n,)`` -> ``(n_pad,)`` lane array of ``dtype``, tail = ``fill``."""
    x = jnp.asarray(x, dtype)
    return jnp.pad(x, (0, n_pad - x.shape[0]), constant_values=fill)


def padded(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def lane_call(kernel, tables, lanes, out_dtypes, *, mode: str, name: str):
    """Launch ``kernel`` over ``BLOCK``-lane programs.

    ``tables`` are whole arrays in global memory (any shape: the kernel
    indexes them with scalars or per-lane index vectors); ``lanes`` are
    ``(n_pad,)`` arrays cut into blocks; one ``(n_pad,)`` output per entry
    of ``out_dtypes``."""
    if mode not in ("gpu", "interpret"):
        raise ValueError(f"kernel launched with pallas_mode={mode!r}")
    n_pad = lanes[0].shape[0]
    whole = pl.BlockSpec(memory_space=pl.ANY)
    lane = pl.BlockSpec((BLOCK,), lambda i: (i,))
    return pl.pallas_call(
        kernel,
        grid=(n_pad // BLOCK,),
        in_specs=[whole] * len(tables) + [lane] * len(lanes),
        out_specs=[lane] * len(out_dtypes),
        out_shape=[jax.ShapeDtypeStruct((n_pad,), dt) for dt in out_dtypes],
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=NUM_WARPS,
                                            num_stages=1),
        interpret=mode == "interpret",
        name=name,
    )(*tables, *lanes)
