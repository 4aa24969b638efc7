"""srt — a differentiable wavefront Monte-Carlo path tracer in JAX.

A from-scratch re-design of the capabilities of the reference C++ renderer
``truemeat001/Simple-Raytracing-Render`` (see SURVEY.md) as an idiomatic
JAX/XLA/Pallas framework:

* SoA scene buffers + integer material/texture tags instead of a virtual
  dispatch scene graph (reference: ``Raytracing_n/hitable.h``).
* A wavefront integrator — a bounded ``lax.scan`` over bounces with masked
  lanes — instead of the recursive megakernel ``color()``
  (reference: ``Raytracing_n/Raytracing_n.cpp:55-106``).
* Counter-based functional RNG (``jax.random``) instead of a global, racy
  ``drand48`` seed (reference: ``Raytracing_n/mathf.h:12``).
* ``shard_map`` over a device mesh for multi-chip/multi-host scaling instead
  of a mutex-guarded pixel counter (reference: ``Raytracing_n.cpp:815-879``).
* End-to-end gradients to material/emission/light parameters (no reference
  analogue).
"""

__version__ = "0.1.0"

from srt.render.api import render, RenderConfig  # noqa: F401
