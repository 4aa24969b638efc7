"""Hand-written GPU kernels (Pallas, Triton route) and their dispatch.

``common`` holds the static kernel choice and the launch shape; ``bounce``
the fused bounce, ``bounce_vjp`` its custom VJP (XLA backward);
``intersect`` the per-ray triangle BVH traversal.
"""
