"""Counter-based, stateless, shard-invariant RNG.

The reference uses a *global mutable* 48-bit LCG seed shared (and raced) by 8
threads (``Raytracing_n/mathf.h:12-24``) plus one PCG32 instance
(``Raytracing_n/rng.h:14-35``). Neither is usable under ``jit``/``shard_map``.

Here every random number is a pure function of
``(seed, pixel_id, sample_id, bounce, dimension)`` via a PCG-style integer
mixer evaluated elementwise on the device. Consequences:

* No cross-lane state: wavefronts of any width draw independent numbers.
* Bit-identical images regardless of device count or tile order — the
  distributed renderer's 1-chip vs N-chip equality test rests on this.
* No sequential dependence, so XLA freely vectorizes/fuses the draws.
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

_U32 = jnp.uint32


def _mix(x):
    """xxhash/PCG-style avalanche on uint32 lanes."""
    x = jnp.asarray(x, _U32)
    x = x ^ (x >> 16)
    x = x * _U32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * _U32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def hash_combine(a, b):
    """Combine two uint32 words into a well-mixed uint32.

    ``_mix`` is a bijection, so for fixed ``b`` this is collision-free in
    ``a`` (important: pixel ids must map to distinct streams).
    """
    a = jnp.asarray(a, _U32)
    b = jnp.asarray(b, _U32)
    return _mix(_mix(a) + (b ^ _U32(0x9E3779B9)))


def bits_to_uniform(bits):
    """uint32 -> float32 uniform in [0, 1) using the top 24 bits."""
    return (bits >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


class RaySampler(NamedTuple):
    """Per-ray random stream: a (N,) uint32 salt plus static dimension indices.

    Call sites pass a *static* ``dim`` so each decision (lens-u, lens-v,
    light-pick, bsdf-u1, ...) reads its own dimension of the stream —
    the functional analogue of the reference's sequential drand48() calls.
    """
    salt: jnp.ndarray  # (N,) uint32

    @staticmethod
    def create(seed: int, pixel_id, sample_id):
        s = hash_combine(jnp.asarray(pixel_id, _U32),
                         hash_combine(jnp.asarray(sample_id, _U32), _U32(seed)))
        return RaySampler(salt=s)

    def fold(self, word) -> "RaySampler":
        """Derive a sub-stream, e.g. per bounce index inside the scan."""
        return RaySampler(salt=hash_combine(self.salt, jnp.asarray(word, _U32)))

    def bits(self, dim: int):
        return hash_combine(
            self.salt, _U32((0xB5297A4D + 0x68E31DA4 * dim) & 0xFFFFFFFF))

    def uniform(self, dim: int):
        """(N,) float32 uniform in [0,1) for static dimension ``dim``."""
        return bits_to_uniform(self.bits(dim))

    def uniform2(self, dim: int):
        """(N, 2) float32 pair from dimensions ``dim`` and ``dim+1``."""
        return jnp.stack([self.uniform(dim), self.uniform(dim + 1)], axis=-1)

    def uniform3(self, dim: int):
        return jnp.stack([self.uniform(dim), self.uniform(dim + 1),
                          self.uniform(dim + 2)], axis=-1)
