"""Component-separated 3-vectors: the renderer's vector layout.

An ``(N, 3)`` array interleaves components along its minor dimension,
so elementwise math on one component strides through memory and a
kernel lane block cannot hold one component per lane.  The hot path
therefore carries vectors as a ``V3`` named tuple of three contiguous
``(N,)`` arrays — the layout the fused kernel's 1-D lane blocks and
XLA's elementwise fusions both want; ``(N, 3)`` appears only at public
API boundaries.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax


class V3(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # -- arithmetic (component-wise; scalars broadcast) --
    def __add__(self, o):
        return V3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return V3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def scale(self, s):
        return V3(self.x * s, self.y * s, self.z * s)

    def mul(self, o: "V3") -> "V3":
        return V3(self.x * o.x, self.y * o.y, self.z * o.z)


def dot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def norm2(a: V3):
    return dot(a, a)


def normalize(a: V3) -> V3:
    return a.scale(lax.rsqrt(norm2(a)))


def safe_normalize(a: V3) -> V3:
    """normalize with a zero-vector guard (returns 0)."""
    n2 = norm2(a)
    inv = jnp.where(n2 > 0, lax.rsqrt(jnp.where(n2 > 0, n2, 1.0)), 0.0)
    return a.scale(inv)


def where(c, a: V3, b: V3) -> V3:
    return V3(jnp.where(c, a.x, b.x), jnp.where(c, a.y, b.y),
              jnp.where(c, a.z, b.z))


def splat(arr) -> V3:
    """(..., 3) -> V3 of (...,) components (API boundary, in)."""
    return V3(arr[..., 0], arr[..., 1], arr[..., 2])


def pack(v: V3):
    """V3 -> (..., 3) (API boundary, out)."""
    return jnp.stack([v.x, v.y, v.z], axis=-1)


def const(vec, like) -> V3:
    """A (3,) constant broadcast as a V3 against ``like``'s shape."""
    z = jnp.zeros_like(like)
    return V3(z + vec[0], z + vec[1], z + vec[2])


def full_like(like, v: float) -> V3:
    a = jnp.full_like(like, v)
    return V3(a, a, a)
