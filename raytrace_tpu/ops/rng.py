"""Counter-based, sharding-invariant RNG for the wavefront renderer.

Data-parallel replacement of the reference's sequential ``XorShiftRng`` stream
(types.rs:27, seeded at main.rs:43).  A sequential stream is the single
worst primitive for a data-parallel renderer: every sample would depend on
every previous draw.  Instead, every random number is a *pure function of
its identity*: ``u = U(seed; pixel_id, sample_id, depth, purpose, lane)``.

Consequences (all by construction):

* reproducible: one integer seed reproduces the whole render;
* order-independent: bounce loop order / tiling do not change any draw;
* sharding-invariant: a tile-sharded ``shard_map`` render produces
  bit-identical images to the single-device render, because draws depend
  on global pixel ids carried with each ray, never on array position;
* zero cross-lane communication.

Exact bitwise parity with the reference's time-seeded XorShift stream is
impossible by design (the reference itself is not reproducible run-to-run,
main.rs:43); only statistical parity with out.bmp is meaningful
(SURVEY.md §4).

Two backends:

* ``mix`` (default, the renderer's only production backend): 2-round
  splitmix32-style integer mixer.  Pure uint32 VPU arithmetic, extremely
  cheap, quality far above the reference's XorShift for Monte-Carlo
  purposes.
* ``threefry``: jax.random (threefry2x32) via per-lane fold-in.  Slower;
  exists solely as the independent statistical cross-check oracle in
  tests/test_rng.py (uniformity / independence / rendered-mean
  agreement within MC error).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Purpose ids — one independent stream family per use site.
PURPOSE_AA_X = 0       # main.rs:51 jitter
PURPOSE_AA_Y = 1       # main.rs:52 jitter
PURPOSE_LENS_THETA = 2  # camera.rs:115
PURPOSE_LENS_R = 3      # camera.rs:117
# Per-light purposes occupy [64, 64 + 2L); per-indirect-sample purposes
# occupy [1 << 16, ...) so the ranges can never collide for any scene.
PURPOSE_LIGHT_U = 64     # scene.rs:153 (area light, first draw)
PURPOSE_LIGHT_V = 65     # scene.rs:153 (area light, second draw)
PURPOSE_INDIRECT_R1 = 1 << 16  # raytrace.rs:101
PURPOSE_INDIRECT_R2 = (1 << 16) + 1  # raytrace.rs:102

_GAMMA = np.uint32(0x9E3779B9)  # golden-ratio increment


def _mix32(x: jnp.ndarray) -> jnp.ndarray:
    """splitmix32 finalizer: a high-quality 32-bit bijective mixer."""
    x = (x ^ (x >> 16)) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> 15)) * np.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _seed_u32(seed):
    """Seed -> uint32, preserving static Python ints as numpy scalars
    (a jnp constant would be closure-captured by Pallas kernels) while
    still accepting traced seeds (sharded/optimizer paths)."""
    if isinstance(seed, (int, np.integer)):
        return np.uint32(seed)
    return seed.astype(jnp.uint32)


def hash_words(seed: int | jnp.ndarray, *words: jnp.ndarray) -> jnp.ndarray:
    """Hash integer identity words into uniform random uint32 bits.

    ``words`` broadcast against each other; each is absorbed with a
    distinct golden-ratio offset then mixed, sponge-style.
    """
    h = _seed_u32(seed) ^ np.uint32(0x243F6A88)  # pi fractional bits
    for i, w in enumerate(words):
        h = _mix32(h + w.astype(jnp.uint32)
                   + np.uint32((0x9E3779B9 * (2 * i + 1)) & 0xFFFFFFFF))
    return _mix32(h)


def to_float(u: jnp.ndarray, dtype) -> jnp.ndarray:
    """uint32 -> float cast for values < 2**31, via int32 (the signed
    conversion is the one every backend and kernel route lowers)."""
    return u.astype(jnp.int32).astype(dtype)


def uniform_from_bits(bits: jnp.ndarray, dtype) -> jnp.ndarray:
    """Map uint32 bits to uniforms in [0, 1)."""
    if jnp.dtype(dtype) == jnp.float64:
        hi = to_float(bits >> np.uint32(6), jnp.float64)  # 26 bits
        lo = _mix32(bits + _GAMMA) >> np.uint32(5)       # 27 bits
        return (hi * (1 << 27) + to_float(lo, jnp.float64)) * (2.0 ** -53)
    return to_float(bits >> np.uint32(8), dtype) * np.asarray(2.0 ** -24, dtype)


def u01(seed, *words, dtype=jnp.float32, backend: str = "mix") -> jnp.ndarray:
    """Uniform [0, 1) draw identified by ``words`` (counter-based)."""
    if backend == "threefry":
        return _u01_threefry(seed, *words, dtype=dtype)
    return uniform_from_bits(hash_words(seed, *words), dtype)


_GAMMA2 = np.uint32(0xBB67AE85)  # sqrt(3) fractional bits


def make_keys(seed: int, *words: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Derive a 64-bit-per-lane stream identity (two uint32 words) from
    integer identity words (e.g. pixel id, sample id).

    Two independently-salted sponges give an effective 64-bit node id so
    that stream collisions are negligible even at billions of wavefront
    nodes (a single 32-bit id would collide constantly at 655M primary
    samples/frame, BASELINE.md)."""
    k1 = hash_words(_seed_u32(seed) ^ np.uint32(0x243F6A88), *words)
    k2 = hash_words(_seed_u32(seed) ^ np.uint32(0x85A308D3), *words)
    return k1, k2


def derive(k1: jnp.ndarray, k2: jnp.ndarray, slot: int):
    """Child-stream derivation for wavefront branching: each child slot
    (reflect / refract / indirect sample k) gets an independent stream."""
    s = np.uint32(slot + 1)
    return (_mix32(k1 + np.uint32((0x9E3779B9 * int(s)) & 0xFFFFFFFF)),
            _mix32(k2 ^ np.uint32((0xBB67AE85 * int(s)) & 0xFFFFFFFF)))


def draw(k1: jnp.ndarray, k2: jnp.ndarray, purpose: int, dtype) -> jnp.ndarray:
    """One uniform [0,1) draw from stream (k1,k2) for a static purpose id."""
    bits = _mix32(k1 ^ _mix32(
        k2 + np.uint32((0x9E3779B9 * (purpose + 1)) & 0xFFFFFFFF)))
    return uniform_from_bits(bits, dtype)


def _u01_threefry(seed, *words, dtype=jnp.float32) -> jnp.ndarray:
    key = jax.random.key(seed) if isinstance(seed, int) else seed
    ws = jnp.broadcast_arrays(*[w.astype(jnp.uint32) for w in words])
    flat = [w.reshape(-1) for w in ws]

    def one(*scalars):
        k = key
        for s in scalars:
            k = jax.random.fold_in(k, s)
        return jax.random.uniform(k, dtype=dtype)

    out = jax.vmap(one)(*flat)
    return out.reshape(ws[0].shape)
