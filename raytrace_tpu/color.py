"""Radiometry substrate: linear-RGB color algebra and sRGB conversion.

Data-parallel equivalent of the reference's ``src/color.rs`` (SURVEY.md §2 #6).
Colors are not a struct — they are trailing ``(..., 3)`` axes of jnp arrays,
so all color algebra is ordinary fused elementwise work.

The reference carries two lookup tables:

* ``SRGB_VALUES[256]``  (color.rs:75-332)  — linear value of each sRGB byte.
* ``SRGB_AVERAGE[255]`` (color.rs:335-591) — midpoints of adjacent
  ``SRGB_VALUES`` entries, used by the encoder ``to_srgb``
  (color.rs:593-600): the encoded byte is the smallest ``i`` with
  ``val < SRGB_AVERAGE[i]`` (else 255), i.e. nearest-value rounding.

Both tables are exactly the IEC 61966-2-1 sRGB EOTF evaluated in f64, so we
generate them from the closed form instead of shipping 500 lines of
constants, and implement the encoder as a vectorized ``searchsorted`` —
bit-identical to the reference's linear scan (verified in
tests/test_color.py), but O(log n) per lane and fully batched.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def _srgb_decode_f64(byte_over_255: np.ndarray) -> np.ndarray:
    """IEC 61966-2-1 sRGB electro-optical transfer function in f64."""
    c = byte_over_255
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


# SRGB_VALUES[i] = linear RGB value for sRGB byte i (reference color.rs:75-332).
SRGB_VALUES = _srgb_decode_f64(np.arange(256, dtype=np.float64) / 255.0)

# SRGB_AVERAGE[i] = midpoint between consecutive decode values
# (reference color.rs:335-591); the decision thresholds of the encoder.
SRGB_AVERAGE = 0.5 * (SRGB_VALUES[:-1] + SRGB_VALUES[1:])

BLACK = np.zeros(3)  # color.rs:25


def significance(color: jnp.ndarray) -> jnp.ndarray:
    """``r + g + b`` over the trailing color axis (color.rs:637-639).

    Used to gate shading work / recursion against MIN_SIGNIFICANCE.
    """
    return jnp.sum(color, axis=-1)


def to_srgb(val: jnp.ndarray, *, dtype=None) -> jnp.ndarray:
    """Encode linear values to sRGB bytes, matching color.rs:593-600 exactly.

    The reference returns the smallest ``i`` such that
    ``val < SRGB_AVERAGE[i]``, falling through to 255.  That is precisely
    ``searchsorted(SRGB_AVERAGE, val, side='right')``: the insertion point
    after any run of thresholds equal to ``val`` (ties: ``val == avg[i]``
    fails the strict ``<`` and moves on, exactly like the reference).

    NaN input encodes as 255 (all comparisons false in the reference's
    scan => falls through to 255; searchsorted sorts NaN past the end).
    """
    thresholds = jnp.asarray(SRGB_AVERAGE, dtype=dtype or val.dtype)
    return jnp.searchsorted(thresholds, val, side="right").astype(jnp.uint8)


def from_srgb(byte: jnp.ndarray, *, dtype=jnp.float32) -> jnp.ndarray:
    """Decode sRGB bytes to linear values via the table (color.rs:611-613)."""
    table = jnp.asarray(SRGB_VALUES, dtype=dtype)
    return table[byte.astype(jnp.int32)]


def linear_rgb_bytes(val: jnp.ndarray) -> jnp.ndarray:
    """Linear clamp-to-byte variant (color.rs:617-625, ``rgb()``/``bgr()``).

    ``trunc(val * 255)`` clamped to [0, 255]; unused by the reference driver
    but part of its public color API.
    """
    x = val * 255.0
    return jnp.clip(jnp.trunc(x), 0.0, 255.0).astype(jnp.uint8)
