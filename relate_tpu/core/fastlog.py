"""Bit-exact JAX port of the reference's fast_log approximation.

The reference uses a polynomial float32 log approximation in every hot loop
(``include/src/fast_log.hpp:6-21``). Replicating it bit-for-bit keeps the
distance matrices (and thus tree-builder decisions) numerically aligned with
the C++ oracle in differential tests. It is two bitcasts and a fused
polynomial, which XLA fuses into the surrounding elementwise work.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

LN2 = np.float32(0.69314718)


def fast_log2(val):
    """float32 -> float32, identical to fast_log2 in fast_log.hpp."""
    val = jnp.asarray(val, jnp.float32)
    x = val.view(jnp.int32)
    log_2 = ((x >> 23) & 255) - 128
    x = x & ~jnp.int32(255 << 23)
    x = x + jnp.int32(127 << 23)
    m = x.view(jnp.float32)
    m = ((jnp.float32(-1.0 / 3) * m + 2) * m - jnp.float32(2.0 / 3))
    return m + log_2.astype(jnp.float32)


def fast_log(val):
    """Natural-log version (fast_log.hpp:20-22)."""
    return fast_log2(val) * LN2
