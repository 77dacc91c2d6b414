"""Complex magnitude (JAX) — alpha-max-beta-min approximation.

Array form of rtl/src/magnitude_calc.vhd: |Z| ~ max(|I|,|Q|) +
0.375*min(|I|,|Q|) as whole-array elementwise ops.  The fixed path uses the exact
truncating-shift formula (min/4 + min/8); the float path the same weights.
"""

from __future__ import annotations

import jax.numpy as jnp


def magnitude_float(re: jnp.ndarray, im: jnp.ndarray,
                    exact: bool = False) -> jnp.ndarray:
    """Float magnitude map.  ``exact=True`` uses sqrt(I^2+Q^2) (the framework
    can afford it — one elementwise op — but alpha-max-beta-min is the default for
    level-compatibility with the reference)."""
    if exact:
        return jnp.hypot(re, im)
    ai, aq = jnp.abs(re), jnp.abs(im)
    return jnp.maximum(ai, aq) + 0.375 * jnp.minimum(ai, aq)


def magnitude_fixed(i: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """Bit-exact integer magnitude (magnitude_calc.vhd:70-88): max + min>>2 +
    min>>3, int32 (17-bit range)."""
    ai = jnp.abs(i.astype(jnp.int32))
    aq = jnp.abs(q.astype(jnp.int32))
    mx = jnp.maximum(ai, aq)
    mn = jnp.minimum(ai, aq)
    return mx + (mn >> 2) + (mn >> 3)
