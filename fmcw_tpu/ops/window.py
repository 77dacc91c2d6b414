"""Window kernels (JAX) — Hamming window multiply.

Array reformulation of rtl/src/window_multiplier.vhd: instead of a
per-sample coefficient-ROM pipeline, the window is a vector constant applied
to a whole frame axis.  In the float pipeline the window is folded directly
into the DFT matrix (zero-cost); the standalone ops here serve the fixed-point
(bit-faithful) pipeline and tests.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..golden import fixed_point as fx


def hamming_q15(n: int, coef_width: int = 16) -> np.ndarray:
    """Full-length Q15 integer Hamming coefficients — identical to the
    reference ROM contents + symmetric addressing (window_multiplier.vhd:34-53,
    96-104).  Numpy constant; becomes an XLA literal when closed over."""
    return fx.hamming_coeffs(n, coef_width)


def hamming_float(n: int, coef_width: int = 16) -> np.ndarray:
    """Float window equal to the Q15 ROM contents scaled by the hardware's
    effective Q14 extraction gain (coef / 2^14, up to ~2.0)."""
    return hamming_q15(n, coef_width).astype(np.float32) / float(1 << (coef_width - 2))


def window_apply_fixed(i: jnp.ndarray, q: jnp.ndarray, coeffs, coef_width: int = 16,
                       rounding: str = "unbiased"):
    """Bit-exact integer window multiply (window_multiplier.vhd:119-163) in
    JAX: int32 product path with the same rounding constant and int16
    saturation as the golden model.  Returns (i_out, q_out, sat_count).

    The inputs are int32-valued arrays; ``coeffs`` broadcasts along the
    windowed axis.  sat_count is the number of saturated samples — the
    framework's analog of the sticky saturation_flag
    (window_multiplier.vhd:151-158, radar_core.vhd:447-456).
    """
    shift = coef_width - 2
    rnd = (1 << shift) if rounding == "biased" else (1 << (shift - 1))
    c = jnp.asarray(coeffs, dtype=jnp.int32)

    def one(x):
        p = x.astype(jnp.int32) * c
        shifted = (p + rnd) >> shift
        sat = (shifted > fx.INT16_MAX) | (shifted < fx.INT16_MIN)
        return jnp.clip(shifted, fx.INT16_MIN, fx.INT16_MAX), jnp.sum(sat)

    i_out, si = one(i)
    q_out, sq = one(q)
    return i_out, q_out, si + sq
