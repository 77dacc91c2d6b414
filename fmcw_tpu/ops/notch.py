"""MTI clutter notch (JAX) — slow-time pulse canceller.

Array reformulation of rtl/src/doppler_notch.vhd: the per-range-bin
delay-line FSM becomes a shifted-array difference along the chirp axis of the
whole (range-major) frame.  Saturation applies in the fixed path only.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..golden.fixed_point import INT16_MIN, INT16_MAX


def _delayed(x: jnp.ndarray, k: int, axis: int) -> jnp.ndarray:
    pad = [(0, 0)] * x.ndim
    pad[axis] = (k, 0)
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(0, x.shape[axis])
    return jnp.pad(x, pad)[tuple(sl)]


def _zero_transient(y: jnp.ndarray, mode: int, axis: int) -> jnp.ndarray:
    idx = jnp.arange(y.shape[axis])
    shape = [1] * y.ndim
    shape[axis] = y.shape[axis]
    mask = (idx >= mode - 1).reshape(shape)
    return y * mask


def mti_notch_float(re: jnp.ndarray, im: jnp.ndarray, axis: int = -1,
                    mode: int = 2, bypass=False, transient: str = "zero"):
    """Float MTI canceller: y = x - x_1 (2-pulse) or x - 2x_1 + x_2 (3-pulse)
    along ``axis`` (doppler_notch.vhd:72-94), transient chirps zeroed by
    default (docs/design_notes.md §2).  ``bypass`` may be a traced bool —
    the runtime mti_bypass control port (radar_core.vhd:48)."""

    def one(x):
        if mode == 2:
            y = x - _delayed(x, 1, axis)
        else:
            y = x - 2.0 * _delayed(x, 1, axis) + _delayed(x, 2, axis)
        if transient == "zero":
            y = _zero_transient(y, mode, axis)
        return jnp.where(bypass, x, y)

    return one(re), one(im)


def mti_notch_fixed(i: jnp.ndarray, q: jnp.ndarray, axis: int = -1,
                    mode: int = 2, bypass=False, transient: str = "zero"):
    """Bit-exact integer MTI canceller with int16 saturation
    (doppler_notch.vhd:75-93)."""

    def one(x):
        x = x.astype(jnp.int32)
        if mode == 2:
            y = x - _delayed(x, 1, axis)
        else:
            y = x - 2 * _delayed(x, 1, axis) + _delayed(x, 2, axis)
        y = jnp.clip(y, INT16_MIN, INT16_MAX)
        if transient == "zero":
            y = _zero_transient(y, mode, axis)
        return jnp.where(bypass, x, y)

    return one(i), one(q)
