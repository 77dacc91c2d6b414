"""Beamforming (JAX) — element-space to beam-space as one matmul.

The reference processes a single receive channel; its angle dimension exists
only as the BASELINE config-4 "angle-bin extension" consumed by the 3D CFAR
(ops/cfar.cfar_3d).  This module supplies that dimension for array radars: a
uniform-linear-array phase-shift beamformer expressed as one complex matmul
over the element axis — a (B, E) steering matrix against (E, n_doppler,
n_range) element-space I/Q, which XLA hands to a GEMM and fuses with the
surrounding pipeline stages.

Conventions: element spacing ``spacing_wl`` in wavelengths (default λ/2),
beams steered to ``sin(theta)`` values ``u`` in [-sin(max_angle),
+sin(max_angle)], conventional (delay-and-sum) weights with an optional
amplitude taper.  Golden numpy model: tests/test_aux.py mirrors the matmul
with an explicit per-beam loop.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


@functools.lru_cache(maxsize=16)
def steering_matrix(n_elems: int, n_beams: int, spacing_wl: float = 0.5,
                    max_angle_deg: float = 60.0, taper: str | None = None,
                    dtype=np.float32):
    """(real, imag) of the (n_beams, n_elems) conventional beamforming weight
    matrix W[b, e] = t[e] * exp(-j*2*pi*spacing_wl*e*u_b), with u_b the beam's
    steering sine, uniformly spaced over [-sin(max_angle), sin(max_angle)].

    ``taper``: None (uniform) or "hamming" (sidelobe taper across elements,
    reusing the window definition of ops/window.hamming_float).
    """
    if n_beams == 1:
        # A single beam points broadside (linspace(-a, a, 1) would return
        # [-a] and silently steer it to -max_angle).
        u = np.zeros(1)
    else:
        u = np.linspace(-np.sin(np.deg2rad(max_angle_deg)),
                        np.sin(np.deg2rad(max_angle_deg)), n_beams)
    e = np.arange(n_elems)
    phase = -2.0 * np.pi * spacing_wl * np.outer(u, e)
    t = np.ones(n_elems)
    if taper == "hamming":
        from .window import hamming_float
        t = np.asarray(hamming_float(n_elems), dtype=np.float64)
    elif taper is not None:
        raise ValueError(taper)
    wr = (np.cos(phase) * t).astype(dtype)
    wi = (np.sin(phase) * t).astype(dtype)
    return wr, wi


def beamform(re: jnp.ndarray, im: jnp.ndarray, n_beams: int,
             spacing_wl: float = 0.5, max_angle_deg: float = 60.0,
             taper: str | None = None,
             precision=jax.lax.Precision.HIGHEST):
    """Element-space to beam-space: (n_elems, ...) complex I/Q pair ->
    (n_beams, ...) via y_b = sum_e W[b, e] * x_e (4 real matmuls)."""
    n_elems = re.shape[0]
    wr, wi = steering_matrix(n_elems, n_beams, spacing_wl, max_angle_deg,
                             taper)
    wr, wi = jnp.asarray(wr), jnp.asarray(wi)
    dn = (((1,), (0,)), ((), ()))

    def mm(w, x):
        return jax.lax.dot_general(w, x, dimension_numbers=dn,
                                   preferred_element_type=jnp.float32,
                                   precision=precision)

    return mm(wr, re) - mm(wi, im), mm(wr, im) + mm(wi, re)


def beam_cube(re: jnp.ndarray, im: jnp.ndarray, n_beams: int,
              magnitude_exact: bool = False, **kw) -> jnp.ndarray:
    """Convenience: element-space I/Q (n_elems, n_doppler_or_range, ...) ->
    per-beam magnitude cube (n_beams, ...) ready for ops.cfar.cfar_3d."""
    from .magnitude import magnitude_float
    br, bi = beamform(re, im, n_beams, **kw)
    return magnitude_float(br, bi, exact=magnitude_exact)
