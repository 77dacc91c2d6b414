"""FFT stages (JAX) — DFT-as-matmul GEMMs, plus the XLA FFT (cuFFT).

The reference uses Xilinx XFFT streaming IP (rtl/src/radar_core.vhd:79-127).
The radar's transform sizes (1024-pt range, 128-pt Doppler) are small enough
that a dense DFT matmul is one (batch, N) @ (N, N) GEMM per axis, batched over
128 chirps / 1024 range bins, with the window folded into the matrix — and,
crucially, it contracts over *either* axis without materializing a transpose
(the single-device corner turn folds into the Doppler matmul's dimension
numbers).  Which formulation is fastest on the card ("matmul", "ct" or the
XLA FFT) is measured, not assumed (ROADMAP A3).

``bfp_quantize`` applies the framework's block-floating-point semantics
(golden/fixed_point.bfp_fft) to emulate the reference's int16 inter-stage
format on device.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp


@functools.lru_cache(maxsize=16)
def dft_matrices(n: int, window: bool = False, coef_width: int = 16,
                 dtype=np.float32):
    """(cos, -sin) DFT matrices C[s, k] = exp(-2j*pi*s*k/n), optionally
    pre-multiplied by the Q15 Hamming window along the sample axis (folding
    the window_multiplier stage into the transform for free)."""
    s = np.arange(n)[:, None].astype(np.float64)
    k = np.arange(n)[None, :].astype(np.float64)
    ang = -2.0 * np.pi * s * k / n
    cr, ci = np.cos(ang), np.sin(ang)
    if window:
        from .window import hamming_float
        w = hamming_float(n, coef_width).astype(np.float64)[:, None]
        cr, ci = cr * w, ci * w
    return cr.astype(dtype), ci.astype(dtype)


def dft_apply(re: jnp.ndarray, im: jnp.ndarray, axis: int, window: bool = False,
              precision=jax.lax.Precision.HIGHEST):
    """Forward DFT along ``axis`` of a complex array given as (re, im) float32
    pair, as 4 real matmuls: Xr = xr@Cr - xi@Ci; Xi = xr@Ci + xi@Cr."""
    n = re.shape[axis]
    cr, ci = dft_matrices(n, window=window)
    cr, ci = jnp.asarray(cr), jnp.asarray(ci)
    dn = (((axis % re.ndim,), (0,)), ((), ()))

    def mm(x, c):
        y = jax.lax.dot_general(x, c, dimension_numbers=dn,
                                preferred_element_type=jnp.float32,
                                precision=precision)
        # dot_general moves the contracted axis's result dim to the end;
        # restore the original axis position.
        return jnp.moveaxis(y, -1, axis % re.ndim)

    xr_cr = mm(re, cr)
    xr_ci = mm(re, ci)
    xi_cr = mm(im, cr)
    xi_ci = mm(im, ci)
    return xr_cr - xi_ci, xr_ci + xi_cr


@functools.lru_cache(maxsize=16)
def _ct_factors(n: int, dtype=np.float32):
    """Constants for the two-stage Cooley-Tukey split n = n1*n2 with n1 as
    large as 128: (n1, n2, DFT_n1 matrices, DFT_n2
    matrices, twiddle (n1, n2) re/im)."""
    n1 = 128
    while n % n1:
        n1 //= 2
    n2 = n // n1
    c1r, c1i = dft_matrices(n1, dtype=dtype)
    c2r, c2i = dft_matrices(n2, dtype=dtype)
    k1 = np.arange(n1)[:, None].astype(np.float64)
    m2 = np.arange(n2)[None, :].astype(np.float64)
    ang = -2.0 * np.pi * k1 * m2 / n
    return (n1, n2, c1r, c1i, c2r, c2i,
            np.cos(ang).astype(dtype), np.sin(ang).astype(dtype))


def ct_apply(re: jnp.ndarray, im: jnp.ndarray, axis: int, window: bool = False,
             precision=jax.lax.Precision.HIGHEST):
    """Forward FFT along ``axis`` via the four-step Cooley-Tukey
    factorization n = n1*n2 (n1 <= 128): a full-width DFT_n1 matmul (the
    heavy lifting, at 128-deep contraction), a twiddle
    elementwise multiply, a cheap DFT_n2 matmul, and an output reorder.  For
    n = 1024 this is ~4x less matmul work than the dense DFT matmul
    (2*n*sqrt-ish vs n^2 MACs per transform) at the same f32 precision.

    Falls back to the dense matmul when n <= 128 (already one full-depth
    GEMM there).
    """
    n = re.shape[axis]
    n1, n2, c1r, c1i, c2r, c2i, twr, twi = _ct_factors(n)
    if n2 == 1:
        return dft_apply(re, im, axis, window=window, precision=precision)
    if window:
        from .window import hamming_float
        w = jnp.asarray(hamming_float(n))
        shape = [1] * re.ndim
        shape[axis] = n
        w = w.reshape(shape)
        re, im = re * w, im * w

    # Move the transform axis last; view x[n] as x[n1, n2] (n = n1*n2 + n2
    # ordering: n1 strides n2).
    re = jnp.moveaxis(re, axis, -1)
    im = jnp.moveaxis(im, axis, -1)
    batch = re.shape[:-1]
    re = re.reshape(batch + (n1, n2))
    im = im.reshape(batch + (n1, n2))

    def cmatmul(xr, xi, cr, ci, dim):
        dn = (((dim % xr.ndim,), (0,)), ((), ()))

        def mm(x, c):
            y = jax.lax.dot_general(x, jnp.asarray(c), dimension_numbers=dn,
                                    preferred_element_type=jnp.float32,
                                    precision=precision)
            return jnp.moveaxis(y, -1, dim % xr.ndim)

        ar, bi_, cr_, di = mm(xr, cr), mm(xr, ci), mm(xi, cr), mm(xi, ci)
        return ar - di, bi_ + cr_

    # Step 1: DFT_n1 over the n1 axis (contraction depth n1).
    ar, ai = cmatmul(re, im, c1r, c1i, -2)
    # Step 2: twiddle W_n^(k1*m2).
    twr_, twi_ = jnp.asarray(twr), jnp.asarray(twi)
    br = ar * twr_ - ai * twi_
    bi = ar * twi_ + ai * twr_
    # Step 3: DFT_n2 over the n2 axis.
    xr, xi = cmatmul(br, bi, c2r, c2i, -1)
    # Step 4: X[k2*n1 + k1] = result[k1, k2] -> transpose + flatten.
    xr = jnp.swapaxes(xr, -1, -2).reshape(batch + (n,))
    xi = jnp.swapaxes(xi, -1, -2).reshape(batch + (n,))
    return jnp.moveaxis(xr, -1, axis), jnp.moveaxis(xi, -1, axis)


@functools.lru_cache(maxsize=16)
def doppler_matrices(n: int, notch_mode: int = 2, transient: str = "zero",
                     coef_width: int = 16, dtype=np.float32):
    """The whole slow-time chain folded into one matrix pair.

    Window multiply, MTI notch and Doppler DFT are all linear along the
    chirp axis, so they compose into a single operator
    ``M = H^T @ diag(w) @ E`` with ``E[s, k] = exp(-2j*pi*s*k/n)``, ``w`` the
    Q15 Hamming window and ``H`` the pulse-canceller matrix
    (doppler_notch.vhd:72-94: y[s] = x[s] - x[s-1] or x[s] - 2x[s-1] +
    x[s-2]; missing history reads as 0 = the "passthrough" transient, and
    ``transient="zero"`` zeroes the first notch_mode-1 output rows instead —
    docs/design_notes.md §2).  One matrix contraction then replaces three
    stages *and* the corner-turn transpose (contract the chirp axis of the
    chirp-major range-FFT output directly; the result axis lands last, i.e.
    range-major).  Returns (Mr_mti, Mi_mti, Mr_plain, Mi_plain); the plain
    pair folds only the window, for the runtime mti_bypass control.
    """
    s = np.arange(n)[:, None].astype(np.float64)
    k = np.arange(n)[None, :].astype(np.float64)
    ang = -2.0 * np.pi * s * k / n
    er, ei = np.cos(ang), np.sin(ang)
    from .window import hamming_float
    w = hamming_float(n, coef_width).astype(np.float64)[:, None]
    er_w, ei_w = er * w, ei * w                      # diag(w) @ E
    h = np.zeros((n, n))
    for r in range(n):
        h[r, r] = 1.0
        if r >= 1:
            h[r, r - 1] = -1.0 if notch_mode == 2 else -2.0
        if notch_mode == 3 and r >= 2:
            h[r, r - 2] = 1.0
    if transient == "zero":
        h[: notch_mode - 1, :] = 0.0
    return (np.ascontiguousarray((h.T @ er_w).astype(dtype)),
            np.ascontiguousarray((h.T @ ei_w).astype(dtype)),
            np.ascontiguousarray(er_w.astype(dtype)),
            np.ascontiguousarray(ei_w.astype(dtype)))


def doppler_apply(re: jnp.ndarray, im: jnp.ndarray, axis: int, bypass,
                  notch_mode: int = 2, transient: str = "zero",
                  precision=jax.lax.Precision.HIGHEST):
    """Fused Doppler stage (window + MTI + DFT, see doppler_matrices) along
    ``axis``.  ``bypass`` is the traced mti_bypass control — it selects the
    window-only matrix.  The transformed axis moves to the LAST result
    position (for the radar chain that *is* the corner turn: chirp-major in,
    range-major out, no transpose materialized)."""
    n = re.shape[axis]
    mr1, mi1, mr0, mi0 = doppler_matrices(n, notch_mode, transient)
    cr = jnp.where(bypass, jnp.asarray(mr0), jnp.asarray(mr1))
    ci = jnp.where(bypass, jnp.asarray(mi0), jnp.asarray(mi1))
    dn = (((axis % re.ndim,), (0,)), ((), ()))

    def mm(x, c):
        return jax.lax.dot_general(x, c, dimension_numbers=dn,
                                   preferred_element_type=jnp.float32,
                                   precision=precision)

    xr_cr = mm(re, cr)
    xr_ci = mm(re, ci)
    xi_cr = mm(im, cr)
    xi_ci = mm(im, ci)
    return xr_cr - xi_ci, xr_ci + xi_cr


def fft_apply(re: jnp.ndarray, im: jnp.ndarray, axis: int, window: bool = False,
              method: str = "matmul", precision=jax.lax.Precision.HIGHEST):
    """Forward FFT along ``axis``; method "matmul" (dense DFT GEMM), "ct"
    (two-stage Cooley-Tukey matmul — less matmul work for n > 128), or "xla"
    (jnp.fft.fft lowering).  The window, when requested, is folded into the
    matmul / applied as an elementwise multiply first."""
    if method == "matmul":
        return dft_apply(re, im, axis, window=window, precision=precision)
    if method == "ct":
        return ct_apply(re, im, axis, window=window, precision=precision)
    if method == "xla":
        if window:
            from .window import hamming_float
            w = jnp.asarray(hamming_float(re.shape[axis]))
            shape = [1] * re.ndim
            shape[axis] = re.shape[axis]
            w = w.reshape(shape)
            re, im = re * w, im * w
        z = jax.lax.complex(re, im)
        zf = jnp.fft.fft(z, axis=axis)
        return jnp.real(zf), jnp.imag(zf)
    raise ValueError(method)


def bfp_quantize(re: jnp.ndarray, im: jnp.ndarray, axis: int):
    """Per-transform block-floating-point quantization to int16 range
    (framework BFP semantics — golden/fixed_point.bfp_fft): right-shift so the
    per-slice peak |component| lands in [2^14, 2^15), round half-to-even,
    discard the exponent.  Returns float32 arrays holding integer values."""
    peak = jnp.maximum(jnp.abs(re), jnp.abs(im))
    peak = jnp.max(peak, axis=axis, keepdims=True)
    s = jnp.ceil(jnp.log2(jnp.maximum(peak, 1.0) / 32768.0))
    scale = jnp.exp2(-jnp.maximum(s, 0.0))

    def q(x):
        v = jnp.round(x * scale)  # round half-to-even (convergent)
        return jnp.clip(v, -32768.0, 32767.0)

    return q(re), q(im)


def scaled_fft_apply(re: jnp.ndarray, im: jnp.ndarray, axis: int,
                     scale_sch=None, output_order: str = "natural"):
    """Stage-scaled fixed-point FFT along ``axis`` — the JAX twin of
    golden/fixed_point.scaled_fft (the QUICK-mode XFFT variants' "scaled"
    arithmetic: radix-2 DIF, Q15 twiddles with the k=0 bypass, convergent
    rounding, per-stage scale_sch shifts, int16 WRAP on overflow;
    xfft_128.xci / design_notes §3).  Bit-exact vs the golden model
    (tests/test_scaled_fft.py), including wraps.

    Inputs/outputs are int16-ranged integer values carried in int32 arrays
    (any integer or float dtype in; int32 out).  The 33-bit twiddle
    products are computed exactly in int32 by an 8-bit twiddle split —
    no int64 anywhere, so the op runs unchanged on any backend.
    """
    ir = jnp.moveaxis(jnp.asarray(re), axis, -1).astype(jnp.int32)
    qr = jnp.moveaxis(jnp.asarray(im), axis, -1).astype(jnp.int32)
    n = ir.shape[-1]
    m = n.bit_length() - 1
    if 1 << m != n:
        raise ValueError(f"scaled_fft_apply needs a power-of-two length, "
                         f"got {n}")
    if scale_sch is None:
        scale_sch = [0] * m
    if len(scale_sch) != m:
        raise ValueError(f"scale_sch needs {m} entries, got {len(scale_sch)}")

    def rhe_shift(x, sh):
        if sh == 0:
            return x
        half = 1 << (sh - 1)
        fl = x >> sh
        rem = x - (fl << sh)
        return fl + (rem > half).astype(jnp.int32) \
            + ((rem == half) & (fl & 1 == 1)).astype(jnp.int32)

    def wrap16(x):
        return ((x + 32768) & 65535) - 32768

    def tw_mul(vr, vi, wr_h, wr_l, wi_h, wi_l):
        """Exact convergent-rounded Q15 complex twiddle product in int32:
        w split as w = w_h*2^8 + w_l (w_l in [0,256)); |v| <= 2^16, so
        v*w_h <= 2^24 and v*w_l <= 2^24 stay exact; the >>15 rounding is
        recomposed from the two partial sums without forming the 33-bit
        total."""
        def part(s_h, s_l):
            q0 = s_l >> 8
            r0 = s_l - (q0 << 8)                    # in [0, 256)
            u = s_h + q0
            fl = u >> 7
            rem = ((u & 127) << 8) + r0             # total mod 2^15
            return fl + (rem > 16384).astype(jnp.int32) \
                + ((rem == 16384) & (fl & 1 == 1)).astype(jnp.int32)
        tr = part(vr * wr_h - vi * wi_h, vr * wr_l - vi * wi_l)
        ti = part(vr * wi_h + vi * wr_h, vr * wi_l + vi * wr_l)
        return tr, ti

    for s in range(m):
        L = n >> s
        h = L >> 1
        sh = ir.shape[:-1] + (n // L, L)
        i2, q2 = ir.reshape(sh), qr.reshape(sh)
        ar, br = i2[..., :h], i2[..., h:]
        ai, bi = q2[..., :h], q2[..., h:]
        ur, ui = ar + br, ai + bi
        vr, vi = ar - br, ai - bi
        k = np.arange(h)
        ang = -2.0 * np.pi * k / L
        wr = np.clip(np.rint(32768.0 * np.cos(ang)), -32768, 32767)
        wi = np.clip(np.rint(32768.0 * np.sin(ang)), -32768, 32767)
        wr_h, wr_l = (wr.astype(np.int64) >> 8), (wr.astype(np.int64) & 255)
        wi_h, wi_l = (wi.astype(np.int64) >> 8), (wi.astype(np.int64) & 255)
        as32 = lambda a: jnp.asarray(a, jnp.int32)
        tr, ti = tw_mul(vr, vi, as32(wr_h), as32(wr_l),
                        as32(wi_h), as32(wi_l))
        # k = 0 twiddle bypass (W^0 = 1 exactly).
        k0 = jnp.asarray(k == 0)
        tr = jnp.where(k0, vr, tr)
        ti = jnp.where(k0, vi, ti)
        ssh = int(scale_sch[s])
        ir = wrap16(jnp.concatenate(
            [rhe_shift(ur, ssh), rhe_shift(tr, ssh)], axis=-1)).reshape(
                ir.shape)
        qr = wrap16(jnp.concatenate(
            [rhe_shift(ui, ssh), rhe_shift(ti, ssh)], axis=-1)).reshape(
                qr.shape)

    if output_order == "natural":
        from ..golden.fixed_point import bit_reverse_permutation
        perm = jnp.asarray(bit_reverse_permutation(n))
        ir, qr = ir[..., perm], qr[..., perm]
    elif output_order != "bit_reversed":
        raise ValueError(output_order)
    return jnp.moveaxis(ir, -1, axis), jnp.moveaxis(qr, -1, axis)
