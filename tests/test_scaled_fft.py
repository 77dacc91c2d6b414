"""Stage-scaled fixed-point FFT — the QUICK-mode XFFT variants' "scaled"
arithmetic (xfft_128.xci / xfft_32.xci: scaling_options="scaled",
convergent rounding, 16-bit phase factors, bit-reversed or natural output),
modeled as golden/fixed_point.scaled_fft with the JAX twin
ops/fft.scaled_fft_apply (design_notes §3).  The reference's config word
x"0001" (rtl/src/radar_core.vhd:247) programs an all-zero scale schedule.
"""

import numpy as np
import pytest

from fmcw_tpu.golden import fixed_point as fx


def _jax_scaled(i, q, **kw):
    from fmcw_tpu.ops import fft as F
    a, b = F.scaled_fft_apply(np.asarray(i), np.asarray(q), axis=-1, **kw)
    return np.asarray(a), np.asarray(b)


def test_closed_form_dc_and_impulse():
    """Closed-form cases that involve NO rounding: a DC vector with the
    1-per-stage schedule halves exactly each stage -> [c, 0, ...]; an
    impulse at index 0 rides only k=0 (bypassed) twiddles -> every bin
    exactly A, any schedule-0 stage."""
    n = 32
    m = 5
    c = 1234
    i = np.full(n, c, np.int64)
    q = np.zeros(n, np.int64)
    ir, qr = fx.scaled_fft(i, q, scale_sch=[1] * m)
    want = np.zeros(n, np.int64)
    want[0] = c
    assert np.array_equal(ir, want) and np.array_equal(qr, np.zeros(n))
    # Impulse, zero schedule (the as-wired x"0001" config): exact A at all
    # bins in both components' roles (A real -> all-real output).
    a = 21111
    i2 = np.zeros(n, np.int64)
    i2[0] = a
    ir2, qr2 = fx.scaled_fft(i2, np.zeros(n, np.int64), scale_sch=[0] * m)
    assert np.array_equal(ir2, np.full(n, a))
    assert np.array_equal(qr2, np.zeros(n))


def test_matches_float_dft_within_rounding():
    """With the conventional 1-per-stage schedule the output is fft(x)/n up
    to accumulated convergent-rounding error (a few LSB per stage)."""
    rng = np.random.default_rng(0)
    n = 128
    m = 7
    i = rng.integers(-20000, 20000, n)
    q = rng.integers(-20000, 20000, n)
    ir, qr = fx.scaled_fft(i, q, scale_sch=[1] * m)
    zf = np.fft.fft(i + 1j * q) / n
    assert np.max(np.abs(ir - zf.real)) < 8
    assert np.max(np.abs(qr - zf.imag)) < 8


def test_zero_schedule_wraps():
    """scale_sch=0 with large inputs overflows and WRAPS (scaled XFFT
    arithmetic has no saturation) — outputs stay int16-ranged but are not
    the true transform."""
    rng = np.random.default_rng(1)
    n = 64
    i = rng.integers(-32000, 32000, n)
    q = rng.integers(-32000, 32000, n)
    ir, qr = fx.scaled_fft(i, q)
    assert ir.min() >= -32768 and ir.max() <= 32767
    zf = np.fft.fft(i + 1j * q)
    assert np.max(np.abs(zf.real)) > 32767     # the true value overflows
    assert not np.allclose(ir, np.clip(zf.real, -32768, 32767), atol=4)


def test_output_ordering():
    rng = np.random.default_rng(2)
    n = 16
    i = rng.integers(-1000, 1000, n)
    q = rng.integers(-1000, 1000, n)
    nat = fx.scaled_fft(i, q, scale_sch=[1] * 4, output_order="natural")
    rev = fx.scaled_fft(i, q, scale_sch=[1] * 4, output_order="bit_reversed")
    perm = fx.bit_reverse_permutation(n)
    assert np.array_equal(nat[0], rev[0][perm])
    assert np.array_equal(nat[1], rev[1][perm])
    assert np.array_equal(perm[perm], np.arange(n))     # self-inverse


@pytest.mark.parametrize("n,sch", [
    (8, None), (32, None), (128, None),
    (32, [1, 0, 2, 0, 1]), (128, [1] * 7),
])
def test_jax_twin_bit_exact(n, sch):
    """ops/fft.scaled_fft_apply == golden scaled_fft bit-for-bit, including
    full-scale inputs that wrap (the int32 8-bit-split product path) and
    multi-row batches, both output orders."""
    rng = np.random.default_rng(n)
    i = rng.integers(-32768, 32768, (3, n))
    q = rng.integers(-32768, 32768, (3, n))
    for order in ("natural", "bit_reversed"):
        gi, gq = fx.scaled_fft(i, q, scale_sch=sch, output_order=order)
        ji, jq = _jax_scaled(i, q, scale_sch=None if sch is None
                             else tuple(sch), output_order=order)
        assert np.array_equal(gi, ji), (n, sch, order)
        assert np.array_equal(gq, jq), (n, sch, order)


def test_pipeline_scaled_knob_matches_golden():
    """mode='fixed' with fixed_fft='scaled': the XLA chain reproduces the
    golden scaled-FFT chain bit-for-bit (mag map, detections)."""
    import jax
    import fmcw_tpu
    from fmcw_tpu.golden import reference
    from fmcw_tpu.models import pipeline as pl

    p = fmcw_tpu.quick()
    z = reference.two_target_frame(p, seed=5)
    gm, gd = reference.process_frame_fixed(z, p, fft="scaled")
    proc = pl.make_processor(p, mode="fixed", fixed_fft="scaled",
                             include_maps=True)
    out = jax.tree.map(np.asarray, proc(pl.complex_to_iq(z)))
    assert np.array_equal(out["mag_map"], gm)
    assert np.array_equal(out["det_map"] > 0, gd > 0)
    assert out["valid"].any()


def test_pipeline_scaled_knob_validation():
    import fmcw_tpu
    from fmcw_tpu.models import pipeline as pl
    p = fmcw_tpu.quick()
    with pytest.raises(ValueError, match="mode='fixed'"):
        pl.make_processor(p, mode="float32", fixed_fft="scaled")
    with pytest.raises(ValueError, match="no compiled route"):
        pl.make_processor(p, mode="fixed", fixed_fft="scaled",
                          fft_method="pallas")
    with pytest.raises(ValueError, match="bfp"):
        pl.make_processor(p, mode="fixed", fixed_fft="nope")
