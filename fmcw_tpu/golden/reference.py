"""Float64 reference chain and golden stimulus synthesis (pure numpy).

Two golden models exist (SURVEY.md section 4): this float64 model — the
mathematical ideal the detection-parity SNR bound is defined against — and the
bit-faithful fixed-point model in ``fixed_point.py``.  The float model runs the
same pipeline with exact arithmetic: float Hamming window, unscaled FFTs,
exact MTI difference, true sqrt magnitude (or the alpha-max-beta-min formula in
float), float CFAR.

Also synthesizes the reference's golden stimuli:

* ``two_target_frame``  <- rtl/old/tb_radar_core.vhd:37-44,101-141 — the frame
  that produced data/radar_output.txt: targets at range bin 100 (Doppler 5.0,
  amp 8000) and range bin 500 (Doppler -10.0, amp 5000), uniform noise +-20.
* ``tone_chirp``        <- data/golden_input_chirp.txt — a constant-frequency
  complex tone (amp ~16384).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..params import RadarParams
from . import fixed_point as fx


# ---------------------------------------------------------------------------
# Stimulus synthesis
# ---------------------------------------------------------------------------

def two_target_frame(params: RadarParams | None = None, seed: int = 1,
                     noise_floor: float = 20.0, targets=None) -> np.ndarray:
    """Synthesize the golden two-target CPI (rtl/old/tb_radar_core.vhd:101-141).

    Returns complex I/Q as an int16-valued complex128 array of shape
    (n_doppler, n_range) — chirp-major, as streamed into the core.

    phase_t = 2*pi*(range_bin * s / n_range + doppler * c / n_doppler);
    I += amp*cos, Q += amp*sin, plus uniform noise in [-noise_floor,
    +noise_floor], saturated to int16.  (The VHDL uses its own uniform() PRNG;
    noise is 52 dB below the peak so any uniform source is within the SNR
    bound.)

    ``targets``: list of (range_bin, doppler_bins, amplitude).  The default is
    the golden pair — range bins 100/500, Doppler 5/-10 at 1024x128 — scaled
    proportionally for other map shapes so bins stay in range.
    """
    p = params or RadarParams()
    if targets is None:
        targets = [(100 * p.n_range // 1024, 5.0 * p.n_doppler / 128, 8000.0),
                   (500 * p.n_range // 1024, -10.0 * p.n_doppler / 128, 5000.0)]
    c = np.arange(p.n_doppler)[:, None]
    s = np.arange(p.n_range)[None, :]
    i_acc = np.zeros((p.n_doppler, p.n_range))
    q_acc = np.zeros((p.n_doppler, p.n_range))
    for rbin, dopp, amp in targets:
        phase = 2.0 * np.pi * (rbin * s / p.n_range + dopp * c / p.n_doppler)
        i_acc += amp * np.cos(phase)
        q_acc += amp * np.sin(phase)
    rng = np.random.default_rng(seed)
    i_acc += noise_floor * (rng.random(i_acc.shape) - 0.5) * 2.0
    q_acc += noise_floor * (rng.random(q_acc.shape) - 0.5) * 2.0
    i_v = np.clip(np.trunc(i_acc), fx.INT16_MIN, fx.INT16_MAX)
    q_v = np.clip(np.trunc(q_acc), fx.INT16_MIN, fx.INT16_MAX)
    return i_v + 1j * q_v


def tone_chirp(n_samples: int = 2000, amp: float = 16384.0,
               freq: float = 0.2833) -> np.ndarray:
    """Constant-frequency complex tone like data/golden_input_chirp.txt."""
    n = np.arange(n_samples)
    z = amp * np.exp(2j * np.pi * freq * n)
    return (np.clip(np.round(z.real), fx.INT16_MIN, fx.INT16_MAX)
            + 1j * np.clip(np.round(z.imag), fx.INT16_MIN, fx.INT16_MAX))


# ---------------------------------------------------------------------------
# Float64 processing chain
# ---------------------------------------------------------------------------

def hamming_window_float(n: int) -> np.ndarray:
    """Ideal Hamming window 0.54 - 0.46*cos(2*pi*i/(N-1)), scaled by the
    reference's effective Q14 extraction gain of ~2 (window_multiplier.vhd:148)
    so float and fixed paths share absolute levels."""
    i = np.arange(n)
    w = 0.54 - 0.46 * np.cos(2.0 * np.pi * i / (n - 1))
    return w * (32767.0 / 16384.0)


@dataclasses.dataclass
class FloatChainResult:
    rdm_complex: np.ndarray     # (n_range, n_doppler) complex post-Doppler-FFT
    mag_map: np.ndarray         # (n_range, n_doppler) float magnitude
    det_map: np.ndarray         # zero-suppressed CFAR output
    threshold_map: np.ndarray   # est * scale per cell (dbg_threshold)


def process_frame(frame_iq: np.ndarray, params: RadarParams | None = None,
                  mti_bypass: bool = False, scale_override: int = 0,
                  magnitude_mode: str = "amb",
                  mti_transient: str = "zero") -> FloatChainResult:
    """Run the full float64 chain on one (n_doppler, n_range) complex frame.

    Pipeline order matches rtl/src/radar_core.vhd:5-7: range window -> range
    FFT -> corner turn -> MTI -> Doppler window -> Doppler FFT -> magnitude ->
    2D OS-CFAR.  The corner turn is simply the transpose to (n_range,
    n_doppler); FFTs are unscaled numpy FFTs.

    magnitude_mode: "amb" applies the alpha-max-beta-min formula in float
    (matching the fixed path's shape), "exact" uses sqrt(I^2+Q^2).
    """
    p = params or RadarParams()
    z = np.asarray(frame_iq, dtype=np.complex128)
    assert z.shape == (p.n_doppler, p.n_range), z.shape

    # Range window + range FFT (fast-time axis).
    z = z * hamming_window_float(p.n_range)[None, :]
    z = np.fft.fft(z, axis=1)

    # Corner turn: chirp-major -> range-major (corner_turner.vhd:79-80).
    z = z.T  # (n_range, n_doppler)

    # MTI notch along slow time per range bin (doppler_notch.vhd:72-80).
    if not mti_bypass:
        if p.notch_mode == 2:
            z = z - np.concatenate([np.zeros((p.n_range, 1)), z[:, :-1]], axis=1)
        else:
            z1 = np.concatenate([np.zeros((p.n_range, 1)), z[:, :-1]], axis=1)
            z2 = np.concatenate([np.zeros((p.n_range, 2)), z[:, :-2]], axis=1)
            z = z - 2.0 * z1 + z2
        if mti_transient == "zero":
            z[:, : p.notch_mode - 1] = 0.0

    # Doppler window + Doppler FFT (slow-time axis).
    z = z * hamming_window_float(p.n_doppler)[None, :]
    z = np.fft.fft(z, axis=1)

    if magnitude_mode == "amb":
        ai, aq = np.abs(z.real), np.abs(z.imag)
        mag = np.maximum(ai, aq) + 0.375 * np.minimum(ai, aq)
    else:
        mag = np.abs(z)

    det, threshold = _cfar_float(mag, p, scale_override)
    return FloatChainResult(rdm_complex=z, mag_map=mag, det_map=det,
                            threshold_map=threshold)


def _cfar_float(mag: np.ndarray, p: RadarParams, scale_override: int):
    """Float CFAR with the same geometry/scales as the fixed model.
    Returns (det_map, threshold_map)."""
    cfar = p.cfar
    offs = fx._window_offsets(cfar)
    if cfar.edge_mode == "wrap":
        refs = np.stack([np.roll(mag, (-dr, -dd), axis=(0, 1)) for dr, dd in offs])
    else:
        hr, hd = cfar.halo_range, cfar.halo_doppler
        mp = np.pad(mag, ((hr, hr), (hd, hd)), mode="reflect")
        refs = np.stack([mp[hr + dr: hr + dr + mag.shape[0],
                            hd + dd: hd + dd + mag.shape[1]] for dr, dd in offs])
    mean = refs.mean(axis=0)
    if cfar.variant == "os":
        est = np.partition(refs, cfar.rank_idx, axis=0)[cfar.rank_idx]
    elif cfar.variant == "ca":
        est = mean
    elif cfar.variant in ("go", "so"):
        o = np.array(fx._window_offsets(cfar))
        lead = refs[o[:, 0] < -cfar.guard_range].mean(axis=0)
        lag = refs[o[:, 0] > cfar.guard_range].mean(axis=0)
        est = (np.maximum if cfar.variant == "go" else np.minimum)(lead, lag)
    else:
        raise ValueError(cfar.variant)
    if scale_override:
        scale = float(scale_override)
    elif cfar.scale_mode == "block":
        scale = _block_scale_float(mag, cfar)
    else:
        scale = np.where(est > 1.5 * mean, cfar.scale_max,
                         np.where(est < 0.5 * mean, cfar.scale_min, cfar.scale_nom))
    threshold = est * scale
    return np.where(mag > threshold, mag, 0.0), threshold


def _block_scale_float(mag: np.ndarray, cfar) -> np.ndarray:
    """Float twin of fixed_point.block_scale_map (true division, 1.5x/0.5x
    thresholds — the float per-cell rule lifted to blocks)."""
    B = cfar.scale_block
    R, D = mag.shape
    Rb, Db = R // B, D // B
    N = 9 * B * B
    k = N - min((N * cfar.rank_pct) // 100, N - 1)

    def nb9(a):
        if cfar.edge_mode == "wrap":
            return sum(np.roll(a, (-i, -j), axis=(0, 1))
                       for i in (-1, 0, 1) for j in (-1, 0, 1))
        return sum(a[np.clip(np.arange(Rb) + i, 0, Rb - 1)]
                   [:, np.clip(np.arange(Db) + j, 0, Db - 1)]
                   for i in (-1, 0, 1) for j in (-1, 0, 1))

    def block_sum(x):
        return x.reshape(Rb, B, Db, B).sum(axis=(1, 3))

    def cells(b):
        return np.repeat(np.repeat(b, B, 0), B, 1)

    mean = cells(nb9(block_sum(mag)) / N)
    hi = nb9(block_sum(mag > 1.5 * mean)) >= k
    lo = nb9(block_sum(mag >= 0.5 * mean)) < k
    return cells(np.where(hi, cfar.scale_max,
                          np.where(lo, cfar.scale_min, cfar.scale_nom)))


# ---------------------------------------------------------------------------
# Fixed-point chain (composition of fixed_point.py stages)
# ---------------------------------------------------------------------------

def process_frame_fixed(frame_iq: np.ndarray, params: RadarParams | None = None,
                        mti_bypass: bool = False, scale_override: int = 0,
                        mti_transient: str = "zero",
                        window_rounding: str = "unbiased",
                        fft: str = "bfp", fft_scale_sch=None):
    """Run the fixed-point chain on one (n_doppler, n_range) complex int frame.

    With ``window_rounding="biased"`` and ``mti_transient="passthrough"`` every
    stage is bit-faithful to the reference hardware; the defaults use the
    framework's cleaned-up numerics (see docs/design_notes.md).  Returns
    (mag_map, det_map) int64 arrays of shape (n_range, n_doppler).

    ``fft``: "bfp" (production XFFT block-floating-point) or "scaled" — the
    QUICK-mode XFFT variants' stage-scaled arithmetic
    (fixed_point.scaled_fft; natural output order in-chain).
    ``fft_scale_sch``: optional (range_sch, doppler_sch) pair; None with
    fft="scaled" uses the conventional [1]*log2(n) per transform.
    """
    p = params or RadarParams()
    z = np.asarray(frame_iq)
    i_v, q_v = z.real.astype(np.int64), z.imag.astype(np.int64)
    if fft == "scaled":
        sch = fft_scale_sch or ([1] * (p.n_range.bit_length() - 1),
                                [1] * (p.n_doppler.bit_length() - 1))
        fft_r = lambda i, q: fx.scaled_fft(i, q, axis=1, scale_sch=sch[0])
        fft_d = lambda i, q: fx.scaled_fft(i, q, axis=1, scale_sch=sch[1])
    elif fft == "bfp":
        fft_r = fft_d = lambda i, q: fx.bfp_fft(i, q, axis=1)
    else:
        raise ValueError(fft)

    cr = fx.hamming_coeffs(p.n_range, p.coef_width)
    i_v, q_v, _ = fx.window_apply(i_v, q_v, cr[None, :], p.coef_width,
                                  rounding=window_rounding)
    i_v, q_v = fft_r(i_v, q_v)

    i_v, q_v = i_v.T, q_v.T  # corner turn -> (n_range, n_doppler)

    i_v, q_v = fx.mti_notch(i_v, q_v, axis=1, mode=p.notch_mode,
                            bypass=mti_bypass, transient=mti_transient)

    cd = fx.hamming_coeffs(p.n_doppler, p.coef_width)
    i_v, q_v, _ = fx.window_apply(i_v, q_v, cd[None, :], p.coef_width,
                                  rounding=window_rounding)
    i_v, q_v = fft_d(i_v, q_v)

    mag = fx.magnitude(i_v, q_v)
    det = fx.os_cfar_2d(mag, p.cfar, scale_override)
    return mag, det
