"""End-to-end golden-frame regression for the numpy golden models.

Reconstructs the two-target CPI of rtl/old/tb_radar_core.vhd:37-44 (targets at
range bins 100/500, Doppler 5/-10, amps 8000/5000, noise +-20) and verifies
the float64 and fixed-point chains against the checked-in golden map
data/radar_output.txt within the SNR-bound parity criterion: detection/peak
clusters at the same range bins, matched power concentration.

(The reference map's fine structure carries xsim block-floating-point
artifacts — Doppler images at +N/2, range-split peaks 99/101 — that are not
bit-reproducible; see SURVEY.md section 6 and docs/design_notes.md.)
"""

import numpy as np
import pytest

from fmcw_tpu import RadarParams
from fmcw_tpu.golden import fixed_point as fx, reference as ref
from fmcw_tpu.utils import io as rio

P = RadarParams()
T1_ROWS = range(98, 103)   # target 1 @ range 100
T2_ROWS = range(498, 503)  # target 2 @ range 500


@pytest.fixture(scope="module")
def frame():
    return ref.two_target_frame(P)


def test_float_chain_peaks(frame):
    res = ref.process_frame(frame, P, mti_bypass=True)
    mag = res.mag_map
    top2 = np.argsort(mag.ravel())[::-1][:2]
    locs = {(int(i) // P.n_doppler, int(i) % P.n_doppler) for i in top2}
    assert locs == {(100, 5), (500, 118)}


def test_float_chain_with_mti_keeps_movers(frame):
    res = ref.process_frame(frame, P, mti_bypass=False)
    mag = res.mag_map
    # Both targets move (Doppler 5 and -10): they survive the notch.
    assert mag[100, 5] > 100 * np.median(mag)
    assert mag[500, 118] > 100 * np.median(mag)


def test_fixed_chain_detection_clusters(frame):
    _, det = ref.process_frame_fixed(frame, P)
    grouped = fx.peak_group(det, radius=2)
    r, d = np.nonzero(grouped)
    order = np.argsort(grouped[r, d])[::-1]
    top = list(zip(r[order[:2]], d[order[:2]]))
    clusters = {(int(rr) // 100, int(dd)) for rr, dd in
                [(rr, dd) for rr, dd in top]}
    rows = sorted(int(rr) for rr, _ in top)
    assert rows[0] in T1_ROWS and rows[1] in T2_ROWS
    dops = {int(dd) for rr, dd in top if rr in T1_ROWS}
    assert dops <= set(range(4, 7))  # Doppler 5 +-1
    dops2 = {int(dd) for rr, dd in top if rr in T2_ROWS}
    assert dops2 <= set(range(117, 120))  # Doppler -10 == 118 +-1


def test_fixed_chain_parity_vs_golden_map(frame, reference_data):
    """Power-concentration parity with data/radar_output.txt.

    Both the reference xsim map and our fixed chain (bypass mode — the golden
    map came from v3 which had no MTI) must concentrate the dominant share of
    map power in the two target row clusters.
    """
    golden = rio.golden_output_map().astype(np.float64)
    mine, _ = ref.process_frame_fixed(frame, P, mti_bypass=True)
    mine = mine.astype(np.float64)

    def concentration(m):
        p = m ** 2
        target = p[list(T1_ROWS)].sum() + p[list(T2_ROWS)].sum()
        return target / p.sum()

    cg, cm = concentration(golden), concentration(mine)
    assert cg > 0.5 and cm > 0.5
    # Same dominant range rows.
    def toprows(m):
        return set(np.argsort(m.sum(axis=1))[::-1][:6].tolist())
    assert toprows(golden) <= set(T1_ROWS) | set(T2_ROWS)
    assert toprows(mine) <= set(T1_ROWS) | set(T2_ROWS)


def test_golden_input_chirp_tone(reference_data):
    """The checked-in golden chirp is a ~0.2833 cyc/sample tone: windowed
    range FFT of its first 1024 samples must peak at bin 290."""
    z = rio.golden_input_chirp()[:1024]
    w = ref.hamming_window_float(1024)
    spec = np.abs(np.fft.fft(z * w))
    assert int(np.argmax(spec)) == 290


def test_fixed_vs_float_snr_bound(frame):
    """Fixed-point chain tracks the float chain: normalized correlation of the
    dB maps is high despite BFP flattening."""
    res = ref.process_frame(frame, P)
    magf, _ = ref.process_frame_fixed(frame, P)
    a = np.log10(np.maximum(res.mag_map, 1e-3))
    b = np.log10(np.maximum(magf.astype(np.float64), 1e-3))
    a -= a.mean(); b -= b.mean()
    corr = (a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum())
    assert corr > 0.5
