"""HW-compat streaming CFAR: the as-built crossed-axis / startup-skip mode.

The oracle here is a literal cycle-level simulation of rtl/src/os_cfar_2d.vhd
plus the radar_core coordinate counter (rtl/src/radar_core.vhd:396-418),
reproducing the VHDL's signal-update semantics register for register (every
read sees the pre-edge value; all assignments commit together).  The golden
vectorized model (golden/fixed_point.os_cfar_2d_hw_stream) and the XLA op
(ops/cfar.cfar_2d_hw_stream) are verified against it on random streams with
random geometries, multi-frame streams, and mid-frame tvalid gaps.
"""

import numpy as np
import pytest

from fmcw_tpu.params import CfarParams
from fmcw_tpu.golden import fixed_point as fx


# ---------------------------------------------------------------------------
# Cycle-level oracle (direct transliteration of os_cfar_2d.vhd semantics)
# ---------------------------------------------------------------------------

def vhdl_cfar_stream(frames, cfar: CfarParams, scale_override: int = 0,
                     gap_rng: np.random.Generator | None = None,
                     inter_frame_gap: int = 5):
    """Simulate the streaming CFAR + label counter on a (n_frames, R, D)
    stack.  Continuous m_axis_tready (as wired in radar_core.vhd:388).
    ``gap_rng``: optionally insert random mid-frame tvalid gaps (the VHDL
    shifts nothing without tvalid — os_cfar_2d.vhd:118-147)."""
    f = np.asarray(frames, dtype=np.int64)
    if f.ndim == 2:
        f = f[None]
    n_frames, R, D = f.shape
    WIN_D, WIN_R = cfar.win_doppler, cfar.win_range
    CUT_D, CUT_R = cfar.halo_doppler, cfar.halo_range
    n_ref = cfar.n_ref
    rank_idx = cfar.rank_idx
    startup_delay = (CUT_D + 1) * D + CUT_R + 2

    line = np.zeros((WIN_D, D), dtype=np.int64)
    win = np.zeros((WIN_D, WIN_R), dtype=np.int64)
    doppler_cnt = row_cnt = startup_cnt = 0
    window_valid = False
    p1_valid = p2_valid = m_valid = False
    p1_last = p2_last = m_last = False
    p2_data = m_data = 0

    outputs = []        # (data, last) per valid output

    def edge(tvalid, tdata, tlast):
        nonlocal line, win, doppler_cnt, row_cnt, startup_cnt, window_valid
        nonlocal p1_valid, p2_valid, m_valid, p1_last, p2_last, m_last
        nonlocal p2_data, m_data
        # --- compute everything from OLD signal values -------------------
        # Sections 3-6 read the pre-shift window.
        refs = []
        s = 0
        for d in range(WIN_D):
            for r in range(WIN_R):
                if abs(d - CUT_D) <= cfar.guard_doppler and \
                        abs(r - CUT_R) <= cfar.guard_range:
                    continue
                refs.append(win[d, r])
                s += win[d, r]
        refs = np.sort(np.array(refs, dtype=np.int64))
        ranked = refs[rank_idx]
        mean = s // n_ref
        if scale_override != 0:
            scale = scale_override
        elif ranked > mean + (mean >> 1):
            scale = cfar.scale_max
        elif ranked < (mean >> 1):
            scale = cfar.scale_min
        else:
            scale = cfar.scale_nom
        threshold = ranked * scale
        cut = win[CUT_D, CUT_R]

        new_p1_valid = window_valid and tvalid
        new_p1_last = tlast
        new_p2_valid, new_p2_last = p1_valid, p1_last
        new_p2_data = cut if cut > threshold else 0
        new_m_valid, new_m_last, new_m_data = p2_valid, p2_last, p2_data

        if tvalid:
            new_line = line.copy()
            new_line[row_cnt, doppler_cnt] = tdata
            # Window shift reads the OLD line buffer (the concurrent write
            # commits after the edge).
            new_win = np.empty_like(win)
            new_win[:, 1:] = win[:, :-1]
            for d in range(WIN_D):
                new_win[d, 0] = line[(row_cnt + d) % WIN_D, doppler_cnt]
            if tlast or doppler_cnt == D - 1:
                new_dc = 0
                new_rc = 0 if row_cnt == WIN_D - 1 else row_cnt + 1
            else:
                new_dc, new_rc = doppler_cnt + 1, row_cnt
            if startup_cnt < startup_delay:
                new_sc, new_wv = startup_cnt + 1, False
            else:
                new_sc, new_wv = startup_cnt, True
            line, win = new_line, new_win
            doppler_cnt, row_cnt, startup_cnt = new_dc, new_rc, new_sc
            window_valid = new_wv
        # --- commit ------------------------------------------------------
        p1_valid, p1_last = new_p1_valid, new_p1_last
        p2_valid, p2_last, p2_data = new_p2_valid, new_p2_last, new_p2_data
        m_valid, m_last, m_data = new_m_valid, new_m_last, new_m_data
        if m_valid:
            outputs.append((m_data, m_last))

    for k in range(n_frames):
        flat = f[k].reshape(-1)
        for i, v in enumerate(flat):
            if gap_rng is not None and gap_rng.random() < 0.15:
                for _ in range(int(gap_rng.integers(1, 4))):
                    edge(False, 0, False)
            edge(True, int(v), (i % D) == D - 1)
        for _ in range(inter_frame_gap):
            edge(False, 0, False)

    # radar_core coordinate counter: doppler-fast, wraps at D then R, counts
    # every VALID output, never resets (radar_core.vhd:396-411).
    dets = []
    ri = di = 0
    for data, _last in outputs:
        if data > 0:
            dets.append((ri, di, data))
        if di == D - 1:
            di = 0
            ri = 0 if ri == R - 1 else ri + 1
        else:
            di += 1
    return outputs, dets


GEOMETRIES = [
    (CfarParams(ref_range=1, ref_doppler=1, guard_range=1, guard_doppler=1),
     12, 8),
    (CfarParams(ref_range=2, ref_doppler=2, guard_range=1, guard_doppler=1),
     16, 8),   # the QUICK_MODE CFAR geometry (ADR_tb_quick.vhd:110-111)
    (CfarParams(), 26, 16),  # full production geometry, small map
]


def _stim(R, D, n_frames, seed):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 400, size=(n_frames, R, D)).astype(np.int64)
    # a few strong spikes so detections exist
    for k in range(n_frames):
        for _ in range(4):
            f[k, rng.integers(0, R), rng.integers(0, D)] = \
                int(rng.integers(4000, 30000))
    return f


@pytest.mark.parametrize("gi", range(len(GEOMETRIES)))
@pytest.mark.parametrize("override", [0, 3])
def test_golden_hw_stream_matches_vhdl_oracle(gi, override):
    cfar, R, D = GEOMETRIES[gi]
    f = _stim(R, D, 3, seed=gi * 10 + override)
    outputs, dets = vhdl_cfar_stream(f, cfar, scale_override=override)
    dbg = fx.os_cfar_2d_hw_stream(f, cfar, scale_override=override,
                                  return_debug=True)
    # Bit-level: the full zero-suppressed output stream matches.
    assert len(outputs) == len(dbg["out"])
    assert np.array_equal(np.array([o for o, _ in outputs]), dbg["out"])
    # tlast rides with the data whose source sample ended a Doppler row.
    lag = fx.hw_stream_lag(cfar, D)
    lasts = np.array([l for _, l in outputs])
    expect_last = ((dbg["cells"] + lag) % D) == D - 1
    assert np.array_equal(lasts, expect_last)
    # Detection labels match.
    lr, ld, lm = fx.os_cfar_2d_hw_stream(f, cfar, scale_override=override)
    assert [(int(a), int(b), int(c)) for a, b, c in zip(lr, ld, lm)] == dets


def test_hw_stream_gap_invariance():
    """tvalid gaps anywhere in the stream leave the output sequence
    unchanged (the window only shifts on tvalid; the 2-deep output pipeline
    flushes in-flight tokens) — so the vectorized model needs no gap
    modeling."""
    cfar, R, D = GEOMETRIES[1]
    f = _stim(R, D, 2, seed=7)
    base, base_dets = vhdl_cfar_stream(f, cfar)
    gapped, gapped_dets = vhdl_cfar_stream(
        f, cfar, gap_rng=np.random.default_rng(3))
    assert base == gapped
    assert base_dets == gapped_dets


def test_hw_stream_first_emitted_cell_is_3():
    """The startup skip + pipeline depth place the first emitted output at
    flat cell 3 for every geometry (see golden.fixed_point.hw_stream_lag),
    so labels are offset exactly -3 flat positions from true cells."""
    for cfar, R, D in GEOMETRIES:
        f = _stim(R, D, 1, seed=1)
        dbg = fx.os_cfar_2d_hw_stream(f, cfar, return_debug=True)
        assert dbg["cells"][0] == 3
        assert dbg["labels"][0] == 0
        # steady state: one full frame of outputs per frame of input
        f2 = _stim(R, D, 2, seed=1)
        dbg2 = fx.os_cfar_2d_hw_stream(f2, cfar, return_debug=True)
        assert len(dbg2["cells"]) - len(dbg["cells"]) == R * D


def test_hw_stream_crossed_geometry_effective_extent():
    """The effective window is the CROSS of the generic names: an impulse
    separated from the CUT by ref_doppler+guard_doppler rows in RANGE still
    lands in the training set; one ref_range+guard_range rows away does not
    (SURVEY.md §2a: 11-cell extent & +-1 guard in range, 13-cell extent &
    +-2 guard in Doppler at the default generics)."""
    cfar = CfarParams()      # ref_r=4 gr=2 (stream axis), ref_d=4 gd=1 (rows)
    R, D = 32, 16
    f = np.zeros((R, D), dtype=np.int64)
    cut = (16, 8)
    f[cut] = 1000
    dbg = fx.os_cfar_2d_hw_stream(f, cfar, return_debug=True)
    flat_cut = cut[0] * D + cut[1]
    i = np.where(dbg["cells"] == flat_cut)[0][0]

    def in_training(dr, dd):
        g = f.copy()
        g[cut[0] + dr, cut[1] + dd] = 10 ** 6
        d2 = fx.os_cfar_2d_hw_stream(g, cfar, return_debug=True)
        return d2["mean"][i] > dbg["mean"][i]

    # Range axis follows the *doppler* generics: extent +-5, guard +-1.
    assert in_training(5, 0)          # ref_d+guard_d = 5 rows away: training
    assert not in_training(6, 0)      # beyond the crossed range extent
    assert not in_training(1, 0)      # inside the crossed range guard
    assert in_training(2, 0)
    # Doppler (stream) axis follows the *range* generics: +-6, guard +-2.
    assert in_training(0, 6)
    assert not in_training(0, 7)
    assert not in_training(0, 2)
    assert in_training(0, 3)


def test_hw_stream_doppler_axis_is_flat_stream():
    """The along-stream window crosses row boundaries: a training cell for a
    CUT at Doppler column 0 comes from the PREVIOUS range row's last columns
    (the shift register never resets on tlast)."""
    cfar = CfarParams(ref_range=2, ref_doppler=2, guard_range=1,
                      guard_doppler=1)
    R, D = 16, 8
    f = np.zeros((R, D), dtype=np.int64)
    cut = (8, 0)
    dbg0 = fx.os_cfar_2d_hw_stream(f, cfar, return_debug=True)
    i = np.where(dbg0["cells"] == cut[0] * D + cut[1])[0][0]
    g = f.copy()
    g[7, 6] = 10 ** 6        # flat offset -2 from the CUT: row 7, col D-2
    dbg1 = fx.os_cfar_2d_hw_stream(g, cfar, return_debug=True)
    assert dbg1["mean"][i] > dbg0["mean"][i]


# ---------------------------------------------------------------------------
# XLA op and pipeline integration
# ---------------------------------------------------------------------------

def _labeled_dets(det_map):
    m = np.asarray(det_map)
    r, d = np.nonzero(m)
    return sorted(zip(r.tolist(), d.tolist(), m[r, d].tolist()))


@pytest.mark.parametrize("gi", range(len(GEOMETRIES)))
def test_xla_hw_stream_matches_golden_oneshot(gi):
    from fmcw_tpu.ops import cfar as C
    cfar, R, D = GEOMETRIES[gi]
    f = _stim(R, D, 1, seed=20 + gi)[0]
    det_map, thr, scale = C.cfar_2d_hw_stream(
        f.astype(np.int32), 0, cfar=cfar, integer=True)
    lr, ld, lm = fx.os_cfar_2d_hw_stream(f, cfar)
    assert _labeled_dets(det_map) == sorted(
        zip(lr.tolist(), ld.tolist(), lm.tolist()))
    # debug taps (true-coordinate order) match the golden per-cell values
    dbg = fx.os_cfar_2d_hw_stream(f, cfar, return_debug=True)
    thr = np.asarray(thr).reshape(-1)
    assert np.array_equal(thr[dbg["cells"]], dbg["threshold"])


def test_xla_hw_stream_streaming_carry_matches_golden():
    """frame-0 one-shot + frame-1 streaming(hist) == the golden 2-frame
    stream (the hardware's steady-state inter-frame bleed + re-labeling)."""
    from fmcw_tpu.ops import cfar as C
    cfar, R, D = GEOMETRIES[1]
    f = _stim(R, D, 2, seed=33)
    lag = fx.hw_stream_lag(cfar, D)
    d0, _, _ = C.cfar_2d_hw_stream(f[0].astype(np.int32), 0, cfar=cfar,
                                   integer=True)
    hist = f[0].reshape(-1)[-2 * lag:].astype(np.int32)
    d1, _, _, new_hist = C.cfar_2d_hw_stream(
        f[1].astype(np.int32), 0, cfar=cfar, integer=True,
        hist=hist, streaming=True)
    got = _labeled_dets(d0) + _labeled_dets(d1)
    lr, ld, lm = fx.os_cfar_2d_hw_stream(f, cfar)
    assert sorted(got) == sorted(zip(lr.tolist(), ld.tolist(), lm.tolist()))
    assert np.array_equal(np.asarray(new_hist),
                          f[1].reshape(-1)[-2 * lag:])


def test_pipeline_hw_compat_mode():
    """make_processor(cfar_geometry='hw_stream') end to end: detections at
    hardware label coordinates, equal to the golden fixed chain + golden
    hw-stream CFAR."""
    from fmcw_tpu import params as P
    from fmcw_tpu.models import pipeline as pl
    from fmcw_tpu.golden import reference as ref
    p = P.quick()
    frame = ref.two_target_frame(p, seed=5)
    proc = pl.make_processor(p, mode="fixed",
                             cfar_geometry="hw_stream",
                             window_rounding="biased",
                             mti_transient="passthrough")
    out = proc(pl.complex_to_iq(frame))
    mag, _ = ref.process_frame_fixed(frame, p, window_rounding="biased",
                                     mti_transient="passthrough")
    lr, ld, lm = fx.os_cfar_2d_hw_stream(mag, p.cfar)
    v = np.asarray(out["valid"])
    got = sorted(zip(np.asarray(out["range_bin"])[v].tolist(),
                     np.asarray(out["doppler_bin"])[v].tolist(),
                     np.asarray(out["mag"])[v].tolist()))
    want = sorted(zip(lr.tolist(), ld.tolist(), lm.tolist()))
    assert len(want) <= p.tracker.max_dets  # top-K holds the full set here
    assert got == want
    assert int(out["n_dets"]) == len(want)


def test_pipeline_hw_compat_rejects_bad_config():
    from fmcw_tpu import params as P
    from fmcw_tpu.models import pipeline as pl
    import dataclasses
    p = P.quick()
    p_blk = p.replace(cfar=dataclasses.replace(p.cfar, scale_mode="block"))
    with pytest.raises(ValueError):
        pl.make_processor(p_blk, cfar_geometry="hw_stream")
    p_ca = p.replace(cfar=dataclasses.replace(p.cfar, variant="ca"))
    with pytest.raises(ValueError):
        pl.make_processor(p_ca, cfar_geometry="hw_stream")
    with pytest.raises(ValueError):
        pl.make_processor(p, cfar_geometry="hw_stream", mode="fixed",
                          cfar_method="pallas")


def test_pipeline_hw_stream_continuous_matches_golden():
    """The stateful process.stream hw-compat entry point, driven over 3
    consecutive CPIs, reproduces the golden multi-frame streaming model
    (steady-state inter-frame bleed + label re-wrap + startup skip)
    exactly."""
    from fmcw_tpu import params as P
    from fmcw_tpu.models import pipeline as pl
    from fmcw_tpu.golden import reference as ref
    p = P.quick()
    frames = [ref.two_target_frame(p, seed=s) for s in (11, 12, 13)]
    proc = pl.make_processor(p, mode="fixed",
                             cfar_geometry="hw_stream",
                             window_rounding="biased",
                             mti_transient="passthrough",
                             include_maps=False)
    got = []
    hist = None
    for f in frames:
        out, hist = proc.stream(pl.complex_to_iq(f), hist=hist)
        v = np.asarray(out["valid"])
        got += list(zip(np.asarray(out["range_bin"])[v].tolist(),
                        np.asarray(out["doppler_bin"])[v].tolist(),
                        np.asarray(out["mag"])[v].tolist()))
        assert int(out["n_dets"]) == int(v.sum())

    # Golden comparison over the pipeline's OWN mag maps (the XLA fixed
    # chain's FFT quantization sits within 1 LSB of the golden chain's, so
    # using its maps makes the streaming-logic comparison exact).
    mproc = pl.make_processor(p, mode="fixed",
                              window_rounding="biased",
                              mti_transient="passthrough",
                              include_maps=True)
    mags = np.stack([np.asarray(mproc(pl.complex_to_iq(f))["mag_map"])
                     for f in frames])
    lr, ld, lm = fx.os_cfar_2d_hw_stream(mags, p.cfar)
    want_all = sorted(zip(lr.tolist(), ld.tolist(), lm.tolist()))
    # The stream ends mid-frame: the final frame's tail cells (never
    # emitted until a 4th frame arrives) are exactly the golden dets the
    # stateful calls haven't produced yet.
    lag = fx.hw_stream_lag(p.cfar, p.n_doppler)
    S = p.n_range * p.n_doppler
    dbg = fx.os_cfar_2d_hw_stream(mags, p.cfar, return_debug=True)
    emitted_by_call3 = dbg["cells"][dbg["det"]] < 3 * S - lag
    want_now = sorted(
        (int(a), int(b), int(c)) for a, b, c, keep in
        zip(lr, ld, lm, emitted_by_call3) if keep)
    assert sorted(got) == want_now


@pytest.mark.parametrize("gi", range(len(GEOMETRIES)))
def test_xla_hw_stream_2d_layout_equals_flat(gi):
    """The 2D row/lane view decomposition is bit-identical to the flat
    dynamic_slice formulation on every output, one-shot and streaming."""
    from fmcw_tpu.ops import cfar as C
    cfar, R, D = GEOMETRIES[gi]
    f = _stim(R, D, 2, seed=60 + gi)
    lag = fx.hw_stream_lag(cfar, D)
    for integer in (True, False):
        dt = np.int32 if integer else np.float32
        hist = f[0].reshape(-1)[-2 * lag:].astype(dt)
        for kw in (dict(),
                   dict(streaming=True, first=True),
                   dict(hist=hist, streaming=True)):
            a = C.cfar_2d_hw_stream(f[1].astype(dt), 0, cfar=cfar,
                                    integer=integer, layout="2d", **kw)
            b = C.cfar_2d_hw_stream(f[1].astype(dt), 0, cfar=cfar,
                                    integer=integer, layout="flat", **kw)
            for x, y in zip(a, b):
                assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("gi", range(len(GEOMETRIES)))
def test_xla_hw_stream_pallas_method_equals_xla(gi):
    """The counting decision without threshold taps (need_debug=False)
    equals the tapped run (which also builds the rank stack): det/scale/
    hist bit-equal in integer AND float mode, one-shot and streaming, with
    and without a scale override."""
    from fmcw_tpu.ops import cfar as C
    cfar, R, D = GEOMETRIES[gi]
    f = _stim(R, D, 2, seed=80 + gi)
    lag = fx.hw_stream_lag(cfar, D)
    for integer in (True, False):
        dt = np.int32 if integer else np.float32
        hist = f[0].reshape(-1)[-2 * lag:].astype(dt)
        for so in (0, 3):
            for kw in (dict(),
                       dict(streaming=True, first=True),
                       dict(hist=hist, streaming=True)):
                a = C.cfar_2d_hw_stream(f[1].astype(dt), so, cfar=cfar,
                                        integer=integer, need_debug=False,
                                        **kw)
                b = C.cfar_2d_hw_stream(f[1].astype(dt), so, cfar=cfar,
                                        integer=integer, need_debug=True,
                                        **kw)
                for i, (x, y) in enumerate(zip(a, b)):
                    if i == 1:
                        continue          # thresholds: only b has taps
                    assert np.array_equal(np.asarray(x), np.asarray(y))


def test_hw_stream_no_hist_forces_startup_skip():
    """streaming=True without hist IS the stream's first frame: the op
    must apply the startup suppression regardless of the ``first`` flag
    (cells 0-2 train on the synthetic zero history and would spuriously
    pass otherwise)."""
    from fmcw_tpu.ops import cfar as C
    cfar, R, D = GEOMETRIES[0]
    f = _stim(R, D, 1, seed=90)[0].astype(np.int32)
    # Plant strong cells at stream positions 0-2: with a zero history they
    # spuriously pass unless the startup skip suppresses them.
    f[0, :3] = 30000
    a = C.cfar_2d_hw_stream(f, 0, cfar=cfar, integer=True, streaming=True)
    b = C.cfar_2d_hw_stream(f, 0, cfar=cfar, integer=True, streaming=True,
                            first=True)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    # and the suppression really happened: label cells for stream pos 0-2
    # (label_flat = pos - 3 mod S) are zero.
    det = np.asarray(a[0]).reshape(-1)
    S = R * D
    assert all(det[(pos - 3) % S] == 0 for pos in range(3))


def test_pipeline_hw_compat_groups_in_decision_order():
    """The pipeline applies peak grouping on the decision-order (true-cell)
    det map — physical adjacency — and only then rotates into label space.
    Pinned by recomposing from the op primitives on the pipeline's own mag
    map (one-shot and streaming framings)."""
    from fmcw_tpu import params as P
    from fmcw_tpu.models import pipeline as pl
    from fmcw_tpu.ops import cfar as C
    from fmcw_tpu.golden import reference as ref
    p = P.quick()
    proc = pl.make_processor(p, mode="fixed", cfar_geometry="hw_stream",
                             peak_group_radius=1, include_maps=True)
    iq = pl.complex_to_iq(ref.two_target_frame(p, seed=21))
    out = proc(iq)
    mag = np.asarray(out["mag_map"])
    det, _, _ = C.cfar_2d_hw_stream(mag, 0, cfar=p.cfar, integer=True,
                                    need_debug=False, label_roll=False)
    det = C.peak_group(det, radius=1)
    shift = C.hw_stream_label_shift(p.cfar, p.n_doppler, streaming=False)
    want = np.roll(np.asarray(det).reshape(-1), -shift).reshape(det.shape)
    assert np.array_equal(np.asarray(out["det_map"]), want)

    out2, _ = proc.stream(iq)
    mag2 = np.asarray(out2["mag_map"])
    det2, _, _, _ = C.cfar_2d_hw_stream(mag2, 0, cfar=p.cfar, integer=True,
                                        need_debug=False, label_roll=False,
                                        streaming=True)
    det2 = C.peak_group(det2, radius=1)
    shift2 = C.hw_stream_label_shift(p.cfar, p.n_doppler, streaming=True)
    want2 = np.roll(np.asarray(det2).reshape(-1), -shift2).reshape(det2.shape)
    assert np.array_equal(np.asarray(out2["det_map"]), want2)


def test_pallas_method_random_geometry_fuzz():
    """Randomized window geometries: the counting decision's labeled
    detections match the golden streaming model one-shot (closing the
    oracle == golden == jax chain on shapes beyond the fixed GEOMETRIES
    list)."""
    from fmcw_tpu.ops import cfar as C
    rng = np.random.default_rng(42)
    for _ in range(5):
        rr, rd = int(rng.integers(1, 4)), int(rng.integers(1, 4))
        gr, gd = int(rng.integers(0, 3)), int(rng.integers(0, 3))
        cfar = CfarParams(ref_range=rr, ref_doppler=rd,
                          guard_range=gr, guard_doppler=gd)
        D = int(rng.choice([8, 16]))
        if cfar.halo_range >= D:
            D = 16
        R = int(rng.integers(3, 7)) * 4
        f = _stim(R, D, 1, seed=int(rng.integers(1 << 30)))[0]
        det_map, _, _ = C.cfar_2d_hw_stream(
            f.astype(np.int32), 0, cfar=cfar, integer=True,
            need_debug=False)
        lr, ld, lm = fx.os_cfar_2d_hw_stream(f, cfar)
        assert _labeled_dets(det_map) == sorted(
            zip(lr.tolist(), ld.tolist(), lm.tolist())), (rr, rd, gr, gd, R, D)


def test_hw_stream_narrow_int_upcast_matches_int32():
    """int16 magnitude maps must make the same decisions as the int32 view
    of the same values: sum_refs over 128 int16 views and the ceil-division
    probe (cut + s - 1) wrap in int16 without the internal upcast (the
    cfar_2d/cfar_3d hardening, mirrored here — ADVICE r3).  det and
    new_hist come back in the input dtype; threshold/scale in int32."""
    from fmcw_tpu.ops import cfar as C
    cfar, R, D = GEOMETRIES[2]
    rng = np.random.default_rng(5)
    # Values near int16 full scale so 128-view sums and cut+s-1 both wrap.
    f = rng.integers(20000, 32700, size=(2, R, D)).astype(np.int64)
    f[1, R // 2, D // 2] = 32767
    lag = fx.hw_stream_lag(cfar, D)
    hist16 = f[0].reshape(-1)[-2 * lag:].astype(np.int16)
    for kw in (dict(),
               dict(streaming=True, first=True),
               dict(hist=hist16, streaming=True)):
        for need_debug in (False, True):
            a = C.cfar_2d_hw_stream(f[1].astype(np.int16), 0, cfar=cfar,
                                    integer=True, need_debug=need_debug,
                                    **kw)
            kw32 = dict(kw)
            if "hist" in kw32:
                kw32["hist"] = hist16.astype(np.int32)
            b = C.cfar_2d_hw_stream(f[1].astype(np.int32), 0, cfar=cfar,
                                    integer=True, need_debug=need_debug,
                                    **kw32)
            assert np.asarray(a[0]).dtype == np.int16
            assert np.array_equal(np.asarray(a[0]).astype(np.int32),
                                  np.asarray(b[0]))
            assert np.array_equal(np.asarray(a[2]), np.asarray(b[2]))
            if len(a) == 4:
                assert np.asarray(a[3]).dtype == np.int16
                assert np.array_equal(np.asarray(a[3]).astype(np.int32),
                                      np.asarray(b[3]))


def test_hw_stream_pallas_method_rejects_bad_overrides_and_halos():
    """The one counting route takes what the removed kernel refused: a
    float scale override (equal to the same integer override) and zero
    halos (equal to the golden streaming model)."""
    from fmcw_tpu.ops import cfar as C
    cfar, R, D = GEOMETRIES[0]
    f = _stim(R, D, 1, seed=3)[0].astype(np.float32)
    a = C.cfar_2d_hw_stream(f, 2.0, cfar=cfar, integer=False,
                            need_debug=False)
    b = C.cfar_2d_hw_stream(f, 2, cfar=cfar, integer=False,
                            need_debug=False)
    assert np.array_equal(np.asarray(a[0]), np.asarray(b[0]))
    cfar0 = CfarParams(ref_range=0, ref_doppler=2, guard_range=0,
                       guard_doppler=1)
    g = _stim(R, D, 1, seed=4)[0]
    det_map, _, _ = C.cfar_2d_hw_stream(g.astype(np.int32), 0, cfar=cfar0,
                                        integer=True, need_debug=False)
    lr, ld, lm = fx.os_cfar_2d_hw_stream(g, cfar0)
    assert _labeled_dets(det_map) == sorted(
        zip(lr.tolist(), ld.tolist(), lm.tolist()))
