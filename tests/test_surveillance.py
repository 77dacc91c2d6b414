"""Surveillance runtime tests: scan-batched processing with tracker loop,
checkpoint/resume mid-run, golden-chirp end-to-end."""

import numpy as np
import pytest

from fmcw_tpu import quick
from fmcw_tpu.golden import reference as ref
from fmcw_tpu.models import pipeline as pl, scenario as sc
from fmcw_tpu.runtime import surveillance as sv
from fmcw_tpu.utils import checkpoint as ckpt, io as rio

Q = quick()


def _frames(n):
    return [pl.complex_to_iq(ref.two_target_frame(Q, seed=s % 3))
            for s in range(n)]


def test_surveillance_batched_matches_per_scan(tmp_path):
    proc = pl.make_batch_processor(Q, mode="float32", include_maps=False,
                                   peak_group_radius=2)
    frames = _frames(7)
    det_log = str(tmp_path / "d.txt")
    trk_log = str(tmp_path / "t.txt")
    res_b = list(sv.run_surveillance(proc, frames, Q, batch_scans=3,
                                     det_log=det_log, trk_log=trk_log))
    res_1 = list(sv.run_surveillance(proc, frames, Q, batch_scans=1))
    assert len(res_b) == 7
    for a, b in zip(res_b, res_1):
        assert (a.scan, a.n_dets, a.active_tracks) == (b.scan, b.n_dets,
                                                       b.active_tracks)
    # Logs parse back.
    from fmcw_tpu.utils import viz
    tracks, counts = viz.load_tracks(trk_log)
    assert len(counts) == 7


def test_surveillance_checkpoint_resume(tmp_path):
    proc = pl.make_batch_processor(Q, mode="float32", include_maps=False,
                                   peak_group_radius=2)
    frames = _frames(6)
    full = list(sv.run_surveillance(proc, frames, Q, batch_scans=2))

    # Run 3 scans, checkpoint, resume for the remaining 3.
    first = list(sv.run_surveillance(proc, frames[:3], Q, batch_scans=2))
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, first[-1].tracker_state, scan_index=first[-1].scan)
    state, scan, _, _ = ckpt.load(path)
    rest = list(sv.run_surveillance(proc, frames[3:], Q, batch_scans=2,
                                    tracker_state=state, start_scan=scan))
    resumed = first + rest
    for a, b in zip(full, resumed):
        assert (a.scan, a.active_tracks) == (b.scan, b.active_tracks)
    # Final tracker state identical.
    fa, fb = full[-1].tracker_state, resumed[-1].tracker_state
    for k in fa:
        assert np.array_equal(fa[k], fb[k]), k


def test_golden_chirp_file_end_to_end(reference_data):
    """data/golden_input_chirp.txt through the full pipeline: the checked-in
    tone (f ~ 0.2833 cyc/sample) fills every chirp; with MTI bypassed the
    detection lands at range bin 290 (= round(0.2833 * 1024)), Doppler 0."""
    import fmcw_tpu
    p = fmcw_tpu.full()
    z = rio.golden_input_chirp()
    chirp = z[:p.n_range]
    frame = np.tile(chirp[None, :], (p.n_doppler, 1))
    proc = pl.make_processor(p, mode="float32", include_maps=False,
                             peak_group_radius=2)
    out = proc(pl.complex_to_iq(frame), mti_bypass=True)
    v = np.asarray(out["valid"])
    assert np.asarray(out["range_bin"])[v][0] == 290
    assert np.asarray(out["doppler_bin"])[v][0] == 0


def test_surveillance_array_model(tmp_path):
    """The surveillance runtime drives the batched array model: element-
    space scan cubes in, tracks out (the tracker consumes range/Doppler;
    beam_bin rides along in the detection outputs)."""
    import dataclasses
    from fmcw_tpu import CfarParams, RadarParams

    p = RadarParams(n_range=256, n_doppler=64,
                    cfar=CfarParams(ref_range=4, ref_doppler=3,
                                    guard_range=2, guard_doppler=1,
                                    scale_block=2))
    cfg = sc.quick_scenario()
    cfg.burst_synthesis = False
    cfg.num_scans = 5
    scen = sc.TacticalScenario(p, cfg)
    frames = [pl.complex_to_iq(f)
              for _, f, _ in scen.run_elements(n_elems=4)]
    proc = pl.make_batch_array_processor(p, n_elems=4, n_beams=4,
                                         peak_group_radius=2,
                                         beam_group_radius=1,
                                         include_maps=False)
    det_log = str(tmp_path / "d.txt")
    trk_log = str(tmp_path / "t.txt")
    res = list(sv.run_surveillance(proc, frames, p, batch_scans=2,
                                   det_log=det_log, trk_log=trk_log))
    assert len(res) == 5
    assert any(r.n_dets > 0 for r in res)
    assert res[-1].active_tracks > 0
    from fmcw_tpu.utils import viz
    tracks, counts = viz.load_tracks(trk_log)
    assert len(counts) == 5


def test_surveillance_watchdog_surfaces_stall():
    """A hung proc raises SurveillanceStallError promptly instead of
    blocking forever — the TB-watchdog analog (tb_radar_core.vhd:136-146)."""
    import time

    def hung_proc(batch, mti_bypass=False, scale_override=0):
        time.sleep(30.0)
        raise AssertionError("unreachable")

    t0 = time.perf_counter()
    with pytest.raises(sv.SurveillanceStallError):
        list(sv.run_surveillance(hung_proc, _frames(2), Q, batch_scans=2,
                                 watchdog_timeout=0.3))
    assert time.perf_counter() - t0 < 5.0


def test_surveillance_watchdog_passes_and_propagates_errors():
    proc = pl.make_batch_processor(Q, mode="float32", include_maps=False)
    # generous timeout: normal run unaffected, results identical
    frames = _frames(3)
    res_w = list(sv.run_surveillance(proc, frames, Q, batch_scans=3,
                                     watchdog_timeout=300.0))
    res = list(sv.run_surveillance(proc, frames, Q, batch_scans=3))
    assert [(r.scan, r.n_dets) for r in res_w] == \
        [(r.scan, r.n_dets) for r in res]

    # a proc that raises: the error propagates (not swallowed by the thread)
    def bad_proc(batch, mti_bypass=False, scale_override=0):
        raise RuntimeError("device exploded")

    with pytest.raises(RuntimeError, match="device exploded"):
        list(sv.run_surveillance(bad_proc, frames, Q, batch_scans=3,
                                 watchdog_timeout=10.0))


def test_surveillance_health_lines():
    proc = pl.make_batch_processor(Q, mode="float32", include_maps=False)
    lines = []
    res = list(sv.run_surveillance(proc, _frames(5), Q, batch_scans=2,
                                   health=lines.append))
    assert len(res) == 5
    assert len(lines) == 3          # 2 + 2 + 1 scans -> 3 batches
    assert lines[0].startswith("HEALTH scans=1-2 ")
    assert lines[-1].startswith("HEALTH scans=5-5 ")
    for ln in lines:
        assert "dets=" in ln and "active=" in ln and "scan_rate=" in ln


def test_surveillance_stream_checkpoint_resume(tmp_path):
    """Round-5 verdict item 6 — WHOLE-runtime-state checkpoint: a hw-compat
    streaming run checkpointed mid-stream (tracker + scan counter + the
    CFAR's inter-frame line-buffer carry + log byte positions) and resumed
    emits byte-identical logs and identical final state as an uninterrupted
    run, even after a simulated crash wrote extra log lines past the
    checkpoint.  Without the stream carry the resumed run replays the
    startup-skip transient and diverges — the failure mode the runtime
    state exists to prevent."""
    proc = pl.make_processor(Q, mode="fixed", include_maps=False,
                             cfar_geometry="hw_stream")
    # A target near the end of the map (range bin 124 of 128): its skirt
    # rides the inter-frame line-buffer carry, so the stream history is
    # load-bearing for the next frame's head decisions.
    frames = [pl.complex_to_iq(ref.two_target_frame(
        Q, seed=s % 3, targets=((124, 10 + s % 3, 14000), (60, 20, 12000))))
        for s in range(6)]
    d0, t0 = str(tmp_path / "d0.txt"), str(tmp_path / "t0.txt")
    full = list(sv.run_surveillance_stream(proc, frames, Q,
                                           det_log=d0, trk_log=t0))
    assert len(full) == 6 and any(r.n_dets for r in full)

    d1, t1 = str(tmp_path / "d1.txt"), str(tmp_path / "t1.txt")
    first = list(sv.run_surveillance_stream(proc, frames[:3], Q,
                                            det_log=d1, trk_log=t1))
    ck = first[-1]
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, ck.tracker_state, scan_index=ck.scan,
              runtime_state={"stream_hist": ck.stream_hist,
                             **ckpt.log_positions(d1, t1)})
    # Simulated crash: a partial post-checkpoint batch got logged.
    with open(d1, "a") as fh:
        fh.write("999 999 12345\n")
    state, scan, _, rt = ckpt.load(path)
    assert scan == 3
    ckpt.restore_logs(rt, det_log=d1, trk_log=t1)
    rest = list(sv.run_surveillance_stream(
        proc, frames[3:], Q, det_log=d1, trk_log=t1, tracker_state=state,
        stream_hist=rt["stream_hist"], start_scan=scan))
    assert open(d1).read() == open(d0).read()
    assert open(t1).read() == open(t0).read()
    np.testing.assert_array_equal(full[-1].stream_hist,
                                  rest[-1].stream_hist)
    for k in full[-1].tracker_state:
        assert np.array_equal(full[-1].tracker_state[k],
                              rest[-1].tracker_state[k]), k

    # Resuming WITHOUT the carry replays first-frame startup-skip semantics
    # -> different detection lines on the resumed scans.
    d2 = str(tmp_path / "d2.txt")
    list(sv.run_surveillance_stream(proc, frames[3:], Q, det_log=d2,
                                    tracker_state=state, start_scan=scan))
    tail_good = open(d0, "rb").read()[int(rt["det_log_pos"]):]
    assert open(d2, "rb").read() != tail_good

    # Carried state alone (start_scan=0) must also count as resuming: the
    # runner appends instead of truncating the existing logs (regression —
    # the stream runner's guard used to key on start_scan only).
    pre = open(d1).read()
    assert pre
    list(sv.run_surveillance_stream(proc, frames[:1], Q, det_log=d1,
                                    tracker_state=state))
    assert open(d1).read().startswith(pre)   # appended, not truncated
