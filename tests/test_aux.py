"""Auxiliary subsystem tests: 1D CFAR, chunked ingest, debug taps,
checkpoint/resume, reference-visualizer log compatibility."""

import importlib.util
import os

import numpy as np

from fmcw_tpu import quick, TrackerParams
from fmcw_tpu.golden import fixed_point as fx, reference as ref, tracker as gt
from fmcw_tpu.models import pipeline as pl
from fmcw_tpu.ops import cfar as C
from fmcw_tpu.runtime.stream import FrameAssembler
from fmcw_tpu.utils import checkpoint as ckpt, io as rio

Q = quick()


# --- 1D OS-CFAR (rtl/old/os_cfar.vhd; tb_os_cfar.vhd scenarios) ---

def test_cfar_1d_noise_floor():
    rng = np.random.default_rng(0)
    x = rng.integers(90, 111, 512)
    det = fx.os_cfar_1d(x)
    # Uniform noise with 4x threshold: no false alarms.
    assert np.count_nonzero(det) == 0


def test_cfar_1d_single_target():
    x = np.full(256, 100, dtype=np.int64)
    x[100] = 5000
    det = fx.os_cfar_1d(x)
    assert det[100] == 5000 and np.count_nonzero(det) == 1


def test_cfar_1d_two_close_targets():
    # Masking scenario (tb_os_cfar.vhd:59-80): two strong targets inside each
    # other's training window still both detect with the OS rank.
    x = np.full(256, 100, dtype=np.int64)
    x[100] = 5000
    x[106] = 4800
    det = fx.os_cfar_1d(x)
    assert det[100] > 0 and det[106] > 0


def test_cfar_1d_jax_matches_golden():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 1 << 17, 512)
    x[50] = 120000
    got = np.asarray(C.cfar_1d(x.astype(np.int32)))
    want = fx.os_cfar_1d(x)
    assert np.array_equal(got, want)


# --- chunked ingest (the tvalid-gap / backpressure analog) ---

def test_frame_assembler_chunk_invariance():
    rng = np.random.default_rng(2)
    frames = [pl.complex_to_iq(ref.two_target_frame(Q, seed=s))
              for s in range(3)]
    samples = np.concatenate([f.reshape(-1, 2) for f in frames])
    asm = FrameAssembler(Q.n_doppler, Q.n_range)
    out = []
    pos = 0
    while pos < len(samples):
        k = int(rng.integers(1, 5000))
        out.extend(asm.push(samples[pos: pos + k]))
        pos += k
    assert len(out) == 3
    for got, want in zip(out, frames):
        assert np.array_equal(got, want)
    assert asm.pending_samples == 0


# --- debug taps + sanitization counters ---

def test_debug_taps_and_nonfinite():
    proc = pl.make_processor(Q, mode="float32", include_debug=True)
    iq = pl.complex_to_iq(ref.two_target_frame(Q))
    out = proc(iq)
    thr = np.asarray(out["threshold_map"])
    sc = np.asarray(out["scale_map"])
    assert thr.shape == (Q.n_range, Q.n_doppler)
    assert set(np.unique(sc)) <= {2, 4, 6}
    assert int(out["nonfinite_count"]) == 0
    # dbg_scale respects the override (os_cfar_2d.vhd:191-192).
    out7 = proc(iq, scale_override=7)
    assert np.all(np.asarray(out7["scale_map"]) == 7)


# --- checkpoint/resume ---

def test_tracker_checkpoint_roundtrip(tmp_path):
    tp = TrackerParams()
    state = gt.init_state(tp)
    for scan in range(4):
        state, _ = gt.step(state, [100, 600], [40, 80], [5000, 8000], tp)
    path = str(tmp_path / "trk.npz")
    ckpt.save(path, state, scan_index=4, metadata={"prf": 8000})
    loaded, scan, meta, _ = ckpt.load(path)
    assert scan == 4 and meta == {"prf": 8000}
    for k in state:
        assert np.array_equal(loaded[k], state[k])
    # Resume produces the identical trajectory.
    a, _ = gt.step({k: v.copy() for k, v in state.items()},
                   [95, 600], [40, 80], [5000, 8000], tp)
    b, _ = gt.step(loaded, [95, 600], [40, 80], [5000, 8000], tp)
    for k in a:
        assert np.array_equal(a[k], b[k])


# --- reference visualizer compatibility ---

def test_reference_visualizer_parses_our_logs(tmp_path, reference_data):
    """The reference's own analysis layer must load this framework's logs
    unchanged (SURVEY.md §5 'keep the exact text formats')."""
    viz = os.path.join(os.path.dirname(reference_data), "model",
                       "visualize_radar_targets.py")
    det_path = str(tmp_path / "dets.txt")
    trk_path = str(tmp_path / "trks.txt")
    rio.write_detections(det_path, [10, 20], [3, 4], [1234, 5678])
    rio.write_tracks(trk_path, [
        {"id": 2, "range_pos": 400, "dopp_pos": 44, "range_vel": -20,
         "quality": 7, "status": 2}], active_count=3)

    spec = importlib.util.spec_from_file_location("ref_viz", viz)
    mod = importlib.util.module_from_spec(spec)
    import matplotlib
    matplotlib.use("Agg")
    spec.loader.exec_module(mod)

    dets = mod.load_detections(det_path)
    assert dets.shape == (2, 3) and dets[1].tolist() == [20, 4, 5678]
    tracks, counts = mod.load_tracks(trk_path)
    assert counts == [3]
    assert tracks[2].range_bins == [400]
    assert tracks[2].qualities == [7]
