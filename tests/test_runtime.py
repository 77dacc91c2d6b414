"""Streaming runtime and native IO tests."""

import os
import threading

import numpy as np
import pytest

from fmcw_tpu import quick
from fmcw_tpu.golden import reference as ref
from fmcw_tpu.models import pipeline as pl
from fmcw_tpu.runtime import stream as rs
from fmcw_tpu.runtime import native

Q = quick()


def _frames(n):
    for s in range(n):
        yield pl.complex_to_iq(ref.two_target_frame(Q, seed=s))


def test_stream_yields_all_in_order():
    proc = pl.make_processor(Q, mode="float32", include_maps=False)
    stats = rs.StreamStats()
    outs = list(rs.stream(proc, _frames(5), depth=2, stats=stats))
    assert len(outs) == 5
    assert stats.frames_in == 5 and stats.frames_processed == 5
    assert stats.frames_dropped == 0
    # Deterministic frames -> deterministic per-frame results, order kept.
    ref_out = proc(pl.complex_to_iq(ref.two_target_frame(Q, seed=2)))
    assert int(np.asarray(outs[2]["n_dets"])) == int(np.asarray(ref_out["n_dets"]))


def test_stream_drop_policy_runs_and_accounts():
    """policy='drop' must consume the whole source and account every frame
    as processed or dropped (regression: the ready-probe indexed
    inflight[0][0] on the proc output DICT -> KeyError the first time the
    in-flight window filled)."""
    proc = pl.make_processor(Q, mode="float32", include_maps=False)
    stats = rs.StreamStats()
    outs = list(rs.stream(proc, _frames(6), depth=2, policy="drop",
                          stats=stats))
    assert stats.frames_in == 6
    assert stats.frames_processed == len(outs)
    assert stats.frames_processed + stats.frames_dropped == 6
    for o in outs:                       # every yielded result is complete
        assert int(np.asarray(o["n_dets"])) >= 0


def test_stream_batched_pads_and_masks():
    proc = pl.make_batch_processor(Q, mode="float32", include_maps=False)
    stats = rs.StreamStats()
    outs = list(rs.stream_batched(proc, _frames(5), batch_size=2, depth=2,
                                  stats=stats))
    assert [o["batch_valid"] for o in outs] == [2, 2, 1]
    assert stats.frames_processed == 5


def test_native_parse_matches_numpy(tmp_path, reference_data):
    if not native.available():
        pytest.skip("no native toolchain")
    from fmcw_tpu.utils import io as rio
    z1 = native.read_iq_pairs(os.path.join(rio.REFERENCE_DATA,
                                           "golden_input_chirp.txt"))
    z2 = rio.golden_input_chirp()
    assert np.array_equal(z1, z2)
    m1 = native.read_rdm_map(os.path.join(rio.REFERENCE_DATA,
                                          "radar_output.txt"))
    m2 = rio.golden_output_map()
    assert np.array_equal(m1, m2)


def test_native_rdm_roundtrip(tmp_path):
    m = np.arange(64 * 8, dtype=np.int64).reshape(64, 8)
    p = str(tmp_path / "map.txt")
    native.write_rdm_map(p, m)
    back = native.read_rdm_map(p, 64, 8)
    assert np.array_equal(back, m)


def test_frame_ring_producer_consumer():
    ring = native.FrameRing((4, 8, 2), capacity=3)
    frames = [np.full((4, 8, 2), i, dtype=np.int16) for i in range(10)]

    def produce():
        for f in frames:
            ring.push(f)
        ring.close()

    t = threading.Thread(target=produce)
    t.start()
    got = []
    while True:
        f = ring.pop()
        if f is None:
            break
        got.append(int(f[0, 0, 0]))
    t.join()
    assert got == list(range(10))


def test_frame_ring_overflow_drop():
    ring = native.FrameRing((2, 2, 2), capacity=2)
    f = np.zeros((2, 2, 2), dtype=np.int16)
    assert ring.try_push(f) and ring.try_push(f)
    # Full: the third push is the overflow (drop) condition.
    assert not ring.try_push(f)
    assert ring.pop() is not None
    assert ring.try_push(f)
    ring.close()


def test_file_frame_streamer(tmp_path):
    # Native (or fallback) threaded data loader: binary int16 frames stream
    # through the ring in order, across multiple passes over the file.
    rng = np.random.default_rng(0)
    shape = (8, 16, 2)
    frames = rng.integers(-1000, 1000, (5,) + shape).astype(np.int16)
    p = str(tmp_path / "frames.bin")
    frames.tofile(p)
    s = native.FileFrameStreamer(p, shape, capacity=2, loops=3)
    got = list(s.frames())
    assert s.join() == 15
    assert len(got) == 15
    for i, f in enumerate(got):
        assert np.array_equal(f, frames[i % 5]), i


def test_file_frame_streamer_partial_frame_ignored(tmp_path):
    shape = (4, 4, 2)
    data = np.arange(2 * 32 + 7, dtype=np.int16)  # 2 frames + ragged tail
    p = str(tmp_path / "ragged.bin")
    data.tofile(p)
    s = native.FileFrameStreamer(p, shape)
    got = list(s.frames())
    assert s.join() == 2 and len(got) == 2
    assert np.array_equal(got[1].ravel(), data[32:64])


def test_file_frame_streamer_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        s = native.FileFrameStreamer(str(tmp_path / "nope.bin"), (4, 4, 2))
        s.join()


def test_file_frame_streamer_feeds_pipeline(tmp_path):
    # End-to-end: loader -> stream runtime -> quick pipeline.
    import fmcw_tpu
    from fmcw_tpu.golden import reference
    from fmcw_tpu.models import pipeline as pl
    from fmcw_tpu.runtime import stream as rs
    p = fmcw_tpu.quick()
    base = pl.complex_to_iq(reference.two_target_frame(p))
    path = str(tmp_path / "iq.bin")
    np.stack([base] * 3).tofile(path)
    s = native.FileFrameStreamer(path, base.shape)
    proc = pl.make_processor(p, mode="float32", include_maps=False)
    outs = list(rs.stream(proc, s.frames()))
    assert len(outs) == 3 and s.join() == 3
    n0 = int(np.asarray(outs[0]["n_dets"]))
    assert all(int(np.asarray(o["n_dets"])) == n0 for o in outs)


def test_fallback_ring_close_cancels(monkeypatch):
    # Pure-Python ring must honor native semantics: close() cancels a
    # blocked producer (push -> False) and pop() drains then returns None.
    monkeypatch.setattr(native, "_load", lambda: None)
    ring = native.FrameRing((4,), capacity=1)
    assert ring.push(np.zeros(4, np.int16))
    ring.close()
    assert ring.push(np.ones(4, np.int16)) is False
    assert ring.pop() is not None
    assert ring.pop() is None
    assert ring.try_push(np.ones(4, np.int16)) is False


def test_fallback_streamer_and_early_cancel(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: None)
    shape = (2, 2, 2)
    frames = np.arange(3 * 8, dtype=np.int16).reshape((3,) + shape)
    p = str(tmp_path / "f.bin")
    frames.tofile(p)
    s = native.FileFrameStreamer(p, shape, capacity=2, loops=2)
    got = list(s.frames())
    assert s.join() == 6 and len(got) == 6
    assert np.array_equal(got[4], frames[1])
    # Early consumer-side cancel must unblock the producer and not hang.
    s2 = native.FileFrameStreamer(p, shape, capacity=1, loops=1000)
    assert next(iter(s2.frames())) is not None
    s2.close()


def test_native_streamer_early_cancel(tmp_path):
    # Same cancel path through the C++ producer thread.
    shape = (2, 2, 2)
    frames = np.arange(2 * 8, dtype=np.int16).reshape((2,) + shape)
    p = str(tmp_path / "g.bin")
    frames.tofile(p)
    s = native.FileFrameStreamer(p, shape, capacity=1, loops=100000)
    assert next(iter(s.frames())) is not None
    s.close()  # joins the C++ thread; must return promptly
