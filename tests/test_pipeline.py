"""Single-device JAX pipeline tests — parity vs the numpy golden models.

The pipeline (models/pipeline.py) must reproduce the golden chains:
float32 mode vs the float64 reference within tight relative error, fixed mode
vs the bit-faithful fixed-point model with exact detection parity.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from fmcw_tpu import RadarParams, quick
from fmcw_tpu.golden import reference as ref
from fmcw_tpu.models import pipeline as pl

Q = quick()


@pytest.fixture(scope="module")
def qframe():
    return ref.two_target_frame(Q, seed=5)


@pytest.fixture(scope="module")
def qiq(qframe):
    return pl.complex_to_iq(qframe)


def test_float_pipeline_quick_detects_targets(qiq):
    proc = pl.make_processor(Q, mode="float32", peak_group_radius=2)
    out = jax.tree.map(np.asarray, proc(qiq))
    v = out["valid"]
    got = set(zip(out["range_bin"][v][:2].tolist(),
                  out["doppler_bin"][v][:2].tolist()))
    # Scaled golden targets: (12, 1.25) and (62, -2.5->29.5) in a 128x32 map;
    # fractional Doppler spreads over two bins.
    rows = {r for r, _ in got}
    assert rows <= {11, 12, 13, 61, 62, 63}
    assert len({r // 30 for r, _ in got}) == 2  # one det per target cluster


def test_float_pipeline_matches_float_golden(qframe, qiq):
    proc = pl.make_processor(Q, mode="float32")
    out = jax.tree.map(np.asarray, proc(qiq))
    res = ref.process_frame(qframe, Q)
    rel = np.max(np.abs(out["mag_map"] - res.mag_map)) / res.mag_map.max()
    assert rel < 1e-4
    # Detection sets identical.
    dj = set(map(tuple, np.argwhere(out["det_map"] > 0)))
    dg = set(map(tuple, np.argwhere(res.det_map > 0)))
    assert dj == dg


def test_fixed_pipeline_matches_fixed_golden(qframe, qiq):
    proc = pl.make_processor(Q, mode="fixed")
    out = jax.tree.map(np.asarray, proc(qiq))
    magg, detg = ref.process_frame_fixed(qframe, Q)
    # FFT in f32 vs numpy f64: magnitudes agree within a few LSB...
    diff = np.abs(out["mag_map"].astype(np.int64) - magg)
    assert diff.max() <= 8
    # ...and the detection decisions match exactly.
    dj = set(map(tuple, np.argwhere(out["det_map"] > 0)))
    dg = set(map(tuple, np.argwhere(detg > 0)))
    assert dj == dg


def test_fixed_pipeline_full_size_parity():
    p = RadarParams()
    frame = ref.two_target_frame(p)
    iq = pl.complex_to_iq(frame)
    out = jax.tree.map(np.asarray, pl.make_processor(p, mode="fixed")(iq))
    magg, detg = ref.process_frame_fixed(frame, p)
    dj = set(map(tuple, np.argwhere(out["det_map"] > 0)))
    dg = set(map(tuple, np.argwhere(detg > 0)))
    assert dj == dg
    assert np.abs(out["mag_map"].astype(np.int64) - magg).max() <= 8
    # Both target clusters among the strongest detections (BFP flattening
    # splits peaks across 499/501 — docs/design_notes.md §3).
    v = out["valid"]
    top_rows = out["range_bin"][v][:6].tolist()
    assert set(top_rows) <= set(range(98, 103)) | set(range(498, 503))
    assert {r // 300 for r in top_rows} == {0, 1}


def test_runtime_controls_are_traced(qiq):
    proc = pl.make_processor(Q, mode="float32")
    out_a = proc(qiq, mti_bypass=False)
    out_b = proc(qiq, mti_bypass=True)
    assert not np.allclose(np.asarray(out_a["mag_map"]),
                           np.asarray(out_b["mag_map"]))
    out_c = proc(qiq, scale_override=7)
    out_d = proc(qiq, scale_override=1)
    assert (np.asarray(out_d["n_dets"]) >= np.asarray(out_c["n_dets"]))
    # Same compiled executable for all control values (controls are traced,
    # not static): jit cache has exactly one entry.
    assert proc.jitted._cache_size() == 1


def test_mti_bypass_matches_golden_bypass(qframe, qiq):
    proc = pl.make_processor(Q, mode="fixed")
    out = jax.tree.map(np.asarray, proc(qiq, mti_bypass=True))
    magg, _ = ref.process_frame_fixed(qframe, Q, mti_bypass=True)
    assert np.abs(out["mag_map"].astype(np.int64) - magg).max() <= 8


def test_batch_processor(qiq):
    batch = np.stack([qiq, qiq, qiq])
    proc = pl.make_batch_processor(Q, mode="float32", include_maps=False)
    out = jax.tree.map(np.asarray, proc(batch))
    assert out["range_bin"].shape == (3, Q.tracker.max_dets)
    assert np.array_equal(out["n_dets"], np.repeat(out["n_dets"][0], 3))


def test_detection_topk_semantics():
    from fmcw_tpu.ops.detect import topk_detections
    m = np.zeros((16, 8), dtype=np.float32)
    m[3, 2] = 10.0
    m[7, 5] = 30.0
    m[1, 1] = 20.0
    out = jax.tree.map(np.asarray, topk_detections(m, max_dets=4))
    assert out["n_dets"] == 3
    assert out["valid"].tolist() == [True, True, True, False]
    assert out["range_bin"][:3].tolist() == [7, 1, 3]
    assert out["doppler_bin"][:3].tolist() == [5, 1, 2]


def test_detection_topk_two_stage_identical():
    # The large-map two-stage reduction must be indistinguishable from the
    # flat top_k, including tie order (stable by row-major index).
    from fmcw_tpu.ops.detect import topk_detections
    rng = np.random.default_rng(0)
    m = np.zeros((256, 128), dtype=np.float32)  # > 16384 cells -> two-stage
    # sparse detections with heavy value ties across rows and columns
    cells = rng.choice(256 * 128, size=300, replace=False)
    m.ravel()[cells] = rng.choice([5.0, 7.0, 7.0, 9.0], size=300)
    out = jax.tree.map(np.asarray, topk_detections(m, max_dets=64))
    vals, idx = jax.lax.top_k(m.ravel(), 64)
    assert np.array_equal(out["mag"], np.asarray(vals))
    assert np.array_equal(out["range_bin"] * 128 + out["doppler_bin"],
                          np.asarray(idx))
    assert out["n_dets"] == 300


def test_detection_topk_row_select_adversarial():
    # Worst cases for the row-select reduction: (a) one row holding far more
    # than max_dets detections, (b) more tie rows at the k-th value than
    # tie slots, (c) fewer detections than max_dets (k-th value ties at 0
    # across almost every row).  All must equal the flat top_k exactly.
    from fmcw_tpu.ops.detect import topk_detections

    def check(m, k=64):
        out = jax.tree.map(np.asarray, topk_detections(m, max_dets=k))
        vals, idx = jax.lax.top_k(m.ravel(), k)
        assert np.array_equal(out["mag"], np.asarray(vals))
        sel = np.asarray(out["range_bin"]) * m.shape[1] + np.asarray(
            out["doppler_bin"])
        assert np.array_equal(sel, np.asarray(idx))

    R, D = 256, 128
    m = np.zeros((R, D), dtype=np.float32)
    m[17, :100] = np.arange(100, 0, -1).astype(np.float32)  # dense row
    m[40, 3] = 1000.0
    check(m)

    m = np.zeros((R, D), dtype=np.float32)
    m[100:230, 7] = 5.0        # 130 rows tied at the boundary value
    m[5, 2] = 9.0
    check(m)

    m = np.zeros((R, D), dtype=np.float32)
    m[9, 9] = 3.0              # n_dets << max_dets, ties at 0 everywhere
    m[200, 100] = 3.0          # and a positive tie across distant rows
    check(m)


def test_fft_methods_agree(qiq):
    from fmcw_tpu.ops import fft as F
    re = qiq[..., 0].astype(np.float32)
    im = qiq[..., 1].astype(np.float32)
    r1, i1 = F.fft_apply(re, im, axis=1, window=True, method="matmul")
    r2, i2 = F.fft_apply(re, im, axis=1, window=True, method="xla")
    scale = np.abs(np.asarray(r2)).max()
    assert np.max(np.abs(np.asarray(r1) - np.asarray(r2))) / scale < 1e-5
    assert np.max(np.abs(np.asarray(i1) - np.asarray(i2))) / scale < 1e-5


@pytest.mark.parametrize("mode,transient,bypass", [
    (2, "zero", False), (2, "passthrough", False), (3, "zero", False),
    (3, "passthrough", False), (2, "zero", True),
])
def test_fused_doppler_matches_explicit_chain(mode, transient, bypass):
    # doppler_apply == .T -> mti_notch_float -> windowed fft_apply, within
    # f32 tolerance, for every transient/mode/bypass combination.
    from fmcw_tpu.ops import fft as F, notch as N
    rng = np.random.default_rng(7)
    nd, nr = 32, 64
    re = rng.normal(size=(nd, nr)).astype(np.float32) * 1000
    im = rng.normal(size=(nd, nr)).astype(np.float32) * 1000

    fr, fi = F.doppler_apply(jnp.asarray(re), jnp.asarray(im), axis=0,
                             bypass=jnp.asarray(bypass), notch_mode=mode,
                             transient=transient)

    er, ei = N.mti_notch_float(jnp.asarray(re.T), jnp.asarray(im.T), axis=1,
                               mode=mode, bypass=jnp.asarray(bypass),
                               transient=transient)
    er, ei = F.fft_apply(er, ei, axis=1, window=True, method="matmul")
    scale = max(np.abs(np.asarray(er)).max(), 1.0)
    assert np.max(np.abs(np.asarray(fr) - np.asarray(er))) / scale < 1e-5
    assert np.max(np.abs(np.asarray(fi) - np.asarray(ei))) / scale < 1e-5


def test_saturation_counter(qframe):
    # Full-scale input saturates the fixed window stage and reports it
    # (the status_overflow analog, radar_core.vhd:447-456).
    big = np.full((Q.n_doppler, Q.n_range), 32767 + 32767j)
    iq = pl.complex_to_iq(big)
    proc = pl.make_processor(Q, mode="fixed", include_maps=False)
    out = proc(iq)
    assert int(out["saturation_count"]) > 0


def test_fft_ct_method_agrees(qiq):
    # Two-stage Cooley-Tukey matmul FFT vs the XLA FFT, both axes.
    from fmcw_tpu.ops import fft as F
    re = qiq[..., 0].astype(np.float32)
    im = qiq[..., 1].astype(np.float32)
    for axis in (0, 1):
        r1, i1 = F.fft_apply(re, im, axis=axis, window=True, method="ct")
        r2, i2 = F.fft_apply(re, im, axis=axis, window=True, method="xla")
        scale = np.abs(np.asarray(r2)).max()
        assert np.max(np.abs(np.asarray(r1) - np.asarray(r2))) / scale < 1e-5
        assert np.max(np.abs(np.asarray(i1) - np.asarray(i2))) / scale < 1e-5


def test_pipeline_ct_fft_detection_parity(qiq):
    # Full float pipeline with fft_method="ct" finds the same detections.
    p1 = pl.make_processor(Q, mode="float32", include_maps=False)
    p2 = pl.make_processor(Q, mode="float32", include_maps=False,
                           fft_method="ct")
    o1, o2 = p1(qiq), p2(qiq)
    v = np.asarray(o1["valid"])
    assert np.array_equal(v, np.asarray(o2["valid"]))
    assert np.array_equal(np.asarray(o1["range_bin"])[v],
                          np.asarray(o2["range_bin"])[v])
    assert np.array_equal(np.asarray(o1["doppler_bin"])[v],
                          np.asarray(o2["doppler_bin"])[v])


def test_frontend_auto_falls_back_on_unsupported_shapes():
    """Every frame shape runs on the one compiled chain — including range
    extents no Cooley-Tukey slice layout holds (n_range not a multiple of
    128, or more than 16 slices) — and a removed route raises up front."""
    from fmcw_tpu import RadarParams

    for nr in (320, 4096):
        p = RadarParams(n_range=nr, n_doppler=16)
        proc = pl.make_processor(p, mode="float32", include_maps=False)
        iq = pl.complex_to_iq(ref.two_target_frame(p, seed=1))
        out = jax.tree.map(np.asarray, proc(iq))     # must not raise
        assert out["range_bin"].shape[0] == p.tracker.max_dets
        assert proc.routes.range_fft == "matmul"
        with pytest.raises(ValueError, match="no compiled route"):
            pl.make_processor(p, mode="float32", cfar_method="pallas")
