"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

The sharded pipeline (all-to-all corner turn + ppermute CFAR halo exchange)
must reproduce the single-chip pipeline exactly — detection parity is the
multi-chip correctness criterion (SURVEY.md §4, BASELINE config 3).
"""

import numpy as np
import pytest
import jax

from fmcw_tpu import quick
from fmcw_tpu.golden import reference as ref
from fmcw_tpu.models import pipeline as pl
from fmcw_tpu.parallel import mesh as M, sharded as sh

Q = quick()


@pytest.fixture(scope="module")
def batch():
    frames = [ref.two_target_frame(Q, seed=s) for s in range(4)]
    return np.stack([pl.complex_to_iq(f) for f in frames])


def _single_reference(batch, **kw):
    proc = pl.make_batch_processor(Q, include_maps=True, **kw)
    return jax.tree.map(np.asarray, proc(batch))


@pytest.mark.parametrize("dp,sp", [(1, 8), (2, 4), (4, 2)])
def test_sharded_matches_single_chip_float(batch, dp, sp):
    mesh = M.make_mesh(dp=dp, sp=sp)
    proc = sh.make_sharded_processor(mesh, Q, mode="float32", include_maps=True)
    out = jax.tree.map(np.asarray, proc(batch))
    single = _single_reference(batch, mode="float32")
    # Maps agree to float tolerance (all-to-all reorders reductions).
    np.testing.assert_allclose(out["mag_map"], single["mag_map"], rtol=2e-5)
    # Detection decisions identical.
    assert np.array_equal(out["det_map"] > 0, single["det_map"] > 0)
    assert np.array_equal(out["n_dets"], single["n_dets"])
    # Extracted detection lists identical where valid.
    v = single["valid"]
    assert np.array_equal(out["valid"], v)
    assert np.array_equal(out["range_bin"][v], single["range_bin"][v])
    assert np.array_equal(out["doppler_bin"][v], single["doppler_bin"][v])


def test_sharded_matches_single_chip_fixed(batch):
    mesh = M.make_mesh(dp=2, sp=4)
    proc = sh.make_sharded_processor(mesh, Q, mode="fixed", include_maps=True)
    out = jax.tree.map(np.asarray, proc(batch))
    single = _single_reference(batch, mode="fixed")
    # Integer pipeline: bit-identical maps and detections.
    assert np.array_equal(out["mag_map"], single["mag_map"])
    assert np.array_equal(out["det_map"], single["det_map"])
    assert np.array_equal(out["n_dets"], single["n_dets"])


@pytest.mark.parametrize("mode,scale_mode", [
    ("float32", "cell"), ("float32", "block"), ("fixed", "block"),
])
def test_sharded_reflect_matches_single_chip(batch, mode, scale_mode):
    """edge_mode='reflect' across shards: global edges mirror locally on the
    edge shards, interior boundaries exchange neighbor rows; the block scale
    uses the single-chip clip semantics.  Fixed mode is bit-identical;
    float mode must make identical detection decisions."""
    import dataclasses

    p = Q.replace(cfar=dataclasses.replace(Q.cfar, edge_mode="reflect",
                                           scale_mode=scale_mode))
    mesh = M.make_mesh(dp=2, sp=4)
    proc = sh.make_sharded_processor(mesh, p, mode=mode, include_maps=True)
    out = jax.tree.map(np.asarray, proc(batch))
    single = jax.tree.map(
        np.asarray, pl.make_batch_processor(p, mode=mode,
                                            include_maps=True)(batch))
    if mode == "fixed":
        assert np.array_equal(out["mag_map"], single["mag_map"])
        assert np.array_equal(out["det_map"], single["det_map"])
    else:
        assert np.array_equal(out["det_map"] > 0, single["det_map"] > 0)
    assert np.array_equal(out["n_dets"], single["n_dets"])
    v = single["valid"]
    assert np.array_equal(out["range_bin"][v], single["range_bin"][v])


def test_sharded_halo_too_large():
    import dataclasses

    mesh = M.make_mesh(dp=2, sp=4)   # nr_local = 32
    p = Q.replace(cfar=dataclasses.replace(
        Q.cfar, edge_mode="reflect", ref_range=24, guard_range=8))  # halo 32
    with pytest.raises(ValueError, match="reflect"):
        sh.make_sharded_processor(mesh, p)
    p2 = Q.replace(cfar=dataclasses.replace(
        Q.cfar, ref_range=30, guard_range=5))   # halo 35 > 32, wrap mode
    with pytest.raises(ValueError, match="halo_range"):
        sh.make_sharded_processor(mesh, p2)


def test_sharded_runtime_controls(batch):
    mesh = M.make_mesh(dp=1, sp=8)
    proc = sh.make_sharded_processor(mesh, Q, mode="float32")
    a = proc(batch, mti_bypass=True)
    b = proc(batch, scale_override=7)
    assert proc.jitted._cache_size() == 1
    sa = pl.make_batch_processor(Q, mode="float32", include_maps=False)(
        batch, mti_bypass=True)
    assert np.array_equal(np.asarray(a["n_dets"]), np.asarray(sa["n_dets"]))


def test_sharded_peak_grouping(batch):
    mesh = M.make_mesh(dp=1, sp=8)
    proc = sh.make_sharded_processor(mesh, Q, mode="float32",
                                     peak_group_radius=2, include_maps=True)
    out = jax.tree.map(np.asarray, proc(batch))
    single = _single_reference(batch, mode="float32", peak_group_radius=2)
    assert np.array_equal(out["det_map"] > 0, single["det_map"] > 0)


def test_shape_validation(batch):
    mesh = M.make_mesh(dp=2, sp=4)
    proc = sh.make_sharded_processor(mesh, Q)
    with pytest.raises(ValueError, match="divisible by dp"):
        proc(batch[:3])
    with pytest.raises(ValueError, match="expected iq batch"):
        proc(batch[:, :, :64])
    with pytest.raises(ValueError, match="must divide"):
        sh.make_sharded_processor(M.make_mesh(dp=1, sp=8),
                                  Q.replace(n_doppler=12))


def _dets2(out, i):
    v = out["valid"][i]
    return set(zip(out["range_bin"][i][v].tolist(),
                   out["doppler_bin"][i][v].tolist()))


def test_sharded_fused_frontend_dp_only():
    """Pure frame-DP mesh (sp=1): every device runs whole frames through
    the same chain as the single device; detections bit-identical to the
    single-device batch processor (the max-throughput multi-device
    configuration)."""
    import dataclasses
    from fmcw_tpu import RadarParams

    p = RadarParams(n_range=256, n_doppler=32)
    p = p.replace(cfar=dataclasses.replace(p.cfar, scale_mode="block",
                                           scale_block=2))
    frames = [ref.two_target_frame(p, seed=s) for s in range(8)]
    batch = np.stack([pl.complex_to_iq(f) for f in frames])
    mesh = M.make_mesh(dp=8, sp=1)
    proc = sh.make_sharded_processor(mesh, p, mode="float32",
                                     include_maps=True)
    out = jax.tree.map(np.asarray, proc(batch))
    single = pl.make_batch_processor(p, mode="float32", include_maps=True)
    want = jax.tree.map(np.asarray, single(batch))
    # Per-frame vs batched matmuls sum in another order: maps agree to a
    # peak-relative float tolerance, decisions exactly.
    np.testing.assert_allclose(out["mag_map"], want["mag_map"], rtol=0,
                               atol=1e-5 * want["mag_map"].max())
    assert np.array_equal(out["det_map"] > 0, want["det_map"] > 0)
    assert np.array_equal(out["n_dets"], want["n_dets"])
    assert np.array_equal(out["valid"], want["valid"])
    for i in range(len(batch)):
        assert _dets2(out, i) == _dets2(want, i)
    assert out["nonfinite_count"].sum() == 0
    assert proc.routes == pl.make_processor(p).routes
    # A removed route raises on any mesh.
    with pytest.raises(ValueError, match="no compiled route"):
        sh.make_sharded_processor(M.make_mesh(dp=1, sp=8), p,
                                  mode="float32", cfar_method="pallas")


def test_sharded_fused_fixed_dp_only():
    """Pure frame-DP mesh in mode='fixed': detections and saturation
    counts bit-identical to the single-device fixed chain."""
    import dataclasses
    from fmcw_tpu import RadarParams

    p = RadarParams(n_range=256, n_doppler=32)
    p = p.replace(cfar=dataclasses.replace(p.cfar, scale_mode="block",
                                           scale_block=2))
    frames = [ref.two_target_frame(p, seed=s) for s in range(8)]
    batch = np.stack([pl.complex_to_iq(f) for f in frames])
    mesh = M.make_mesh(dp=8, sp=1)
    proc = sh.make_sharded_processor(mesh, p, mode="fixed",
                                     include_maps=True)
    out = jax.tree.map(np.asarray, proc(batch))
    single = pl.make_batch_processor(p, mode="fixed", include_maps=True)
    want = jax.tree.map(np.asarray, single(batch))
    assert np.array_equal(out["det_map"] > 0, want["det_map"] > 0)
    assert np.array_equal(out["n_dets"], want["n_dets"])
    assert np.array_equal(out["valid"], want["valid"])
    for i in range(len(batch)):
        assert _dets2(out, i) == _dets2(want, i)
    assert np.array_equal(out["saturation_count"], want["saturation_count"])
    assert out["mag"].dtype == want["mag"].dtype
    with pytest.raises(ValueError, match="no compiled route"):
        sh.make_sharded_processor(M.make_mesh(dp=1, sp=8), p,
                                  mode="fixed", fft_method="pallas")


def _element_batch(p, n_elems, n_frames, seed0=4):
    """Point-source element-space batches (per-element phase-shifted copies
    of a single-channel target frame plus independent noise)."""
    rng = np.random.default_rng(seed0)
    frames = []
    for b in range(n_frames):
        z = np.asarray(ref.two_target_frame(p, seed=seed0 + b,
                                            targets=((60, 20, 12000),)))
        elems = []
        for e in range(n_elems):
            ph = np.exp(2j * np.pi * 0.5 * e * 0.4)
            noisy = z * ph + (rng.normal(0, 8, z.shape)
                              + 1j * rng.normal(0, 8, z.shape))
            elems.append(pl.complex_to_iq(noisy))
        frames.append(np.stack(elems))
    return np.stack(frames)


def _array_params():
    import dataclasses
    from fmcw_tpu import RadarParams

    p = RadarParams(n_range=256, n_doppler=64)
    return p.replace(cfar=dataclasses.replace(p.cfar, scale_block=2))


def _dets3(out, i):
    v = out["valid"][i]
    return set(zip(out["beam_bin"][i][v].tolist(),
                   out["range_bin"][i][v].tolist(),
                   out["doppler_bin"][i][v].tolist()))


@pytest.mark.parametrize("dp,sp,ref_angle,guard_angle", [
    (2, 4, 0, 0),     # per-beam 2D decisions, beams sharded
    (1, 8, 1, 0),     # cross-beam training set: beam-plane halo exchange
    (2, 4, 1, 1),     # halo = 2 = full local beam extent
])
def test_sharded_array_matches_single_chip(dp, sp, ref_angle, guard_angle):
    """Beams sharded over sp: identical detection sets, counts, and cubes
    vs the single-chip array model (same XLA front-end on both sides)."""
    p = _array_params()
    n_elems = n_beams = 8
    batch = _element_batch(p, n_elems, 2 * dp)
    mesh = M.make_mesh(dp=dp, sp=sp)
    proc = sh.make_sharded_array_processor(
        mesh, p, n_elems=n_elems, n_beams=n_beams, ref_angle=ref_angle,
        guard_angle=guard_angle, include_maps=True)
    out = jax.tree.map(np.asarray, proc(batch))
    single = pl.make_array_processor(
        p, n_elems=n_elems, n_beams=n_beams, ref_angle=ref_angle,
        guard_angle=guard_angle, include_maps=True)
    for i in range(batch.shape[0]):
        want = jax.tree.map(np.asarray, single(batch[i]))
        assert out["n_dets"][i] == want["n_dets"]
        assert _dets3(out, i) == set(zip(
            want["beam_bin"][want["valid"]].tolist(),
            want["range_bin"][want["valid"]].tolist(),
            want["doppler_bin"][want["valid"]].tolist()))
        assert _dets3(out, i)           # nonempty
        np.testing.assert_allclose(out["mag_cube"][i], want["mag_cube"],
                                   rtol=2e-5)
        assert np.array_equal(out["det_cube"][i] > 0, want["det_cube"] > 0)
        assert out["nonfinite_count"][i] == want["nonfinite_count"]


def test_sharded_array_reflect_edges():
    """edge_mode='reflect': the angle halo mirrors locally on the edge beam
    shards; detections still match the single chip exactly."""
    import dataclasses

    p = _array_params()
    p = p.replace(cfar=dataclasses.replace(p.cfar, edge_mode="reflect"))
    n_elems = n_beams = 8
    batch = _element_batch(p, n_elems, 2, seed0=11)
    mesh = M.make_mesh(dp=2, sp=4)
    proc = sh.make_sharded_array_processor(
        mesh, p, n_elems=n_elems, n_beams=n_beams, ref_angle=1)
    out = jax.tree.map(np.asarray, proc(batch))
    single = pl.make_array_processor(p, n_elems=n_elems, n_beams=n_beams,
                                     ref_angle=1, include_maps=False)
    for i in range(batch.shape[0]):
        want = jax.tree.map(np.asarray, single(batch[i]))
        assert out["n_dets"][i] == want["n_dets"]
        assert _dets3(out, i) == set(zip(
            want["beam_bin"][want["valid"]].tolist(),
            want["range_bin"][want["valid"]].tolist(),
            want["doppler_bin"][want["valid"]].tolist()))


def test_sharded_array_halo_gate():
    """ref_angle+guard_angle beyond the local beam extent refuses (the ring
    exchange is single-hop)."""
    p = _array_params()
    mesh = M.make_mesh(dp=1, sp=8)       # 8 beams / 8 shards -> bl = 1
    with pytest.raises(ValueError, match="angle halo"):
        sh.make_sharded_array_processor(mesh, p, n_elems=8, n_beams=8,
                                        ref_angle=2)


def test_sharded_array_grouping_matches_single_chip():
    """peak_group_radius + beam_group_radius on the beam-sharded mesh: the
    cross-shard beam-plane exchange reproduces the single-chip grouping
    (non-periodic beam edges included) exactly."""
    p = _array_params()
    n_elems = n_beams = 8
    batch = _element_batch(p, n_elems, 2, seed0=21)
    kw = dict(n_elems=n_elems, n_beams=n_beams, peak_group_radius=2,
              beam_group_radius=1)
    mesh = M.make_mesh(dp=2, sp=4)
    proc = sh.make_sharded_array_processor(mesh, p, include_maps=True, **kw)
    out = jax.tree.map(np.asarray, proc(batch))
    single = pl.make_array_processor(p, include_maps=True, **kw)
    for i in range(batch.shape[0]):
        want = jax.tree.map(np.asarray, single(batch[i]))
        assert out["n_dets"][i] == want["n_dets"]
        assert _dets3(out, i) == set(zip(
            want["beam_bin"][want["valid"]].tolist(),
            want["range_bin"][want["valid"]].tolist(),
            want["doppler_bin"][want["valid"]].tolist()))
        assert np.array_equal(out["det_cube"][i] > 0, want["det_cube"] > 0)


@pytest.mark.slow
def test_sharded_production_shape_matches_single_chip():
    """The PRODUCTION shape: 1024x128 — the map size the reference's corner
    turn is defined at (rtl/src/corner_turner.vhd:29-36, radar_core.vhd:12-14).
    An sp=4 mesh shards nr_local=256 rows per chip; a divisibility / halo /
    block-grid bug specific to full-size shards would be invisible at the
    toy shapes above.  Fixed mode: bit-identical maps + detection-set
    equality.  Float block+cell with peak grouping: identical decisions."""
    import dataclasses
    from fmcw_tpu import RadarParams

    p = RadarParams()                      # 1024x128, production CFAR
    frames = [ref.two_target_frame(p, seed=s) for s in range(2)]
    fb = np.stack([pl.complex_to_iq(f) for f in frames])
    mesh = M.make_mesh(dp=2, sp=4)

    # Fixed mode: the exact-parity invariant at full size.
    proc = sh.make_sharded_processor(mesh, p, mode="fixed", include_maps=True)
    out = jax.tree.map(np.asarray, proc(fb))
    single = jax.tree.map(
        np.asarray, pl.make_batch_processor(p, mode="fixed",
                                            include_maps=True)(fb))
    assert np.array_equal(out["mag_map"], single["mag_map"])
    assert np.array_equal(out["det_map"], single["det_map"])
    assert np.array_equal(out["n_dets"], single["n_dets"])
    v = single["valid"]
    assert np.array_equal(out["valid"], v)
    assert np.array_equal(out["range_bin"][v], single["range_bin"][v])
    assert np.array_equal(out["doppler_bin"][v], single["doppler_bin"][v])
    assert np.array_equal(out["mag"][v], single["mag"][v])

    # Float32, per-cell and block scale, with peak grouping (the bench's
    # headline configurations) — identical detection decisions.
    for scale_mode in ("cell", "block"):
        pf = p.replace(cfar=dataclasses.replace(p.cfar,
                                                scale_mode=scale_mode))
        procf = sh.make_sharded_processor(mesh, pf, mode="float32",
                                          peak_group_radius=2,
                                          include_maps=True)
        outf = jax.tree.map(np.asarray, procf(fb))
        singlef = jax.tree.map(np.asarray, pl.make_batch_processor(
            pf, mode="float32", include_maps=True,
            peak_group_radius=2)(fb))
        assert np.array_equal(outf["det_map"] > 0, singlef["det_map"] > 0), \
            scale_mode
        assert np.array_equal(outf["n_dets"], singlef["n_dets"]), scale_mode
        vf = singlef["valid"]
        assert np.array_equal(outf["valid"], vf), scale_mode
        assert np.array_equal(outf["range_bin"][vf],
                              singlef["range_bin"][vf]), scale_mode
        assert np.array_equal(outf["doppler_bin"][vf],
                              singlef["doppler_bin"][vf]), scale_mode


def test_sharded_array_fused_frontend_ref_angle():
    """Beam-sharded mesh at ref_angle=1 with a guard-free angle window:
    identical detection sets, counts and cubes vs the single-device array
    model."""
    p = _array_params()
    n_elems = n_beams = 8
    batch = _element_batch(p, n_elems, 2, seed0=31)
    kw = dict(n_elems=n_elems, n_beams=n_beams, ref_angle=1, guard_angle=0)
    mesh = M.make_mesh(dp=2, sp=4)
    proc = sh.make_sharded_array_processor(mesh, p, include_maps=True, **kw)
    out = jax.tree.map(np.asarray, proc(batch))
    single = pl.make_array_processor(p, include_maps=True, **kw)
    for i in range(batch.shape[0]):
        want = jax.tree.map(np.asarray, single(batch[i]))
        assert out["n_dets"][i] == want["n_dets"]
        assert _dets3(out, i) == set(zip(
            want["beam_bin"][want["valid"]].tolist(),
            want["range_bin"][want["valid"]].tolist(),
            want["doppler_bin"][want["valid"]].tolist()))
        assert _dets3(out, i)           # nonempty
        np.testing.assert_array_equal(out["mag_cube"][i], want["mag_cube"])
        assert np.array_equal(out["det_cube"][i] > 0, want["det_cube"] > 0)


def test_sharded_array_grouped_sliced_matches_single_chip():
    """Grouped extraction (2D + beam grouping) on the beam-sharded mesh:
    detection sets equal the single-device model's, including the
    cross-shard beam halos."""
    p = _array_params()
    n_elems = n_beams = 8
    batch = _element_batch(p, n_elems, 2, seed0=37)
    kw = dict(n_elems=n_elems, n_beams=n_beams, peak_group_radius=2,
              beam_group_radius=1)
    mesh = M.make_mesh(dp=2, sp=4)
    proc = sh.make_sharded_array_processor(mesh, p, include_maps=True, **kw)
    out = jax.tree.map(np.asarray, proc(batch))
    single = pl.make_array_processor(p, include_maps=True, **kw)
    for i in range(batch.shape[0]):
        want = jax.tree.map(np.asarray, single(batch[i]))
        assert out["n_dets"][i] == want["n_dets"]
        assert _dets3(out, i) == set(zip(
            want["beam_bin"][want["valid"]].tolist(),
            want["range_bin"][want["valid"]].tolist(),
            want["doppler_bin"][want["valid"]].tolist()))
        assert np.array_equal(out["det_cube"][i], want["det_cube"])


@pytest.mark.parametrize("mode", ["fixed", "float32"])
def test_sharded_debug_taps_match_single_chip(batch, mode):
    """include_debug on the sharded processor (round-5 verdict item 5): the
    dbg_threshold/dbg_scale taps (os_cfar_2d.vhd:34-35,219-220) come back
    sp-sharded and equal the single chip's — bit-exact in fixed mode (and
    in float on CPU, where both sides run the identical XLA formulation)."""
    mesh = M.make_mesh(dp=2, sp=4)
    proc = sh.make_sharded_processor(mesh, Q, mode=mode, include_maps=True,
                                     include_debug=True)
    out = jax.tree.map(np.asarray, proc(batch))
    single = jax.tree.map(np.asarray, pl.make_batch_processor(
        Q, mode=mode, include_maps=True, include_debug=True)(batch))
    assert out["threshold_map"].shape == single["threshold_map"].shape
    assert np.array_equal(out["threshold_map"], single["threshold_map"])
    assert np.array_equal(out["scale_map"], single["scale_map"])
    assert np.array_equal(out["det_map"], single["det_map"])


def test_sharded_debug_taps_reflect_and_block(batch):
    """Debug taps stay exact with reflect edges and with the block
    (clutter-map) scale mode."""
    import dataclasses
    for cfar_kw in ({"edge_mode": "reflect"}, {"scale_mode": "block",
                                               "scale_block": 8}):
        p = Q.replace(cfar=dataclasses.replace(Q.cfar, **cfar_kw))
        mesh = M.make_mesh(dp=1, sp=8)
        proc = sh.make_sharded_processor(mesh, p, mode="fixed",
                                         include_debug=True)
        out = jax.tree.map(np.asarray, proc(batch))
        single = jax.tree.map(np.asarray, pl.make_batch_processor(
            p, mode="fixed", include_maps=False, include_debug=True)(batch))
        assert np.array_equal(out["threshold_map"], single["threshold_map"])
        assert np.array_equal(out["scale_map"], single["scale_map"])
