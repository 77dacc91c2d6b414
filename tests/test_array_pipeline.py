"""Array-radar model (pipeline.make_array_processor): beamformer ->
per-beam RDM -> 3D CFAR -> (beam, range, doppler) detections."""

import numpy as np
import jax

from fmcw_tpu import RadarParams, CfarParams
from fmcw_tpu.golden import reference
from fmcw_tpu.models import pipeline as pl
from fmcw_tpu.ops.beamform import steering_matrix

P = RadarParams(n_range=256, n_doppler=64,
                cfar=CfarParams(scale_block=2))
N_ELEMS = 8
N_BEAMS = 8


def _element_frames(u0: float, seed: int = 4):
    """Point source at steering sine ``u0``: per-element phase-shifted
    copies of a single-channel target frame (plus independent noise)."""
    rng = np.random.default_rng(seed)
    z = np.asarray(reference.two_target_frame(P, seed=seed,
                                              targets=((60, 20, 12000),)))
    elems = []
    for e in range(N_ELEMS):
        ph = np.exp(2j * np.pi * 0.5 * e * u0)   # wavefront phase; W conjugates
        noisy = z * ph + (rng.normal(0, 8, z.shape)
                          + 1j * rng.normal(0, 8, z.shape))
        elems.append(pl.complex_to_iq(noisy))
    return np.stack(elems)


def test_point_source_lands_in_matched_beam():
    u0 = 0.4
    iq = _element_frames(u0)
    proc = pl.make_array_processor(P, n_elems=N_ELEMS, n_beams=N_BEAMS)
    out = jax.tree.map(np.asarray, proc(iq))
    assert out["valid"].any()
    # strongest detection: correct range/Doppler and the beam steered
    # closest to u0
    wr, _ = steering_matrix(N_ELEMS, N_BEAMS)
    u = np.linspace(-np.sin(np.deg2rad(60.0)), np.sin(np.deg2rad(60.0)),
                    N_BEAMS)
    b_star = int(np.argmin(np.abs(u - u0)))
    assert out["beam_bin"][0] == b_star
    assert abs(int(out["range_bin"][0]) - 60) <= 1
    assert abs(int(out["doppler_bin"][0]) - 20) <= 1
    assert out["nonfinite_count"] == 0


def test_single_element_single_beam_matches_2d_pipeline():
    """Degenerate E=1/B=1 array (unit steering weight): detections equal
    the single-channel float pipeline's."""
    frame = pl.complex_to_iq(reference.two_target_frame(P, seed=2))
    proc_a = pl.make_array_processor(P, n_elems=1, n_beams=1)
    out_a = jax.tree.map(np.asarray, proc_a(frame[None]))
    proc_2d = pl.make_processor(P, mode="float32", include_maps=True)
    out_2d = jax.tree.map(np.asarray, proc_2d(frame))
    assert np.array_equal(out_a["det_cube"][0] > 0, out_2d["det_map"] > 0)
    v = out_2d["valid"]
    assert np.array_equal(out_a["valid"], v)
    assert np.array_equal(out_a["range_bin"][v], out_2d["range_bin"][v])
    assert np.array_equal(out_a["doppler_bin"][v], out_2d["doppler_bin"][v])
    assert (out_a["beam_bin"][v] == 0).all()


def test_fused_frontend_matches_xla_chain():
    """ref_angle=0: the array model's counting 2D decision per beam equals
    the ranked-stack route (cfar_method='topk') — identical detection
    sets, det cubes and mag cubes — and a removed route raises."""
    import pytest
    iq = _element_frames(0.4, seed=11)
    proc_c = pl.make_array_processor(P, n_elems=N_ELEMS, n_beams=N_BEAMS)
    proc_t = pl.make_array_processor(P, n_elems=N_ELEMS, n_beams=N_BEAMS,
                                     cfar_method="topk")
    assert (proc_c.routes.cfar, proc_t.routes.cfar) == ("count", "topk")
    a = jax.tree.map(np.asarray, proc_c(iq))
    b = jax.tree.map(np.asarray, proc_t(iq))
    assert a["valid"].any()
    for k in ("beam_bin", "range_bin", "doppler_bin", "mag", "valid",
              "n_dets", "det_cube", "mag_cube"):
        assert np.array_equal(a[k], b[k]), k
    with pytest.raises(ValueError, match="no compiled route"):
        pl.make_array_processor(P, n_elems=N_ELEMS, n_beams=N_BEAMS,
                                ref_angle=1, cfar_method="pallas")


def _cfar_3d_float_numpy(cube, cf, ra, ga):
    """float64 3D OS-CFAR with wrap edges on every axis; returns
    (det, threshold)."""
    from fmcw_tpu.ops import cfar as C
    offs = C._offsets_3d(cf, ra, ga)
    c = np.asarray(cube, np.float64)
    refs = np.stack([np.roll(c, (-da, -dr, -dd), axis=(0, 1, 2))
                     for da, dr, dd in offs])
    rank = min((len(offs) * cf.rank_pct) // 100, len(offs) - 1)
    est = np.partition(refs, rank, axis=0)[rank]
    mean = refs.mean(axis=0)
    scale = np.where(est > 1.5 * mean, cf.scale_max,
                     np.where(est < 0.5 * mean, cf.scale_min, cf.scale_nom))
    thr = est * scale
    return np.where(c > thr, c, 0.0), thr


def test_fused_frontend_ref_angle_matches_xla_chain():
    """ref_angle > 0: the angle-extended decision on the model's own mag
    cube equals a float64 numpy 3D OS-CFAR, except cells within 1e-6 of
    their threshold (f32 vs f64 mean)."""
    iq = _element_frames(0.4, seed=13)
    out = jax.tree.map(np.asarray, pl.make_array_processor(
        P, n_elems=N_ELEMS, n_beams=N_BEAMS, ref_angle=1,
        guard_angle=0)(iq))
    want, thr = _cfar_3d_float_numpy(out["mag_cube"], P.cfar, 1, 0)
    diff = np.argwhere((out["det_cube"] > 0) != (want > 0))
    cube = out["mag_cube"].astype(np.float64)
    assert all(abs(cube[tuple(c)] - thr[tuple(c)]) <= 1e-6 * cube[tuple(c)]
               for c in diff)
    assert (want > 0).any()


def test_grouped_sliced_topk_matches_deinterleaved():
    """The grouped extraction (beam grouping + row-select top-K over the
    flattened beam cube) equals the flat top-K of the grouped det cube
    exactly."""
    from fmcw_tpu.ops import detect as DET
    import jax.numpy as jnp

    iq = _element_frames(0.25, seed=17)
    out = jax.tree.map(np.asarray, pl.make_array_processor(
        P, n_elems=N_ELEMS, n_beams=N_BEAMS,
        peak_group_radius=2, beam_group_radius=1, include_maps=True)(iq))
    det = jnp.asarray(out["det_cube"])
    flat = det.reshape(N_BEAMS * P.n_range, P.n_doppler)
    want = jax.tree.map(np.asarray,
                        DET.topk_detections(flat, max_dets=64))
    got = set(zip(out["beam_bin"][out["valid"]].tolist(),
                  out["range_bin"][out["valid"]].tolist(),
                  out["doppler_bin"][out["valid"]].tolist(),
                  out["mag"][out["valid"]].tolist()))
    exp = set(zip((want["range_bin"][want["valid"]] // P.n_range).tolist(),
                  (want["range_bin"][want["valid"]] % P.n_range).tolist(),
                  want["doppler_bin"][want["valid"]].tolist(),
                  want["mag"][want["valid"]].tolist()))
    assert got == exp
    assert int(out["n_dets"]) == int(want["n_dets"])


def test_angle_extended_training_window():
    """ref_angle=1: the 3D training set spans neighbor beams; the point
    source still detects at the matched beam."""
    u0 = -0.25
    iq = _element_frames(u0, seed=9)
    proc = pl.make_array_processor(P, n_elems=N_ELEMS, n_beams=N_BEAMS,
                                   ref_angle=1, guard_angle=0)
    out = jax.tree.map(np.asarray, proc(iq))
    assert out["valid"].any()
    u = np.linspace(-np.sin(np.deg2rad(60.0)), np.sin(np.deg2rad(60.0)),
                    N_BEAMS)
    b_star = int(np.argmin(np.abs(u - u0)))
    assert out["beam_bin"][0] == b_star


def test_element_frames_single_element_matches_frame():
    """element_frames(E=1) consumes the RNG exactly like frame(): a
    1-element array reproduces the single-channel stimulus bit-for-bit."""
    from fmcw_tpu.models import scenario as sc

    s1 = sc.TacticalScenario(P, sc.quick_scenario())
    s2 = sc.TacticalScenario(P, sc.quick_scenario())
    for scan in (1, 2):
        frame, truth = s1.frame(scan)
        ef, truth_b = s2.element_frames(scan, n_elems=1)
        assert np.array_equal(frame, ef[0])
        assert [t[:3] for t in truth_b] == truth
        assert all(len(t) == 4 for t in truth_b)    # adds bearing_u


def test_element_scenario_detects_at_matched_beam():
    """Scenario element synthesis -> beamformed 3D pipeline: the strongest
    detection lands at a truth target's range and its bearing's beam."""
    import dataclasses
    from fmcw_tpu import CfarParams
    from fmcw_tpu.models import scenario as sc

    n = 8
    cfg = sc.quick_scenario()
    cfg.burst_synthesis = False          # point targets: energy in one bin
    # Demo CFAR geometry (guard band covers the target spread).
    p = P.replace(cfar=dataclasses.replace(
        CfarParams(ref_range=4, ref_doppler=3, guard_range=2,
                   guard_doppler=1), scale_block=2))
    scen = sc.TacticalScenario(p, cfg)
    frames, truth = scen.element_frames(1, n_elems=n)
    proc = pl.make_array_processor(p, n_elems=n, n_beams=n)
    out = jax.tree.map(np.asarray, proc(pl.complex_to_iq(frames)))
    assert out["valid"].any()
    u = np.linspace(-np.sin(np.deg2rad(60.0)), np.sin(np.deg2rad(60.0)), n)
    rb0, b0 = int(out["range_bin"][0]), int(out["beam_bin"][0])
    matched = [t for t in truth if abs(t[0] - rb0) <= 2]
    assert matched, (rb0, truth)
    b_star = int(np.argmin(np.abs(u - matched[0][3])))
    assert abs(b0 - b_star) <= 1


def test_peak_group_beams_semantics():
    """Beam-axis grouping: same-cell collapse to the strongest beam, ties
    toward the lower beam, NO wrap between the first and last beams."""
    import jax.numpy as jnp
    from fmcw_tpu.ops.cfar import peak_group_beams

    det = np.zeros((4, 3, 3), np.float32)
    det[0, 0, 0] = 5
    det[1, 0, 0] = 5        # tie -> beam 0 survives
    det[2, 1, 1] = 6
    det[3, 1, 1] = 7        # edge beam holds the max
    det[0, 2, 2] = 4        # isolated detection
    out = np.asarray(peak_group_beams(jnp.asarray(det), radius=1))
    assert out[0, 0, 0] == 5 and out[1, 0, 0] == 0
    assert out[3, 1, 1] == 7 and out[2, 1, 1] == 0
    assert out[0, 2, 2] == 4
    # Non-periodic: beams 0 and 3 are not neighbors even at radius 1.
    det2 = np.zeros((4, 1, 1), np.float32)
    det2[0, 0, 0] = 1
    det2[3, 0, 0] = 2
    out2 = np.asarray(peak_group_beams(jnp.asarray(det2), radius=1))
    assert out2[0, 0, 0] == 1 and out2[3, 0, 0] == 2


def test_array_grouping_fused_matches_xla():
    """peak_group_radius + beam_group_radius: the model's grouped det cube
    equals per-beam peak_group then peak_group_beams applied to the
    ungrouped model's det cube, grouping reduces the count, and surviving
    duplicates of a (range, doppler) cell are more than beam_group_radius
    apart."""
    import jax.numpy as jnp
    from fmcw_tpu.ops import cfar as C
    iq = _element_frames(0.25, seed=6)
    a = jax.tree.map(np.asarray, pl.make_array_processor(
        P, n_elems=N_ELEMS, n_beams=N_BEAMS, peak_group_radius=2,
        beam_group_radius=1)(iq))
    raw = jax.tree.map(np.asarray, pl.make_array_processor(
        P, n_elems=N_ELEMS, n_beams=N_BEAMS)(iq))
    want = jax.vmap(lambda d: C.peak_group(d, radius=2))(
        jnp.asarray(raw["det_cube"]))
    want = np.asarray(C.peak_group_beams(want, radius=1))
    assert np.array_equal(a["det_cube"], want)
    assert int(a["n_dets"]) < int(raw["n_dets"])      # grouping reduces
    da = set(zip(a["beam_bin"][a["valid"]].tolist(),
                 a["range_bin"][a["valid"]].tolist(),
                 a["doppler_bin"][a["valid"]].tolist()))
    assert da
    cells = {}
    for bb, rr, dd in da:
        cells.setdefault((rr, dd), []).append(bb)
    for beams in cells.values():
        beams = sorted(beams)
        assert all(b2 - b1 > 1 for b1, b2 in zip(beams, beams[1:]))


def test_peak_group_beams_fast_path_equals_general():
    """The contiguous-id fast path (zero-filled shifted views, r4) is
    bit-identical to the general beam_ids formulation on random sparse
    cubes — ties, edges, radii 1..3."""
    import jax.numpy as jnp
    from fmcw_tpu.ops.cfar import peak_group_beams

    rng = np.random.default_rng(23)
    for _ in range(4):
        B, R, D = 8, 16, 8
        det = np.where(rng.random((B, R, D)) < 0.1,
                       rng.integers(1, 5, (B, R, D)).astype(np.float32),
                       0.0)                      # dense ties (values 1..4)
        for radius in (1, 2, 3):
            fast = np.asarray(peak_group_beams(jnp.asarray(det),
                                               radius=radius))
            general = np.asarray(peak_group_beams(
                jnp.asarray(det), radius=radius,
                beam_ids=jnp.arange(B)))
            assert np.array_equal(fast, general), radius


def test_peak_group_beams_pallas_kernel_matches_xla():
    """peak_group_beams equals a plain numpy loop over its rule — keep a
    cell if it is >= every higher-beam neighbor and > every lower-beam
    neighbor within the radius, no wrap — on random sparse stacks with
    dense ties."""
    import jax.numpy as jnp
    from fmcw_tpu.ops.cfar import peak_group_beams

    rng = np.random.default_rng(41)
    for radius in (1, 2):
        B, R, D = 8, 64, 128
        det = np.where(rng.random((B, R, D)) < 0.05,
                       rng.integers(1, 6, (B, R, D)).astype(np.float32),
                       0.0)
        want = np.zeros_like(det)
        for b in range(B):
            keep = det[b] > 0
            for o in range(1, radius + 1):
                if b + o < B:
                    keep &= det[b] >= det[b + o]
                if b - o >= 0:
                    keep &= det[b] > det[b - o]
            want[b] = np.where(keep, det[b], 0)
        got = np.asarray(peak_group_beams(jnp.asarray(det), radius=radius))
        assert np.array_equal(got, want), radius
