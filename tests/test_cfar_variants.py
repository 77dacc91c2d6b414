"""CFAR variant sweep tests (BASELINE config 4): CA/OS/GO/SO on the JAX path
plus the angle-bin extension (3D CFAR)."""

import numpy as np
import jax

from fmcw_tpu import CfarParams
from fmcw_tpu.golden import fixed_point as fx
from fmcw_tpu.ops import cfar as C

CF = CfarParams(ref_range=2, ref_doppler=2, guard_range=1, guard_doppler=1)


def _map(seed=0, shape=(64, 32)):
    rng = np.random.default_rng(seed)
    m = rng.integers(80, 121, shape).astype(np.int32)
    m[20, 10] += 4000
    m[45, 25] += 3000
    return m


def test_variants_match_golden():
    m = _map()
    for variant in ("os", "ca", "go", "so"):
        cf = CfarParams(ref_range=2, ref_doppler=2, guard_range=1,
                        guard_doppler=1, variant=variant)
        det_j, thr_j, _ = C.cfar_2d(m, 0, cfar=cf, integer=True)
        det_g, thr_g, _ = fx.os_cfar_2d(m.astype(np.int64), cf,
                                        return_debug=True)
        # Threshold maps (not just detections) must agree bit-for-bit.
        assert np.array_equal(np.asarray(thr_j), thr_g), variant
        assert np.array_equal(np.asarray(det_j), det_g), variant


def test_variants_match_golden_full_geometry():
    rng = np.random.default_rng(9)
    m = rng.integers(50, 2000, (128, 128)).astype(np.int32)
    m[64, 64] = 40000
    for variant in ("os", "ca", "go", "so"):
        cf = CfarParams(variant=variant)  # default 13x11 window
        det_j, thr_j, _ = C.cfar_2d(m, 0, cfar=cf, integer=True)
        det_g, thr_g, _ = fx.os_cfar_2d(m.astype(np.int64), cf,
                                        return_debug=True)
        assert np.array_equal(np.asarray(thr_j), thr_g), variant


def test_cfar_3d_independent_angles():
    cube = np.stack([_map(s) for s in range(4)])
    det, thr, sc = C.cfar_3d(cube, 0, cfar=CF, integer=True,
                             ref_angle=0, method="topk")
    # Per-angle results equal the 2D op applied per plane.
    for a in range(4):
        d2, _, _ = C.cfar_2d(cube[a], 0, cfar=CF, integer=True)
        assert np.array_equal(np.asarray(det)[a], np.asarray(d2))


def test_cfar_3d_angle_training():
    cube = np.stack([_map(s) for s in range(5)])
    det, thr, sc = C.cfar_3d(cube, 0, cfar=CF, integer=True,
                             ref_angle=1, guard_angle=0)
    det = np.asarray(det)
    # Targets present in every plane are local peaks in 3D too.
    assert all(det[a, 20, 10] > 0 for a in range(5))
    # Enlarged training set: n_ref grows by the extra angle planes -> the
    # threshold map differs from the per-angle case somewhere.
    det0, thr0, _ = C.cfar_3d(cube, 0, cfar=CF, integer=True, ref_angle=0,
                              method="topk")
    assert not np.array_equal(np.asarray(thr), np.asarray(thr0))


def test_cfar_3d_scale_override():
    cube = np.stack([_map(s) for s in range(3)])
    _, _, sc = C.cfar_3d(cube, 7, cfar=CF, integer=True, ref_angle=1)
    assert np.all(np.asarray(sc) == 7)


# --- beamforming front-end for the angle dimension (ops/beamform.py) -------

def test_beamform_matches_explicit_loop():
    from fmcw_tpu.ops import beamform as BF
    rng = np.random.default_rng(0)
    E, B = 8, 16
    re = rng.standard_normal((E, 12, 20)).astype(np.float32)
    im = rng.standard_normal((E, 12, 20)).astype(np.float32)
    br, bi = BF.beamform(re, im, B)
    wr, wi = BF.steering_matrix(E, B)
    # golden: explicit per-beam complex dot over elements (float64)
    w = wr.astype(np.float64) + 1j * wi.astype(np.float64)
    x = re.astype(np.float64) + 1j * im.astype(np.float64)
    y = np.tensordot(w, x, axes=(1, 0))
    np.testing.assert_allclose(np.asarray(br), y.real, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(bi), y.imag, rtol=1e-5, atol=1e-4)


def test_beamform_point_target_angle():
    from fmcw_tpu.ops import beamform as BF
    E, B = 16, 32
    # Plane wave from steering sine u0: x_e = exp(+j*2*pi*0.5*e*u0) is
    # matched by the beam whose weight conjugates that phase.
    u_grid = np.linspace(-np.sin(np.deg2rad(60.0)),
                         np.sin(np.deg2rad(60.0)), B)
    b0 = 20
    u0 = u_grid[b0]
    e = np.arange(E)
    x = np.exp(1j * 2 * np.pi * 0.5 * e * u0)
    re = np.tile(x.real.astype(np.float32)[:, None, None], (1, 4, 4))
    im = np.tile(x.imag.astype(np.float32)[:, None, None], (1, 4, 4))
    cube = np.asarray(BF.beam_cube(re, im, B))
    assert cube.shape == (B, 4, 4)
    assert int(np.argmax(cube[:, 0, 0])) == b0
    # matched beam gains the full array factor (~E) over the average
    assert cube[b0, 0, 0] > 3.0 * float(np.median(cube[:, 0, 0]))


def test_beamform_feeds_cfar_3d():
    from fmcw_tpu.ops import beamform as BF
    rng = np.random.default_rng(5)
    E, B = 8, 8
    re = (rng.standard_normal((E, 32, 16)) * 10).astype(np.float32)
    im = (rng.standard_normal((E, 32, 16)) * 10).astype(np.float32)
    # inject a coherent target at beam index 5's steering phase, cell (10, 8)
    wr, wi = BF.steering_matrix(E, B)
    w = (wr + 1j * wi)[5].conj()
    re[:, 10, 8] += 500 * w.real.astype(np.float32)
    im[:, 10, 8] += 500 * w.imag.astype(np.float32)
    cube = BF.beam_cube(re, im, B)
    det, _, _ = C.cfar_3d(cube, 0, cfar=CF, integer=False, ref_angle=1,
                          method="topk")
    d = np.asarray(det)
    assert d[5, 10, 8] > 0
    assert (d > 0).sum() <= 8  # target (+ possible beam sidelobes) only


def _cfar_3d_numpy(cube, cf, ra, ga, so=0):
    """Plain numpy 3D OS-CFAR (integer): the box-minus-guard-box training
    set over angle x range x Doppler, padded per edge_mode on every axis."""
    ha, hr, hd = ra + ga, cf.halo_range, cf.halo_doppler
    A, R, D = cube.shape
    pad = np.pad(cube.astype(np.int64), ((ha, ha), (hr, hr), (hd, hd)),
                 mode=cf.edge_mode)
    offs = C._offsets_3d(cf, ra, ga)
    refs = np.stack([pad[ha + da:ha + da + A, hr + dr:hr + dr + R,
                         hd + dd:hd + dd + D] for da, dr, dd in offs])
    rank = min((len(offs) * cf.rank_pct) // 100, len(offs) - 1)
    est = np.partition(refs, rank, axis=0)[rank]
    mean = refs.sum(axis=0) // len(offs)
    scale = fx.cfar_scale(est, mean, cf, so)
    return np.where(cube > est * scale, cube, 0), scale


def test_cfar_3d_pallas_method_matches_xla():
    """The angle-extended decision (cfar_3d's stacked body) equals a plain
    numpy 3D OS-CFAR: det cube and scale bit-equal, wrap and reflect
    edges, with guard planes and a scale override, plus the
    prepadded-angle (sharded beam-halo) framing."""
    rng = np.random.default_rng(5)
    cases = [
        ((4, 16, 8), CfarParams(ref_range=1, ref_doppler=1, guard_range=1,
                                guard_doppler=1), 1, 0),
        ((6, 24, 16), CfarParams(ref_range=2, ref_doppler=2, guard_range=1,
                                 guard_doppler=1,
                                 edge_mode="reflect"), 2, 1),
    ]
    for (A, R, D), cf, ra, ga in cases:
        cube = rng.integers(0, 30000, size=(A, R, D)).astype(np.int32)
        for so in (0, 3):
            d1, _, s1 = C.cfar_3d(cube, so, cfar=cf, integer=True,
                                  ref_angle=ra, guard_angle=ga)
            d2, s2 = _cfar_3d_numpy(cube, cf, ra, ga, so)
            assert np.array_equal(np.asarray(d1), d2)
            assert np.array_equal(np.asarray(s1), s2)
        if cf.edge_mode == "wrap":
            ha = ra + ga
            pre = np.concatenate([cube[-ha:], cube, cube[:ha]], axis=0)
            d3, _, _ = C.cfar_3d(pre, 0, cfar=cf, integer=True,
                                 ref_angle=ra, guard_angle=ga,
                                 prepadded_angle=True)
            assert np.array_equal(np.asarray(d3),
                                  _cfar_3d_numpy(cube, cf, ra, ga)[0])


def test_cfar_3d_pallas_vmap_matches_percube():
    """The array model vmaps cfar_3d over the frame batch; the decision
    under vmap must equal per-cube calls."""
    rng = np.random.default_rng(9)
    cf = CfarParams(ref_range=1, ref_doppler=1, guard_range=1,
                    guard_doppler=1)
    cubes = rng.integers(0, 30000, size=(2, 4, 16, 8)).astype(np.int32)
    f = lambda c: C.cfar_3d(c, 0, cfar=cf, integer=True, ref_angle=1,
                            guard_angle=0, need_debug=False)[0]
    batched = jax.vmap(f)(cubes)
    for b in range(2):
        one = f(cubes[b])
        assert np.array_equal(np.asarray(batched[b]), np.asarray(one))


def test_cfar_3d_pallas_random_geometry_fuzz():
    """Randomized geometries for the angle-extended decision: cube/window
    shapes, guard planes, wrap/reflect edges drawn at random must match
    the numpy 3D OS-CFAR bit-for-bit."""
    rng = np.random.default_rng(17)
    for _ in range(5):
        cf = CfarParams(ref_range=int(rng.integers(1, 3)),
                        ref_doppler=int(rng.integers(1, 3)),
                        guard_range=int(rng.integers(0, 2)),
                        guard_doppler=int(rng.integers(0, 2)),
                        edge_mode=str(rng.choice(["wrap", "reflect"])))
        ra, ga = int(rng.integers(1, 3)), int(rng.integers(0, 2))
        A = int(rng.integers(2 * (ra + ga) + 1, 8))
        R = int(rng.integers(3, 7)) * 4
        D = int(rng.choice([8, 16]))
        cube = rng.integers(0, 30000, size=(A, R, D)).astype(np.int32)
        d1, _, s1 = C.cfar_3d(cube, 0, cfar=cf, integer=True, ref_angle=ra,
                              guard_angle=ga)
        d2, s2 = _cfar_3d_numpy(cube, cf, ra, ga)
        assert np.array_equal(np.asarray(d1), d2), (cf, ra, ga)
        assert np.array_equal(np.asarray(s1), s2), (cf, ra, ga)


def test_cfar_3d_pallas_contract_guards():
    """Narrow integer cubes upcast internally (est*scale would wrap in
    int16 at full scale): det returns int16, scale int32.  A route with no
    compiled 3D lowering raises instead of falling back."""
    import pytest
    rng = np.random.default_rng(23)
    cf = CfarParams(ref_range=1, ref_doppler=1, guard_range=1,
                    guard_doppler=1)
    cube16 = rng.integers(0, 30000, size=(4, 16, 8)).astype(np.int16)
    d1, _, s1 = C.cfar_3d(cube16, 0, cfar=cf, integer=True, ref_angle=1)
    assert np.asarray(d1).dtype == np.int16
    assert np.asarray(s1).dtype == np.int32
    d32, _, _ = C.cfar_3d(cube16.astype(np.int32), 0, cfar=cf, integer=True,
                          ref_angle=1)
    assert np.array_equal(np.asarray(d1), np.asarray(d32).astype(np.int16))
    for method in ("pallas", "count"):
        with pytest.raises(ValueError, match="no compiled route"):
            C.cfar_3d(cube16, 0, cfar=cf, integer=True, ref_angle=1,
                      method=method)
