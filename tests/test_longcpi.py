"""Long CPIs (n_doppler = 256 chirps, BASELINE config 2) on the compiled chain.

The dense slow-time operator (ops/fft.doppler_matrices) handles any chirp
count, so a long CPI needs no special layout: each case below is the same
chain at n_doppler = 256 against the golden models, single-device and
sharded.
"""

import dataclasses

import jax
import numpy as np
import pytest

from chip_smoke import gate_fixed, gate_float
from fmcw_tpu import CfarParams, RadarParams
from fmcw_tpu.golden import fixed_point as fx, reference as ref
from fmcw_tpu.models import pipeline as pl
from fmcw_tpu.ops import cfar as C
from fmcw_tpu.routes import resolve_routes

P = RadarParams(n_range=256, n_doppler=256)


def _cfg(**cfar_kw):
    return P.replace(cfar=dataclasses.replace(P.cfar, **cfar_kw))


@pytest.fixture(scope="module")
def frame():
    return ref.two_target_frame(P, seed=2)


@pytest.mark.parametrize("variant", ["os", "ca"])
@pytest.mark.parametrize("scale_mode", ["cell", "block"])
def test_longcpi_float_matches_golden(frame, scale_mode, variant):
    p = _cfg(scale_mode=scale_mode, variant=variant)
    out = jax.tree.map(np.asarray, pl.make_processor(p)(
        pl.complex_to_iq(frame)))
    want = ref.process_frame(frame, p)
    gate = gate_float(out["mag_map"], out["det_map"], want.mag_map,
                      want.det_map, want.threshold_map)
    assert gate["ok"], gate


@pytest.mark.parametrize("scale_mode", ["cell", "block"])
def test_longcpi_fixed_matches_golden(frame, scale_mode):
    p = _cfg(scale_mode=scale_mode)
    out = jax.tree.map(np.asarray, pl.make_processor(p, mode="fixed")(
        pl.complex_to_iq(frame)))
    mag, det = ref.process_frame_fixed(frame, p)
    gate = gate_fixed(out["mag_map"], out["det_map"], mag, det)
    # One BFP rounding difference at the range stage (f32 vs f64 DFT sums)
    # grows through the 256-chirp Doppler transform: a few tens of LSB.
    assert gate["ok"] and gate["max_mag_lsb"] <= 32, gate


@pytest.mark.parametrize("radius", [1, 2])
def test_longcpi_peak_group_matches_golden(frame, radius):
    out = jax.tree.map(np.asarray, pl.make_processor(
        P, mode="fixed", peak_group_radius=radius)(pl.complex_to_iq(frame)))
    _, det = ref.process_frame_fixed(frame, P)
    want = fx.peak_group(det, radius=radius)
    assert np.array_equal(out["det_map"] > 0, want > 0)


def test_longcpi_random_geometry_fuzz():
    """Random CFAR geometries (asymmetric windows, zero guards) on a
    256x256 integer map: the counting route equals the golden detector."""
    rng = np.random.default_rng(12)
    m = np.clip(rng.gamma(2.0, 900.0, (256, 256)), 0, 45055).astype(np.int32)
    m[::9, ::7] *= 9
    for _ in range(4):
        cf = CfarParams(ref_range=int(rng.integers(1, 5)),
                        ref_doppler=int(rng.integers(1, 5)),
                        guard_range=int(rng.integers(0, 3)),
                        guard_doppler=int(rng.integers(0, 3)),
                        rank_pct=int(rng.integers(50, 90)))
        det, scale = C.cfar_2d_count(m, 0, cfar=cf, integer=True)
        want, _, want_scale = fx.os_cfar_2d(m, cf, return_debug=True)
        assert np.array_equal(np.asarray(det), want), cf
        assert np.array_equal(np.asarray(scale), want_scale), cf


def test_longcpi_array_model_runs_and_groups():
    """Array model at a long CPI: the beams' cube equals the single-channel
    chain applied per beam, and cross-beam grouping keeps one beam per
    cell."""
    p = RadarParams(n_range=128, n_doppler=256,
                    cfar=CfarParams(ref_range=2, ref_doppler=2,
                                    guard_range=1, guard_doppler=1))
    from fmcw_tpu.ops import beamform as BF
    rng = np.random.default_rng(3)
    iq = rng.integers(-300, 300, (4, 256, 128, 2)).astype(np.int16)
    iq[..., 0] += (4000 * np.cos(2 * np.pi * (
        20 * np.arange(128)[None, :] / 128
        + 9 * np.arange(256)[:, None] / 256))).astype(np.int16)
    out = jax.tree.map(np.asarray, pl.make_array_processor(
        p, n_elems=4, n_beams=4, beam_group_radius=1)(iq))
    br, bi = BF.beamform(iq[..., 0].astype(np.float32),
                         iq[..., 1].astype(np.float32), 4)
    for b in range(4):
        mag = np.asarray(pl.float_beam_frontend(
            br[b], bi[b], False, p, resolve_routes(p),
            jax.lax.Precision.HIGHEST, "zero"))
        np.testing.assert_allclose(out["mag_cube"][b], mag,
                                   rtol=0, atol=1e-4 * mag.max())
    assert np.all((out["det_cube"] > 0).sum(axis=0) <= 2)


def test_longcpi_sharded_matches_single_device():
    from fmcw_tpu.parallel import mesh as M, sharded as sh
    p = RadarParams(n_range=128, n_doppler=256,
                    cfar=CfarParams(ref_range=2, ref_doppler=2,
                                    guard_range=1, guard_doppler=1))
    frames = np.stack([pl.complex_to_iq(ref.two_target_frame(p, seed=s))
                       for s in range(2)])
    mesh = M.make_mesh(dp=1, sp=2, devices=jax.devices()[:2])
    got = jax.tree.map(np.asarray, sh.make_sharded_processor(
        mesh, p, mode="fixed", include_maps=True)(frames))
    single = pl.make_processor(p, mode="fixed")
    for i in range(2):
        want = jax.tree.map(np.asarray, single(frames[i]))
        assert np.array_equal(got["det_map"][i], want["det_map"])
