"""The chain's configurations, each against the numpy golden models, plus
the route resolver (fmcw_tpu/routes.py).

Float cases go through chip_smoke.gate_float against
golden/reference.process_frame (float64): the magnitude map within 1e-4 of its
peak, detection positions equal except cells the golden chain itself puts
within that tolerance of their threshold; fixed
cases gate the detection set exactly against process_frame_fixed.  Peak
grouping is checked against golden/fixed_point.peak_group applied to the
golden detection map.
"""

import dataclasses

import jax
import numpy as np
import pytest

from chip_smoke import gate_float
from fmcw_tpu import RadarParams, quick
from fmcw_tpu.golden import fixed_point as fx, reference as ref
from fmcw_tpu.models import pipeline as pl
from fmcw_tpu.routes import resolve_routes

Q = quick()
LONG = RadarParams(n_range=128, n_doppler=64, cfar=Q.cfar)


def _positions(m):
    return set(map(tuple, np.argwhere(np.asarray(m) > 0)))


def _cfg(base, **cfar_kw):
    return base.replace(cfar=dataclasses.replace(base.cfar, **cfar_kw))


FLOAT_CASES = {
    "quick": (Q, {}, {}),
    "long_cpi_64": (LONG, {}, {}),
    "notch3": (Q.replace(notch_mode=3), {}, {}),
    "notch3_passthrough": (Q.replace(notch_mode=3),
                           {"mti_transient": "passthrough"},
                           {"mti_transient": "passthrough"}),
    "mti_transient_passthrough": (Q, {"mti_transient": "passthrough"},
                                  {"mti_transient": "passthrough"}),
    "exact_magnitude": (Q, {"magnitude_exact": True},
                        {"magnitude_mode": "exact"}),
    "block_scale": (_cfg(Q, scale_mode="block"), {}, {}),
    "block_scale_long_cpi": (_cfg(LONG, scale_mode="block"), {}, {}),
    "reflect_edges": (_cfg(Q, edge_mode="reflect"), {}, {}),
    "ca": (_cfg(Q, variant="ca"), {}, {}),
    "go": (_cfg(Q, variant="go"), {}, {}),
    "so": (_cfg(Q, variant="so"), {}, {}),
    "topk_route": (Q, {"cfar_method": "topk"}, {}),
}


@pytest.mark.parametrize("name", sorted(FLOAT_CASES))
@pytest.mark.parametrize("bypass", [False, True], ids=["mti", "bypass"])
def test_float_chain_matches_golden(name, bypass):
    p, kw, gkw = FLOAT_CASES[name]
    frame = ref.two_target_frame(p, seed=3)
    out = jax.tree.map(np.asarray, pl.make_processor(p, **kw)(
        pl.complex_to_iq(frame), mti_bypass=bypass))
    want = ref.process_frame(frame, p, mti_bypass=bypass, **gkw)
    gate = gate_float(out["mag_map"], out["det_map"], want.mag_map,
                      want.det_map, want.threshold_map)
    assert gate["ok"], gate
    assert gate["boundary_flips"] <= 1 and gate["dets"] > 0


FIXED_CASES = {
    "quick": (Q, {}),
    "long_cpi_64": (LONG, {}),
    "notch3": (Q.replace(notch_mode=3), {}),
    "biased_passthrough": (Q, {"window_rounding": "biased",
                               "mti_transient": "passthrough"}),
    "block_scale": (_cfg(Q, scale_mode="block"), {}),
    "reflect_edges": (_cfg(Q, edge_mode="reflect"), {}),
    "ca": (_cfg(Q, variant="ca"), {}),
}


@pytest.mark.parametrize("name", sorted(FIXED_CASES))
@pytest.mark.parametrize("so", [0, 3], ids=["auto", "so3"])
def test_fixed_chain_matches_golden(name, so):
    p, kw = FIXED_CASES[name]
    frame = ref.two_target_frame(p, seed=4)
    out = jax.tree.map(np.asarray, pl.make_processor(p, mode="fixed", **kw)(
        pl.complex_to_iq(frame), scale_override=so))
    mag, det = ref.process_frame_fixed(frame, p, scale_override=so, **kw)
    assert _positions(out["det_map"]) == _positions(det)
    assert np.abs(out["mag_map"].astype(np.int64) - mag).max() <= 8


@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("mode", ["float32", "fixed"])
def test_grouping_radii_match_golden(mode, radius):
    frame = ref.two_target_frame(Q, seed=6)
    out = jax.tree.map(np.asarray, pl.make_processor(
        Q, mode=mode, peak_group_radius=radius)(pl.complex_to_iq(frame)))
    if mode == "fixed":
        _, det = ref.process_frame_fixed(frame, Q)
    else:
        det = ref.process_frame(frame, Q).det_map
    want = fx.peak_group(det, radius=radius)
    assert _positions(out["det_map"]) == _positions(want)
    v = out["valid"]
    assert set(zip(out["range_bin"][v], out["doppler_bin"][v])) \
        <= _positions(want)


def test_resolver_default_routes():
    r = resolve_routes(RadarParams())
    assert r.as_dict() == {
        "range_fft": "matmul", "slow_time": "folded",
        "magnitude": "alpha_max_beta_min", "cfar": "count"}


@pytest.mark.parametrize("kw,field,want", [
    ({"mode": "fixed"}, "range_fft", "matmul"),
    ({"mode": "fixed", "fixed_fft": "scaled"}, "range_fft", "scaled"),
    ({"mode": "fixed", "fft_method": "ct"}, "range_fft", "ct"),
    ({"fft_method": "ct"}, "range_fft", "ct"),
    ({"fft_method": "xla"}, "range_fft", "xla"),
    ({"include_debug": True}, "cfar", "topk"),
    ({"cfar_geometry": "hw_stream"}, "cfar", "hw_stream"),
    ({"ref_angle": 1}, "cfar", "stack3d"),
    ({"ref_angle": 0}, "cfar", "count"),
    ({"sp": 4}, "cfar", "count"),
    ({"mode": "fixed"}, "slow_time", "notch_fft"),
    ({"magnitude_exact": True}, "magnitude", "exact"),
    ({"mode": "fixed"}, "magnitude", "fixed"),
    ({"mode": "fixed", "magnitude_exact": True}, "magnitude", "fixed"),
])
def test_resolver_routes(kw, field, want):
    assert getattr(resolve_routes(RadarParams(), **kw), field) == want


def test_resolver_ca_variant_takes_box_sums():
    p = _cfg(RadarParams(), variant="ca")
    assert resolve_routes(p).cfar == "topk"


@pytest.mark.parametrize("kw,match", [
    ({"cfar_method": "pallas"}, "no compiled route"),
    ({"fft_method": "pallas"}, "no compiled route"),
    ({"ref_angle": 1, "cfar_method": "pallas"}, "no compiled route"),
    ({"ref_angle": 1, "cfar_method": "count"}, "no compiled route"),
    ({"cfar_geometry": "hw_stream", "cfar_method": "pallas"}, "one route"),
    ({"mode": "bf16"}, "mode must be"),
    ({"fixed_fft": "scaled"}, "applies to mode='fixed'"),
    ({"cfar_geometry": "stream"}, "cfar_geometry must be"),
])
def test_resolver_rejects(kw, match):
    with pytest.raises(ValueError, match=match):
        resolve_routes(RadarParams(), **kw)


def test_processors_expose_their_routes():
    proc = pl.make_batch_processor(Q, mode="fixed", include_maps=False)
    assert proc.routes == resolve_routes(Q, mode="fixed")
    aproc = pl.make_array_processor(Q, n_elems=2, n_beams=2, ref_angle=1)
    assert aproc.routes.cfar == "stack3d"
    with pytest.raises(ValueError, match="no compiled route"):
        pl.make_array_processor(Q, cfar_method="pallas")
