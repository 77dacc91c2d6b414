"""Counting OS-CFAR (ops/cfar.cfar_2d_count) vs the ranked-stack formulation
(ops/cfar.cfar_2d) and the golden model (golden/fixed_point.os_cfar_2d).

The counting decision must be bit-exact in integer mode and decision-identical
in float mode: ``CUT > est*scale`` is decided as ``count(refs >= q) < k``
without ranking, and the adaptive-scale classes as counts against the mean's
1.5x / 0.5x thresholds.
"""

import dataclasses

import numpy as np
import pytest

from fmcw_tpu import CfarParams
from fmcw_tpu.golden import fixed_point as fx
from fmcw_tpu.ops import cfar as C

FULL = CfarParams()
QUICK = CfarParams(ref_range=2, ref_doppler=2, guard_range=1, guard_doppler=1)


def _int_map(shape=(256, 128), seed=0):
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 45056, shape).astype(np.int32)
    m[shape[0] // 5, shape[1] // 4] = 45000
    m[shape[0] * 3 // 4, shape[1] * 3 // 4] = 44000
    return m


def _clutter_map(shape, seed):
    """Gamma clutter with planted targets: enough detections in every
    scale class to make a decision mismatch visible."""
    rng = np.random.default_rng(seed)
    m = rng.gamma(2.0, 800.0, shape)
    m[::7, ::5] *= 12.0
    m[shape[0] // 2:, : shape[1] // 4] *= 4.0          # a clutter patch
    return np.clip(m, 0, 45055).astype(np.int32)


@pytest.mark.parametrize("cfar", [FULL, QUICK], ids=["full", "quick"])
def test_integer_bit_exact(cfar):
    m = _int_map()
    d1, _, s1 = C.cfar_2d(m, 0, cfar=cfar, integer=True)
    d2, s2 = C.cfar_2d_count(m, 0, cfar=cfar, integer=True)
    assert np.array_equal(np.asarray(d1), np.asarray(d2))
    assert np.array_equal(np.asarray(s1), np.asarray(s2))


def test_float_decision_identical():
    rng = np.random.default_rng(3)
    m = (rng.random((256, 128)) * 1e8).astype(np.float32)
    m[40, 40] = 9e8
    d1, _, _ = C.cfar_2d(m, 0, cfar=FULL, integer=False)
    d2, _ = C.cfar_2d_count(m, 0, cfar=FULL, integer=False)
    assert np.array_equal(np.asarray(d1) > 0, np.asarray(d2) > 0)


def test_scale_override_and_prepadded():
    m = _int_map((128, 64), seed=5)
    _, s = C.cfar_2d_count(m, 6, cfar=QUICK, integer=True)
    assert np.all(np.asarray(s) == 6)
    # prepadded_range: manual wrap pad == internal pad.
    hr = QUICK.halo_range
    mp = np.pad(m, ((hr, hr), (0, 0)), mode="wrap")
    d1, _ = C.cfar_2d_count(m, 0, cfar=QUICK, integer=True)
    d2, _ = C.cfar_2d_count(mp, 0, cfar=QUICK, integer=True,
                            prepadded_range=True)
    assert np.array_equal(np.asarray(d1), np.asarray(d2))


def test_rejects_non_os_variant():
    with pytest.raises(ValueError, match="os variant"):
        C.cfar_2d_count(_int_map(), 0, cfar=CfarParams(variant="ca"),
                        integer=True)


@pytest.mark.parametrize("cfar", [FULL, QUICK], ids=["full", "quick"])
@pytest.mark.parametrize("so", [0, 6], ids=["auto", "override"])
def test_count_integer_bit_exact_ties(cfar, so):
    m = _int_map(seed=11)
    # Low-entropy values force heavy ties — the regime where a non-exact
    # counting equivalence would diverge from the explicit order statistic.
    m[:64] = (m[:64] // 8192) * 8192
    d1, _, s1 = C.cfar_2d(m, so, cfar=cfar, integer=True)
    d2, s2 = C.cfar_2d_count(m, so, cfar=cfar, integer=True)
    assert np.array_equal(np.asarray(d1), np.asarray(d2))
    assert np.array_equal(np.asarray(s1), np.asarray(s2))


def test_count_float_bit_exact():
    rng = np.random.default_rng(7)
    m = (rng.random((256, 128)) * 1e8).astype(np.float32)
    m[40, 40] = 9e8
    m[200:208] = np.float32(3e7)  # tie block
    d1, _, s1 = C.cfar_2d(m, 0, cfar=FULL, integer=False)
    d2, s2 = C.cfar_2d_count(m, 0, cfar=FULL, integer=False)
    assert np.array_equal(np.asarray(d1), np.asarray(d2))
    assert np.array_equal(np.asarray(s1), np.asarray(s2))


def test_count_float_qmin_fuzz():
    # The lemma behind _count_threshold's float path: the smallest q with
    # RN(q*s) >= cut is within 2 ulps below RN(cut/s).  Brute-force the
    # per-ref-multiply ground truth on engineered boundary values.
    rng = np.random.default_rng(0)
    n = 200_000
    for scale in (2.0, 4.0, 6.0):
        s = np.float32(scale)
        cut = (rng.random(n, dtype=np.float32) * np.float32(1e6)
               + np.float32(1.0))
        ti = (cut / s).astype(np.float32).view(np.int32)
        v = (ti + rng.integers(-3, 4, n).astype(np.int32)).view(np.float32)
        q = np.asarray(C._count_threshold(cut, s, integer=False))
        assert np.array_equal((v * s) >= cut, v >= q), f"scale={scale}"


def test_count_float_boundary_map():
    # Cells sitting exactly on CUT/scale rounding boundaries of their
    # neighbors: values are bit-neighbors of each other scaled by 4/6.
    rng = np.random.default_rng(23)
    base = np.float32(3e7)
    steps = rng.integers(-2, 3, (256, 128)).astype(np.int32)
    m = (base.view(np.int32) + steps).view(np.float32).astype(np.float32)
    m[10, 10] = np.float32(4.0) * base  # exact 4x of a training neighbor
    m[60, 60] = np.float32(6.0) * base
    d1, _, s1 = C.cfar_2d(m, 0, cfar=FULL, integer=False)
    d2, s2 = C.cfar_2d_count(m, 0, cfar=FULL, integer=False)
    assert np.array_equal(np.asarray(d1), np.asarray(d2))
    assert np.array_equal(np.asarray(s1), np.asarray(s2))


def test_count_integer_wide_values_exact():
    # The integer ceiling (cut + s - 1) // s stays exact far beyond 2^24
    # (where an f32 quotient would not): cut=16777224/scale=6/ref=2796204
    # is the constructible f32 counterexample.
    rng = np.random.default_rng(31)
    m = rng.integers(0, 1 << 27, (128, 128)).astype(np.int32)
    m[10, 10] = 16777224
    m[64:70, 64:70] = 2796204 * 6 + 1
    d1, _, s1 = C.cfar_2d(m, 0, cfar=QUICK, integer=True)
    d2, s2 = C.cfar_2d_count(m, 0, cfar=QUICK, integer=True)
    assert np.array_equal(np.asarray(d1), np.asarray(d2))
    assert np.array_equal(np.asarray(s1), np.asarray(s2))


def test_count_prepadded_reflect_matches():
    cf = dataclasses.replace(QUICK, edge_mode="reflect")
    m = _int_map((128, 64), seed=13)
    hr = cf.halo_range
    mp = np.pad(m, ((hr, hr), (0, 0)), mode="reflect")
    d1, _ = C.cfar_2d_count(m, 0, cfar=cf, integer=True)
    d2, _ = C.cfar_2d_count(mp, 0, cfar=cf, integer=True,
                            prepadded_range=True)
    assert np.array_equal(np.asarray(d1), np.asarray(d2))


def test_auto_dispatch_detect_only():
    # need_debug=False on the OS variant => the counting route, threshold
    # None, det/scale exact against the ranked route.
    m = _int_map((128, 64), seed=17)
    d1, t1, s1 = C.cfar_2d_auto(m, 0, cfar=QUICK, integer=True,
                                method="topk")
    d2, t2, s2 = C.cfar_2d_auto(m, 0, cfar=QUICK, integer=True,
                                need_debug=False)
    assert t2 is None and t1 is not None
    assert np.array_equal(np.asarray(d1), np.asarray(d2))
    assert np.array_equal(np.asarray(s1), np.asarray(s2))


@pytest.mark.parametrize("shape", [(64, 32), (96, 48)], ids=str)
@pytest.mark.parametrize("so", [0, 3], ids=["auto", "so3"])
@pytest.mark.parametrize("scale_mode", ["cell", "block"])
@pytest.mark.parametrize("edge_mode", ["wrap", "reflect"])
def test_count_integer_matches_golden(edge_mode, scale_mode, so, shape):
    """Integer counting route == golden os_cfar_2d (det map and scale tap)
    over edge mode, scale mode, scale_override and shape."""
    cf = dataclasses.replace(QUICK, edge_mode=edge_mode,
                             scale_mode=scale_mode)
    m = _clutter_map(shape, seed=10 * len(edge_mode) + len(scale_mode) + so)
    want, _, want_scale = fx.os_cfar_2d(m, cf, so, return_debug=True)
    det, scale = C.cfar_2d_count(m, so, cfar=cf, integer=True)
    assert np.array_equal(np.asarray(det), want)
    assert np.array_equal(np.asarray(scale), want_scale)
    assert np.count_nonzero(want) > 0


@pytest.mark.parametrize("shape", [(64, 32), (96, 48)], ids=str)
@pytest.mark.parametrize("so", [0, 5], ids=["auto", "so5"])
@pytest.mark.parametrize("scale_mode", ["cell", "block"])
@pytest.mark.parametrize("edge_mode", ["wrap", "reflect"])
def test_count_float_matches_ranked_route(edge_mode, scale_mode, so, shape):
    """Float counting route == cfar_2d's ranked stack, decision for
    decision, over the same grid."""
    cf = dataclasses.replace(QUICK, edge_mode=edge_mode,
                             scale_mode=scale_mode)
    m = _clutter_map(shape, seed=7).astype(np.float32) * np.float32(1.37)
    d1, _, s1 = C.cfar_2d(m, so, cfar=cf, integer=False)
    d2, s2 = C.cfar_2d_count(m, so, cfar=cf, integer=False)
    assert np.array_equal(np.asarray(d1), np.asarray(d2))
    assert np.array_equal(np.asarray(s1), np.asarray(s2))


@pytest.mark.parametrize("method,variant,debug,want", [
    ("auto", "os", False, "count"),
    ("auto", "os", True, "topk"),
    ("auto", "ca", False, "topk"),
    ("topk", "os", False, "topk"),
    ("count", "os", False, "count"),
])
def test_cfar_route_resolution(method, variant, debug, want):
    cf = dataclasses.replace(QUICK, variant=variant)
    assert C.cfar_route(cf, method, need_debug=debug) == want


@pytest.mark.parametrize("method,variant,debug,match", [
    ("pallas", "os", False, "no compiled route"),
    ("xla", "os", False, "no compiled route"),
    ("count", "ca", False, "os variant"),
    ("count", "os", True, "threshold tap"),
])
def test_cfar_route_rejects(method, variant, debug, match):
    cf = dataclasses.replace(QUICK, variant=variant)
    with pytest.raises(ValueError, match=match):
        C.cfar_route(cf, method, need_debug=debug)


@pytest.mark.parametrize("shape", [(64, 32), (40, 24)], ids=str)
@pytest.mark.parametrize("integer", [True, False], ids=["int", "float"])
@pytest.mark.parametrize("scale_mode", ["cell", "block"])
@pytest.mark.parametrize("edge_mode", ["wrap", "reflect"])
def test_count_kernel_matches_jnp(edge_mode, scale_mode, integer, shape):
    """The Pallas counting kernel (interpret mode here) gives the jnp
    counting route's det map and scale exactly, including tiles the map
    does not fill (40x24: masked rows and columns)."""
    if scale_mode == "block" and shape[1] % 8:
        shape = (40, 32)
    cf = dataclasses.replace(QUICK, edge_mode=edge_mode,
                             scale_mode=scale_mode)
    m = _clutter_map(shape, seed=3)
    m = m if integer else m.astype(np.float32) * np.float32(1.37)
    for so in (0, 3):
        a = C.cfar_2d_count(m, so, cfar=cf, integer=integer, impl="jnp")
        b = C.cfar_2d_count(m, so, cfar=cf, integer=integer, impl="kernel",
                            interpret=True)
        assert np.array_equal(np.asarray(a[0]), np.asarray(b[0]))
        assert np.array_equal(np.asarray(a[1]), np.asarray(b[1]))
        assert np.count_nonzero(np.asarray(a[0])) > 0


def test_count_window_counts_by_definition():
    """count_window against a direct numpy count over the offsets, for a
    strict and a non-strict threshold."""
    from fmcw_tpu.ops.cfar_count_gpu import count_window
    rng = np.random.default_rng(8)
    hr, hd = 2, 1
    offsets = ((-2, -1), (0, 1), (1, 0), (2, 1), (-1, 0))
    padded = rng.integers(0, 10, (16 + 2 * hr, 8 + 2 * hd)).astype(np.int32)
    t = rng.integers(0, 10, (16, 8)).astype(np.int32)
    got = count_window(padded, (t, t), offsets, (True, False), hr, hd,
                       interpret=True)
    for strict, c in zip((True, False), got):
        want = sum(((padded[hr + dr:hr + dr + 16, hd + dd:hd + dd + 8] > t)
                    if strict else
                    (padded[hr + dr:hr + dr + 16, hd + dd:hd + dd + 8] >= t))
                   .astype(np.int32) for dr, dd in offsets)
        assert np.array_equal(np.asarray(c), want)


def test_count_impl_rejects_unknown():
    with pytest.raises(ValueError, match="impl must be"):
        C.cfar_2d_count(_int_map((64, 32)), 0, cfar=QUICK, integer=True,
                        impl="pallas")
