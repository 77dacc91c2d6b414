"""The comparison helpers of chip_smoke.py, its refusal to run without a GPU,
the compile-cache helper, and the trace-to-stage reduction of
tools/profile.py — everything of the GPU checks that the CPU can reach."""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest

import chip_smoke as cs
from fmcw_tpu import TrackerParams
from fmcw_tpu.golden import tracker as gt
from fmcw_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _profile_module():
    spec = importlib.util.spec_from_file_location(
        "profile_tool", os.path.join(REPO, "tools", "profile.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _maps(seed=0):
    rng = np.random.default_rng(seed)
    mag = rng.random((16, 8)) * 100.0
    thr = np.full((16, 8), 60.0)
    det = np.where(mag > thr, mag, 0.0)
    return mag, det, thr


def test_gate_float_passes_identical_maps():
    mag, det, thr = _maps()
    g = cs.gate_float(mag, det, mag, det, thr)
    assert g["ok"] and g["boundary_flips"] == 0
    assert g["dets"] == int((det > 0).sum())


@pytest.mark.parametrize("rel_err,ok", [(5e-5, True), (2e-4, False)])
def test_gate_float_magnitude_tolerance_is_peak_relative(rel_err, ok):
    mag, det, thr = _maps(1)
    got = mag + rel_err * mag.max()
    g = cs.gate_float(got, det, mag, det, thr)
    assert g["ok"] is ok


def test_gate_float_accepts_only_boundary_flips():
    mag, det, thr = _maps(2)
    # A cell exactly at its threshold flips: accepted, counted.
    mag[3, 3] = 60.0
    det[3, 3] = 0.0
    got_det = det.copy()
    got_det[3, 3] = 60.0
    g = cs.gate_float(mag, got_det, mag, det, thr)
    assert g["ok"] and g["boundary_flips"] == 1 and g["extra"] == 0
    # A clear detection missing: refused, whatever the threshold.
    r, d = np.argwhere(det > 80)[0]
    bad = det.copy()
    bad[r, d] = 0.0
    g = cs.gate_float(mag, bad, mag, det, thr)
    assert not g["ok"] and g["missing"] == 1
    # Without thresholds every position difference fails.
    assert not cs.gate_float(mag, got_det, mag, det)["ok"]


def test_gate_fixed_is_exact_and_reports_lsb():
    rng = np.random.default_rng(3)
    mag = rng.integers(0, 1000, (16, 8))
    det = np.where(mag > 900, mag, 0)
    g = cs.gate_fixed(mag + 2, det, mag, det)
    assert g["ok"] and g["max_mag_lsb"] == 2
    det2 = det.copy()
    det2[0, 0] = 5
    assert not cs.gate_fixed(mag, det2, mag, det)["ok"]


def test_det_positions_on_cubes():
    cube = np.zeros((2, 3, 4))
    cube[1, 2, 3] = 1.0
    assert cs.det_positions(cube) == {(1, 2, 3)}


class _Res:
    def __init__(self, rep, active):
        self.report = rep
        self.active_tracks = active


def test_tracker_reports_match_golden_replay():
    tp = TrackerParams(max_tracks=8, max_dets=8)
    outs, results = [], []
    state = gt.init_state(tp)
    for s in range(4):
        r = np.array([100 + s, 300, 0, 0, 0, 0, 0, 0])
        d = np.array([40, 80, 0, 0, 0, 0, 0, 0])
        m = np.array([900, 800, 0, 0, 0, 0, 0, 0])
        v = np.array([True, True] + [False] * 6)
        outs.append({"range_bin": r, "doppler_bin": d, "mag": m, "valid": v})
        state, rep = gt.step(state, r[v], d[v], m[v], tp)
        mask = np.zeros(tp.max_tracks, bool)
        mask[rep["id"]] = True
        pos = np.zeros(tp.max_tracks, np.int64)
        pos[rep["id"]] = rep["range_pos"]
        results.append(_Res({"report_mask": mask, "range_pos": pos},
                            rep["active_tracks"]))
    assert cs.tracker_reports_match(outs, results, tp)["ok"]
    results[2].active_tracks += 1
    got = cs.tracker_reports_match(outs, results, tp)
    assert not got["ok"] and got["scans_differing"] == 1


def test_main_refuses_without_gpu(capsys):
    assert jax.default_backend() == "cpu"
    rc = cs.main([])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out == ""                       # no result line
    assert "no GPU" in out.err


def test_bench_refuses_without_gpu(capsys):
    import bench
    assert bench.main() != 0
    assert capsys.readouterr().out == ""


def test_compile_cache_dir_env_and_default(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == os.path.join(REPO, ".jax_cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_compile_cache_setup_points_jax_there(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert compile_cache.setup() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_profile_stage_map_reads_scopes():
    prof = _profile_module()
    hlo = "\n".join([
        '  %fusion.3 = f32[8]{0} fusion(%p), kind=kLoop, calls=%f, '
        'metadata={op_name="jit(_process)/vmap(cfar)/cfar/add"}',
        '  ROOT %custom-call.1 = f32[8]{0} custom-call(%a), '
        'metadata={op_name="jit(_process)/range_fft/dot_general"}',
        '  %copy.2 = f32[8]{0} copy(%b), metadata={op_name="jit(x)/copy"}',
    ])
    m = prof.stage_map(hlo)
    assert m["fusion.3"] == m["fusion_3"] == "cfar"
    assert m["custom-call.1"] == "range_fft"
    assert m["copy.2"] == "other"


def test_profile_reduce_trace_on_a_cpu_trace(tmp_path):
    """The reduction runs on a real (CPU) trace file: no device planes, so
    nothing is attributed and the busy share is undefined."""
    prof = _profile_module()
    f = jax.jit(lambda x: x * 2.0)
    f(np.ones(4, np.float32)).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        f(np.ones(4, np.float32)).block_until_ready()
    import glob
    path = glob.glob(str(tmp_path / "**" / "*.xplane.pb"), recursive=True)[0]
    red = prof.reduce_trace(path, {})
    assert red["events"] == 0 and red["busy_share"] is None
    json.dumps(red)
