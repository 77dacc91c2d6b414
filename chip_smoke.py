"""Smoke test of the radar chain on NVIDIA GPUs, at full width.

    python chip_smoke.py             # one card: phases cfar, a-f
    python chip_smoke.py --cards 4   # four cards: sp=4 and dp=4 vs one card

Every phase drives the chain through its normal entry points
(make_processor, make_batch_processor, make_array_processor,
make_sharded_processor, runtime/surveillance.run_surveillance) at the
1024x128 production width (1024x256 for the long CPI), compares the result
with the numpy golden model, the single-card result or the plain CFAR
formulation, and prints its tolerance and matmul precision.  Any failure
exits non-zero with no result line.  The last line of standard output is
one JSON object naming the device as JAX reports it.

The script refuses to run without a GPU: it is the quickest proof that the
system still starts on the card, not a CPU test.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

# Float gate: magnitudes may differ from the float64 golden chain by this
# fraction of the map peak.  The f32 DFT error is absolute at the scale of
# the whole transform's energy, so it scales with the peak, not with each
# cell's own magnitude.
FLOAT_MAG_PEAK_RTOL = 1e-4
# Matmul precision of every phase (the processors' default).
PRECISION = "HIGHEST"


def det_positions(det_map) -> set:
    """{(index...)} of the nonzero cells of a detection map or cube."""
    return set(map(tuple, np.argwhere(np.asarray(det_map) > 0)))


def gate_float(mag, det, ref_mag, ref_det, ref_threshold=None,
               rtol: float = FLOAT_MAG_PEAK_RTOL) -> dict:
    """Float gate: magnitudes within ``rtol`` of the reference map's peak and
    detection positions equal.  With ``ref_threshold``, a position on which
    the two disagree is accepted only when the reference cell lies within
    the same ``rtol`` of its own threshold — a decision the magnitude
    tolerance cannot settle; such cells are counted as ``boundary_flips``."""
    mag = np.asarray(mag, np.float64)
    ref_mag = np.asarray(ref_mag, np.float64)
    got, want = det_positions(det), det_positions(ref_det)
    peak = max(float(np.max(np.abs(ref_mag))), 1e-30)
    err = float(np.max(np.abs(mag - ref_mag))) / peak
    flips = set()
    if ref_threshold is not None:
        margin = np.abs(ref_mag - np.asarray(ref_threshold, np.float64))
        flips = {c for c in got ^ want if margin[c] <= rtol * peak}
    return {"ok": err <= rtol and (got ^ want) == flips, "dets": len(want),
            "missing": len((want - got) - flips),
            "extra": len((got - want) - flips), "boundary_flips": len(flips),
            "max_err_of_peak": err, "tol_of_peak": rtol}


def gate_fixed(mag, det, ref_mag, ref_det) -> dict:
    """Fixed gate: the detection set exactly equal; the largest magnitude
    difference in LSB is reported, not gated."""
    got, want = det_positions(det), det_positions(ref_det)
    lsb = int(np.max(np.abs(np.asarray(mag, np.int64)
                            - np.asarray(ref_mag, np.int64))))
    return {"ok": got == want, "dets": len(want),
            "missing": len(want - got), "extra": len(got - want),
            "max_mag_lsb": lsb}


def tracker_reports_match(outputs, results, tp) -> dict:
    """Replay the golden tracker on the detections the processor produced
    (valid entries in output order) and compare every scan's report with
    the runtime's."""
    from fmcw_tpu.golden import tracker as gt
    state = gt.init_state(tp)
    scans = bad = 0
    for out, res in zip(outputs, results):
        v = np.asarray(out["valid"])
        state, rep = gt.step(state, np.asarray(out["range_bin"])[v],
                             np.asarray(out["doppler_bin"])[v],
                             np.asarray(out["mag"])[v].astype(np.int64), tp)
        ids = np.nonzero(np.asarray(res.report["report_mask"]))[0]
        same = (np.array_equal(ids, rep["id"])
                and res.active_tracks == rep["active_tracks"]
                and np.array_equal(
                    np.asarray(res.report["range_pos"])[ids],
                    rep["range_pos"]))
        scans += 1
        bad += not same
    return {"ok": scans > 0 and bad == 0, "scans": scans,
            "scans_differing": bad}


def _info(*a):
    print(*a, flush=True)


def _iq(frame):
    from fmcw_tpu.models import pipeline as pl
    return pl.complex_to_iq(frame)


def phase_cfar(p):
    """The counting CFAR kernel (Pallas, Triton route) and its plain jnp
    counting twin vs the ranked-stack formulation (cfar_2d) on the card, at
    the map's real width: integer bit-exact, float decision-equal."""
    import jax.numpy as jnp
    from fmcw_tpu.ops import cfar as C
    rng = np.random.default_rng(0)
    shape = (p.n_range, p.n_doppler)
    clutter = rng.gamma(2.0, 800.0, shape)
    clutter[::7, ::5] *= 12.0                       # planted targets
    clutter[: shape[0] // 4] *= 4.0                 # a clutter band
    res = {"ok": True}
    for scale_mode in ("cell", "block"):
        cf = dataclasses.replace(p.cfar, scale_mode=scale_mode)
        for integer in (True, False):
            m = (np.clip(clutter, 0, 45055).astype(np.int32) if integer
                 else clutter.astype(np.float32))
            m = jnp.asarray(m)
            d0, _, s0 = C.cfar_2d(m, 0, cfar=cf, integer=integer)
            dets = int(np.sum(np.asarray(d0) > 0))
            for impl in ("kernel", "jnp"):
                d, s = C.cfar_2d_count(m, 0, cfar=cf, integer=integer,
                                       impl=impl)
                ok = (np.array_equal(np.asarray(d0), np.asarray(d))
                      and np.array_equal(np.asarray(s0), np.asarray(s)))
                key = f"{scale_mode}_{'int' if integer else 'float'}_{impl}"
                res[key] = f"{dets} dets equal={ok}"
                res["ok"] &= ok and dets > 0
    return res


def phase_float(p, tag):
    """make_processor float32 (per-cell or as ``p`` says) vs the float64
    golden chain."""
    from fmcw_tpu.golden import reference
    from fmcw_tpu.models import pipeline as pl
    frame = reference.two_target_frame(p)
    proc = pl.make_processor(p)
    _info(f"  [{tag}] routes {proc.routes.as_dict()}")
    out = proc(_iq(frame))
    ref = reference.process_frame(frame, p)
    return gate_float(out["mag_map"], out["det_map"], ref.mag_map,
                      ref.det_map, ref.threshold_map)


def phase_fixed(p):
    """mode='fixed' vs the bit-faithful golden chain: detection set exact."""
    from fmcw_tpu.golden import reference
    from fmcw_tpu.models import pipeline as pl
    frame = reference.two_target_frame(p)
    proc = pl.make_processor(p, mode="fixed")
    _info(f"  [b] routes {proc.routes.as_dict()}")
    out = proc(_iq(frame))
    mag, det = reference.process_frame_fixed(frame, p)
    return gate_fixed(out["mag_map"], out["det_map"], mag, det)


def phase_batch(p, batch=128, reps=10):
    """make_batch_processor at ``batch`` frames of distinct noise; frame 0
    gated against the golden chain, frames/s printed for information."""
    import jax
    from fmcw_tpu.golden import reference
    from fmcw_tpu.models import pipeline as pl
    rng = np.random.default_rng(1)
    frame = reference.two_target_frame(p)
    noise = (rng.integers(-8, 8, (batch, p.n_doppler, p.n_range))
             + 1j * rng.integers(-8, 8, (batch, p.n_doppler, p.n_range)))
    frames = frame[None] + noise
    iq = jax.device_put(_iq(frames))
    proc = pl.make_batch_processor(p)
    _info(f"  [c] routes {proc.routes.as_dict()}")
    out = jax.block_until_ready(proc(iq))
    ref = reference.process_frame(frames[0], p)
    res = gate_float(np.asarray(out["mag_map"][0]),
                     np.asarray(out["det_map"][0]), ref.mag_map, ref.det_map,
                     ref.threshold_map)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(proc(iq))
        times.append(time.perf_counter() - t0)
    res["median_frames_per_s"] = batch / float(np.median(times))
    res["timed_batches"] = reps
    return res


def phase_array(p, n_elems=8, n_beams=8, ref_angle=1):
    """Array model on the card vs the same processor on this process's CPU
    device: detection positions equal, cube magnitudes within the float
    gate."""
    import jax
    from fmcw_tpu.models import pipeline as pl, scenario as sc
    cube, _ = sc.TacticalScenario(p).element_frames(1, n_elems)
    iq = _iq(cube)
    proc = pl.make_array_processor(p, n_elems=n_elems, n_beams=n_beams,
                                   ref_angle=ref_angle)
    _info(f"  [e] routes {proc.routes.as_dict()}")
    out = jax.tree.map(np.asarray, proc(iq))
    with jax.default_device(jax.devices("cpu")[0]):
        ref = jax.tree.map(np.asarray, proc(iq))
    return gate_float(out["mag_cube"], out["det_cube"], ref["mag_cube"],
                      ref["det_cube"])


def phase_surveillance(p, scans=6, batch_scans=3):
    """run_surveillance over the tactical scenario with tracker and logs;
    the tracker's reports must equal the golden tracker's on the same
    detections."""
    import jax
    from fmcw_tpu.models import pipeline as pl, scenario as sc
    from fmcw_tpu.runtime import surveillance as sv
    from fmcw_tpu.utils import viz
    scen = sc.TacticalScenario(p)
    frames = [_iq(scen.frame(s)[0]) for s in range(1, scans + 1)]
    proc = pl.make_batch_processor(p, include_maps=False,
                                   peak_group_radius=2)
    _info(f"  [f] routes {proc.routes.as_dict()}")
    outputs = []

    def capture(batch, **kw):
        out = jax.tree.map(np.asarray, proc(batch, **kw))
        outputs.extend({k: v[i] for k, v in out.items()}
                       for i in range(len(batch)))
        return out

    with tempfile.TemporaryDirectory() as d:
        det_log = os.path.join(d, "det.txt")
        trk_log = os.path.join(d, "trk.txt")
        results = list(sv.run_surveillance(capture, frames, p,
                                           batch_scans=batch_scans,
                                           det_log=det_log, trk_log=trk_log))
        _, counts = viz.load_tracks(trk_log)
    res = tracker_reports_match(outputs, results, p.tracker)
    res["ok"] &= len(counts) == scans
    res["active_tracks_last"] = results[-1].active_tracks
    return res


def phase_cards(p, n_cards=4):
    """The sharded processor on meshes (dp=1, sp=n) and (dp=n, sp=1) against
    the single-card processor, frame by frame: fixed mode exactly equal,
    float mode through the float gate."""
    import jax
    from fmcw_tpu.golden import reference
    from fmcw_tpu.models import pipeline as pl
    from fmcw_tpu.parallel import mesh as M, sharded as sh
    devices = jax.devices()[:n_cards]
    frames = np.stack([_iq(reference.two_target_frame(p, seed=s))
                       for s in range(n_cards)])
    res = {"ok": True}
    for mode in ("fixed", "float32"):
        single = pl.make_processor(p, mode=mode)
        want = [jax.tree.map(np.asarray, single(f)) for f in frames]
        for dp, sp in ((1, n_cards), (n_cards, 1)):
            mesh = M.make_mesh(dp=dp, sp=sp, devices=devices)
            proc = sh.make_sharded_processor(mesh, p, mode=mode,
                                             include_maps=True)
            _info(f"  [cards {mode} dp={dp} sp={sp}] routes "
                  f"{proc.routes.as_dict()}")
            got = jax.tree.map(np.asarray, proc(frames))
            gate = gate_fixed if mode == "fixed" else gate_float
            gates = [gate(got["mag_map"][i], got["det_map"][i],
                          w["mag_map"], w["det_map"])
                     for i, w in enumerate(want)]
            ok = all(g["ok"] for g in gates)
            res[f"{mode}_dp{dp}_sp{sp}"] = gates[0] | {"all_frames_ok": ok}
            res["ok"] &= ok
    return res


def card_info() -> str:
    """``name, power.limit`` of every card, as nvidia-smi reports them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded comparison on 4 cards")
    args = ap.parse_args(argv)

    import jax
    import jaxlib
    import fmcw_tpu
    from fmcw_tpu.runtime import native
    from fmcw_tpu.utils import compile_cache

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 2
    if len(jax.devices()) < args.cards:
        print(f"chip_smoke: --cards {args.cards} needs {args.cards} GPUs, "
              f"JAX sees {len(jax.devices())}", file=sys.stderr)
        return 2
    _info(f"card: {card_info()}")
    _info(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    _info(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    _info(f"compile cache: {compile_cache.setup()}")
    _info(f"native fmcwio loaded: {native.available()}")
    _info("cfar route 'count': Pallas counting kernel (Triton) where the "
          "program runs on the GPU, jnp compares on the CPU")
    _info(f"matmul precision: {PRECISION}; float gate: positions equal, "
          f"|mag - ref| <= {FLOAT_MAG_PEAK_RTOL:g} x map peak; "
          f"fixed gate: detection set exactly equal")

    full = fmcw_tpu.full()
    if args.cards == 4:
        phases = [("cards", lambda: phase_cards(full, 4))]
    else:
        phases = [
            ("cfar: counting kernel and jnp vs ranked stack, 1024x128",
             lambda: phase_cfar(full)),
            ("a: float32 per-cell vs golden float64, 1024x128",
             lambda: phase_float(full, "a")),
            ("b: fixed vs golden fixed point, 1024x128",
             lambda: phase_fixed(full)),
            ("c: fast() block scale, batch 128, frame 0 vs golden",
             lambda: phase_batch(fmcw_tpu.fast())),
            ("d: long CPI 1024x256 vs golden float64",
             lambda: phase_float(full.replace(n_doppler=256), "d")),
            ("e: array 8 elements -> 8 beams, ref_angle=1, card vs CPU",
             lambda: phase_array(full)),
            ("f: surveillance, tactical scenario, tracker vs golden",
             lambda: phase_surveillance(full)),
        ]
    ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            res = fn()
        except Exception as e:  # a phase that raises fails the run
            traceback.print_exc()
            res = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        res["seconds"] = round(time.perf_counter() - t0, 1)
        ok &= bool(res["ok"])
        _info(f"{'PASS' if res['ok'] else 'FAIL'} {name}: {res}")
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    _info(f"card: {card_info()}")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
