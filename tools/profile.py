#!/usr/bin/env python
"""Profiling harness: a jax.profiler trace of the batch pipeline, reduced
to device time per stage.

The reference's observability is waveform dumps + report statements
(SURVEY.md §5); here it is a profiler trace (viewable in TensorBoard or
Perfetto), the pipeline's debug taps (``include_debug=True`` ->
threshold/scale maps) and sanitization counters (saturation_count,
nonfinite_count).

Every stage of models/pipeline.py runs under a ``jax.named_scope``
(range_fft, slow_time, magnitude, cfar, grouping, topk), which lands in the
op_name metadata of the compiled HLO.  The reduction maps each HLO
instruction of the compiled program to its stage, then sums the device
durations of the trace's events by the ``hlo_op`` they ran; a fusion that
XLA built across two scopes counts toward the scope of its root.  It also
reports the device's busy share of the traced window (the union of event
intervals over first-to-last event).  On the GPU the script turns XLA's
command buffers off (``--xla_gpu_enable_command_buffer=``) so that every
kernel event names its HLO op; that adds launch gaps, so read the busy
share of such a trace as a lower bound.

Usage:
  python tools/profile.py [--out DIR] [--batch 128] [--iters 5]
                          [--mode float32|fixed] [--scale-mode cell|block]
                          [--cpu] [--quick]
Prints one JSON line with the per-stage milliseconds per batch.
"""

import argparse
import dataclasses
import glob
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STAGES = ("range_fft", "slow_time", "magnitude", "cfar", "grouping", "topk")


def _stage_of(op_name: str) -> str:
    for s in STAGES:
        if f"/{s}/" in op_name or op_name.endswith(f"/{s}"):
            return s
    return "other"


_INSTR = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+) = .*?'
                    r'op_name="([^"]*)"')


def stage_map(hlo_text: str) -> dict:
    """{HLO instruction name: stage} from a compiled program's text, also
    keyed by the kernel name XLA derives from it ('.' -> '_')."""
    out = {}
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if m:
            out[m.group(1)] = out[m.group(1).replace(".", "_")] = \
                _stage_of(m.group(2))
    return out


def reduce_trace(path: str, stages: dict) -> dict:
    """Per-stage device time (ns) and busy share from an .xplane.pb, with
    ``stages`` from stage_map()."""
    import jax
    prof = jax.profiler.ProfileData.from_file(path)
    per_stage = {s: 0 for s in STAGES + ("other",)}
    intervals = []
    n_events = 0
    for plane in prof.planes:
        if not plane.name.startswith("/device:"):
            continue
        lines = {ln.name: ln for ln in plane.lines}
        # Prefer the derived per-HLO-op line; fall back to every line that
        # is not an aggregate (modules, steps).
        chosen = ([lines["XLA Ops"]] if "XLA Ops" in lines else
                  [ln for n, ln in lines.items()
                   if n not in ("XLA Modules", "Steps", "XLA TraceMe")])
        for ln in chosen:
            for ev in ln.events:
                op = str(dict(ev.stats).get("hlo_op", ev.name))
                stage = stages.get(op) or stages.get(ev.name, "other")
                per_stage[stage] += ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                n_events += 1
    busy = window = 0
    if intervals:
        intervals.sort()
        cur_s, cur_e = intervals[0]
        for s, e in intervals[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = max(e for _, e in intervals) - intervals[0][0]
    return {"stage_ns": per_stage, "events": n_events, "busy_ns": busy,
            "window_ns": window,
            "busy_share": busy / window if window else None}


def dump_events(path: str, limit: int = 60) -> list:
    """The first ``limit`` device events with their stats (for looking at
    one trace by hand before trusting the reduction)."""
    import jax
    prof = jax.profiler.ProfileData.from_file(path)
    out = []
    for plane in prof.planes:
        if not plane.name.startswith("/device:"):
            continue
        for ln in plane.lines:
            for ev in ln.events:
                out.append({"plane": plane.name, "line": ln.name,
                            "name": ev.name, "dur_ns": ev.duration_ns,
                            "stats": {k: str(v) for k, v in ev.stats}})
                if len(out) >= limit:
                    return out
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "chiprun_out", "trace"))
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--mode", default="float32", choices=["float32", "fixed"])
    ap.add_argument("--scale-mode", default="cell", choices=["cell", "block"])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--cfar-method", default="auto")
    ap.add_argument("--quick", action="store_true",
                    help="the 128x32 quick() map (CPU rehearsal)")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    else:
        # One launch per HLO op, so each kernel event names its op (CUDA
        # graphs would fold a whole step into one 'command_buffer' op).
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_gpu_enable_command_buffer=")
    import jax
    import numpy as np
    import fmcw_tpu
    from fmcw_tpu.golden import reference
    from fmcw_tpu.models import pipeline as pl
    from fmcw_tpu.utils import compile_cache

    compile_cache.setup()
    p = fmcw_tpu.quick() if args.quick else fmcw_tpu.full()
    p = p.replace(cfar=dataclasses.replace(p.cfar, scale_mode=args.scale_mode))
    rng = np.random.default_rng(0)
    base = pl.complex_to_iq(reference.two_target_frame(p))
    batch = np.stack([base] * args.batch)
    batch = jax.device_put(
        batch + rng.integers(-8, 8, batch.shape).astype(np.int16))
    proc = pl.make_batch_processor(p, mode=args.mode, include_maps=False,
                                   cfar_method=args.cfar_method)
    jax.block_until_ready(proc(batch))   # compile + warm outside the trace
    ctrl = (jax.numpy.asarray(False), jax.numpy.asarray(0, jax.numpy.int32))
    hlo = proc.jitted.lower(batch, *ctrl).compile().as_text()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "program.hlo.txt"), "w") as f:
        f.write(hlo)

    with jax.profiler.trace(args.out):
        for _ in range(args.iters):
            out = proc(batch)
        jax.block_until_ready(out)
    files = sorted(glob.glob(os.path.join(args.out, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    red = reduce_trace(files[-1], stage_map(hlo))
    with open(os.path.join(args.out, "events_sample.json"), "w") as f:
        json.dump(dump_events(files[-1]), f, indent=1)
    d = jax.devices()[0]
    print(json.dumps({
        "what": f"device ms per batch of {args.batch} frames "
                f"({args.mode}, {args.scale_mode} scale, "
                f"{p.n_range}x{p.n_doppler})",
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
        "routes": proc.routes.as_dict(),
        "stage_ms_per_batch": {k: v / 1e6 / args.iters
                               for k, v in red["stage_ns"].items()},
        "busy_share": red["busy_share"],
        "events": red["events"],
        "trace": files[-1],
    }), flush=True)


if __name__ == "__main__":
    main()
