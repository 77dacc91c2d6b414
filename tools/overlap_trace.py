"""Corner-turn collective cost: trace-derived numbers.

Profiles the sp-sharded pipeline on the virtual CPU mesh with the JAX
profiler (perfetto trace), extracts the all-to-all (corner turn) and
collective-permute (CFAR halo) event durations vs total device time, and
prints/commits the derived numbers (docs/overlap_trace.json).

The CPU backend executes thunks serially, so this measures the collectives'
*cost share* of a step — the quantity the overlap claim in
docs/corner_turn.md needs: if the corner-turn exchange is x% of step time
and the dp axis pipelines independent frames, hiding it needs only that
much concurrent compute.  (True collective/compute overlap is a property
of the GPU runtime, read from a multi-card profiler trace; on the CPU mesh
the cost share is the measurable proxy.)

Usage: python tools/overlap_trace.py [--devices 8] [--batch 8] [--out J]
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import re
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--out", default=None, metavar="JSON")
    args = ap.parse_args()

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.devices}")
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    import fmcw_tpu
    from fmcw_tpu.golden import reference
    from fmcw_tpu.models import pipeline as pl
    from fmcw_tpu.parallel import mesh as M, sharded as sh

    p = fmcw_tpu.full()
    mesh = M.make_mesh(dp=1, sp=args.devices)
    proc = sh.make_sharded_processor(mesh, p, include_maps=False)
    rng = np.random.default_rng(0)
    base = pl.complex_to_iq(reference.two_target_frame(p))
    batch = np.stack([base] * args.batch)
    batch = batch + rng.integers(-8, 8, batch.shape).astype(np.int16)

    out = proc(batch)
    np.asarray(out["n_dets"])                      # warm/compile

    # Correctness gate on the traced full-size sharded execution: frame 0's
    # detection set must equal the single-device pipeline's (the
    # production-shape parity contract — a profiling run must not measure
    # a wrong program).
    single = pl.make_processor(p, mode="float32", include_maps=False)
    ref_out = jax.tree.map(np.asarray, single(batch[0]))
    got = jax.tree.map(np.asarray, proc(batch[:1]))
    v_s, v_r = got["valid"][0], ref_out["valid"]
    dets_s = set(zip(got["range_bin"][0][v_s].tolist(),
                     got["doppler_bin"][0][v_s].tolist()))
    dets_r = set(zip(ref_out["range_bin"][v_r].tolist(),
                     ref_out["doppler_bin"][v_r].tolist()))
    assert dets_s == dets_r, (
        f"sharded full-size detections diverge from single chip: "
        f"{sorted(dets_s ^ dets_r)[:8]}")
    print(f"parity gate: {len(dets_s)} frame-0 detections == single chip",
          file=sys.stderr)

    tdir = tempfile.mkdtemp(prefix="fmcw_trace_")
    with jax.profiler.trace(tdir, create_perfetto_trace=True):
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = proc(batch)
        np.asarray(out["n_dets"])
        wall = time.perf_counter() - t0

    traces = glob.glob(os.path.join(tdir, "**", "*.json.gz"), recursive=True)
    if not traces:
        print("no perfetto trace found under", tdir, file=sys.stderr)
        return 1
    with gzip.open(traces[0], "rt") as f:
        tr = json.load(f)
    events = tr["traceEvents"] if isinstance(tr, dict) else tr

    # Event names carry the HLO/jax op names: the corner turn is
    # "all-to-all*", the CFAR halo ring "ppermute.*", the detection gather
    # "all_gather.*".  The denominator is total op-execution thread time on
    # the XLA executor lanes — the tf_XLA* worker pools AND the PjRt
    # client threads (some thunks execute inline on the calling thread;
    # excluding that lane would silently drop their work from the
    # denominator).  Python/jit wrapper lanes stay excluded: their spans
    # ENCLOSE the worker-lane op spans and would double-count.
    # Bookkeeping spans (ThunkExecutor waits, "end:" markers, pool awaits,
    # PjRt dispatch shells) are excluded by name — on the serial-thunk CPU
    # backend what remains is the honest "work time" a collective's share
    # is measured against.
    buckets = {
        "all-to-all": re.compile(r"^all-to-all"),
        "cfar-halo-ppermute": re.compile(r"^ppermute"),
        "detection-all-gather": re.compile(r"^all_gather"),
    }
    skip = re.compile(r"^(end:|ThunkExecutor|SlinkyThreadPool|PjRt|"
                      r"CommonPjRt|Handle inputs|.*Await|EventPool|RunReady|"
                      r"ExecuteAddressable|Execute$|BufferFromHostBuffer|"
                      r"TransferTo|CopyToDevice|Compile|XlaComputation)")
    lane = {}
    for ev in events:
        if isinstance(ev, dict) and ev.get("ph") == "M" \
                and ev.get("name") == "thread_name":
            lane[(ev.get("pid"), ev.get("tid"))] = \
                ev.get("args", {}).get("name", "") or ""
    lane_ok = re.compile(r"tf_XLA|PjRt")
    totals = {k: 0.0 for k in buckets}
    total_dev = 0.0
    n_ev = 0
    for ev in events:
        if not isinstance(ev, dict) or ev.get("ph") != "X":
            continue
        if not lane_ok.search(lane.get((ev.get("pid"), ev.get("tid")), "")):
            continue
        name = ev.get("name", "")
        if skip.match(name):
            continue
        dur = float(ev.get("dur", 0.0))           # microseconds
        total_dev += dur
        n_ev += 1
        for k, rx in buckets.items():
            if rx.search(name):
                totals[k] += dur

    res = {
        "devices": args.devices,
        "batch": args.batch,
        "iters": args.iters,
        "wall_s": round(wall, 4),
        "trace_events": n_ev,
        "op_thread_time_us_total": round(total_dev, 1),
        "collective_us": {k: round(v, 1) for k, v in totals.items()},
        "collective_share": {
            k: round(v / max(total_dev, 1e-9), 4) for k, v in totals.items()},
    }
    print(json.dumps(res, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
