#!/usr/bin/env python
"""End-to-end surveillance throughput benchmark (BASELINE configs 2 + 5).

Measures sustained frames/s of the WHOLE system, not just the on-device
pipeline: host-resident int16 frames -> double-buffered batched ingest
(runtime/stream.stream_batched, H2D overlapping compute) -> batch
pipeline -> TWS tracker scan steps -> detection/track logs in the reference
text formats (utils/io).  This is the batched analog of the reference's
fully-streaming operation: ADC in, tracks out (rtl/src/radar_core.vhd:26-55).

Usage: python tools/e2e_bench.py [--frames 1024] [--batch 128] [--cpu]
                                 [--scale-mode block|cell] [--no-logs]
                                 [--track-every N]

Prints one JSON line: sustained end-to-end frames/s (+ the ingest-only and
pipeline-only reference points from bench.py methodology).
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--scale-mode", default="block", choices=["block", "cell"])
    ap.add_argument("--no-logs", action="store_true",
                    help="skip det/trk log writing (isolate the IO cost)")
    ap.add_argument("--track-every", type=int, default=1,
                    help="tracker scan step every N frames (scan rate vs "
                    "frame rate; the reference tracks per CPI)")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import dataclasses
    from fmcw_tpu import RadarParams
    from fmcw_tpu.golden import reference
    from fmcw_tpu.models import pipeline as pl, tracker as jt
    from fmcw_tpu.runtime.stream import stream_batched, StreamStats
    from fmcw_tpu.utils import io as rio

    p = RadarParams()
    if args.scale_mode == "block":
        p = p.replace(cfar=dataclasses.replace(p.cfar, scale_mode="block"))
    print(f"devices: {jax.devices()}", file=sys.stderr)
    from fmcw_tpu.utils import compile_cache
    compile_cache.setup()

    rng = np.random.default_rng(0)
    base = pl.complex_to_iq(reference.two_target_frame(p))
    # A pool of distinct host frames, cycled to the requested length
    # (fresh noise per pool frame; the pool bounds host RAM at ~256 MB).
    pool = [base + rng.integers(-8, 8, base.shape).astype(np.int16)
            for _ in range(min(args.frames, 512))]
    frames = [pool[i % len(pool)] for i in range(args.frames)]

    proc = pl.make_batch_processor(p, mode="float32", include_maps=False,
                                   peak_group_radius=2)

    tp = p.tracker
    tmp = tempfile.mkdtemp(prefix="e2e_bench_")
    det_log = None if args.no_logs else os.path.join(tmp, "detections.txt")
    trk_log = None if args.no_logs else os.path.join(tmp, "tracks.txt")

    def run_once():
        """One full pass over ``frames``; returns (wall_s, processed, dets)."""
        state = jt.init_state(tp)
        stats = StreamStats()
        total_dets = 0
        frame_base = 0                 # global frame index of this batch's 0
        t0 = time.perf_counter()
        for out in stream_batched(proc, iter(frames), batch_size=args.batch,
                                  depth=args.depth, stats=stats):
            n_valid = out["batch_valid"]
            o = {k: np.asarray(v[:n_valid]) for k, v in out.items()
                 if k != "batch_valid"}
            step = args.track_every
            # 1-in-N of the global stream (stride phase carries across
            # batch boundaries).
            idx = np.arange((-frame_base) % step, n_valid, step)
            frame_base += int(n_valid)
            import jax.numpy as jnp
            state_dev = {k: jnp.asarray(v) for k, v in state.items()}
            final, reps = jt.run_scans(
                jnp.asarray(o["range_bin"][idx]),
                jnp.asarray(o["doppler_bin"][idx]),
                jnp.asarray(o["mag"][idx].astype(np.int32)),
                jnp.asarray(o["valid"][idx]), tp=tp, state=state_dev)
            reps = jax.tree.map(np.asarray, reps)
            state = {k: np.asarray(v) for k, v in final.items()}
            total_dets += int(o["valid"].sum())
            if det_log:
                for i in range(n_valid):
                    v = o["valid"][i]
                    rio.write_detections(det_log, o["range_bin"][i][v],
                                         o["doppler_bin"][i][v],
                                         o["mag"][i][v], append=True)
            if trk_log:
                for s in range(len(idx)):
                    rep = {k: val[s] for k, val in reps.items()}
                    ids = np.nonzero(rep["report_mask"])[0]
                    rio.write_tracks(trk_log, [
                        {"id": t, "range_pos": rep["range_pos"][t],
                         "dopp_pos": rep["dopp_pos"][t],
                         "range_vel": rep["range_vel"][t],
                         "quality": rep["quality"][t],
                         "status": rep["status"][t]} for t in ids],
                        active_count=int(rep["active_tracks"]), append=True)
        dt = time.perf_counter() - t0
        return dt, stats.frames_processed, total_dets, int(
            np.asarray(state["status"] > 1).sum())

    if det_log:
        open(det_log, "w").close()
        open(trk_log, "w").close()
    run_once()                       # compile + warm
    best = None
    for _ in range(2):
        if det_log:
            open(det_log, "w").close()
            open(trk_log, "w").close()
        dt, n, dets, firm = run_once()
        fps = n / dt
        best = max(best or 0.0, fps)
        print(f"e2e: {n} frames in {dt:.3f}s = {fps:.1f} frames/s "
              f"({dets} dets, {firm} firm/coast tracks)", file=sys.stderr)
    if det_log:
        print(f"logs: {det_log} {trk_log}", file=sys.stderr)
    print(json.dumps({
        "metric": "end-to-end surveillance frames/s (ingest+pipeline+"
                  "tracker+logs, 1024x128)",
        "value": round(best, 1),
        "unit": "frames/s",
        "vs_baseline": round(best / 1526.0, 3),
    }), flush=True)


if __name__ == "__main__":
    main()
