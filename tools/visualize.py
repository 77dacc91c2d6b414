#!/usr/bin/env python
"""End-to-end demo CLI: run the tactical scenario through the radar
pipeline + TWS tracker, write reference-format logs, render analysis PNGs.

Equivalent of running rtl/src/tb_tactical.vhd in xsim and then
model/visualize_radar_targets.py on its logs — except the whole thing runs in
seconds instead of "~30 min quick / hours full" (tb_tactical.vhd:16-19).

Usage:
  python tools/visualize.py [--quick|--full] [--scans N] [--out DIR]
                            [--cpu] [--sharded SP] [--mode float32|fixed]
  python tools/visualize.py --logs DIR     # just re-render existing logs
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true", default=True)
    ap.add_argument("--full", dest="quick", action="store_false",
                    help="full 1024x128 resolution, 120 scans")
    ap.add_argument("--scans", type=int, default=None)
    ap.add_argument("--out", default="demo_out")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--sharded", type=int, default=0, metavar="SP",
                    help="run the sp-sharded multi-chip pipeline")
    ap.add_argument("--mode", default="float32", choices=["float32", "fixed"])
    ap.add_argument("--array", type=int, default=0, metavar="E",
                    help="array-radar mode: E-element ULA scenario through "
                         "the beamformed 3D pipeline (E beams); tracks gain "
                         "an azimuth estimate from their detections' beams")
    ap.add_argument("--faithful", action="store_true",
                    help="reference-faithful burst target synthesis "
                         "(tb_tactical.vhd:252-266) instead of point targets")
    ap.add_argument("--hw-compat", action="store_true",
                    help="as-built streaming CFAR (cfar_geometry="
                         "'hw_stream'): crossed-axis geometry, startup "
                         "skip, hardware label coordinates; frames drive "
                         "the stateful proc.stream so inter-frame bleed "
                         "matches the real hardware (design_notes §4)")
    ap.add_argument("--logs", default=None,
                    help="skip processing; render existing logs in DIR")
    ap.add_argument("--iq-file", default=None, metavar="BIN",
                    help="process recorded frames (raw int16 I/Q, one "
                         "(n_doppler, n_range, 2) frame after another) "
                         "through the native streaming loader instead of "
                         "the synthetic scenario")
    ap.add_argument("--record", default=None, metavar="BIN",
                    help="also append every processed frame's raw int16 I/Q "
                         "to BIN (replayable later with --iq-file)")
    args = ap.parse_args()

    import numpy as np
    from fmcw_tpu.utils import viz

    if args.logs:
        files = viz.render(det_path=os.path.join(args.logs, "tac_detections.txt"),
                           trk_path=os.path.join(args.logs, "tac_tracks.txt"),
                           out_prefix=os.path.join(args.logs, "radar"))
        print("rendered:", ", ".join(files))
        return

    if args.cpu:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=8")
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import fmcw_tpu
    from fmcw_tpu.models import pipeline as pl, tracker as jt, scenario as sc
    from fmcw_tpu.utils import io as rio

    p = fmcw_tpu.quick() if args.quick else fmcw_tpu.full()
    if args.quick:
        # Demo CFAR geometry: the guard band must cover the scenario's
        # +-2-bin target spread or the training cells self-mask (the quick
        # preset mirrors the reference generics, which rely on BFP
        # flattening to detect anyway — see docs/design_notes.md).
        p = p.replace(cfar=fmcw_tpu.CfarParams(
            ref_range=4, ref_doppler=3, guard_range=2, guard_doppler=1))
    cfg = sc.quick_scenario() if args.quick else sc.ScenarioConfig()
    cfg.burst_synthesis = args.faithful
    if args.scans:
        cfg.num_scans = args.scans
    os.makedirs(args.out, exist_ok=True)
    det_log = os.path.join(args.out, "tac_detections.txt")
    trk_log = os.path.join(args.out, "tac_tracks.txt")
    open(det_log, "w").close()
    open(trk_log, "w").close()

    if args.hw_compat and (args.array or args.sharded):
        # Checked BEFORE the mode chain: the array/sharded branches win the
        # elif below, so a check inside the hw_compat branch could never
        # fire and --hw-compat would be silently dropped.
        ap.error("--hw-compat is single-chip by design (the as-built "
                 "streaming semantics are one sequential stream)")
    if args.array:
        if args.iq_file or args.record or args.mode != "float32":
            ap.error("--array is float32/synthetic-scenario only "
                     "(no --iq-file/--record/--mode fixed)")
        if args.sharded:
            from fmcw_tpu.parallel import mesh as M, sharded as sh
            mesh = M.make_mesh(dp=1, sp=args.sharded)
            aproc = sh.make_sharded_array_processor(
                mesh, p, n_elems=args.array, n_beams=args.array,
                include_maps=True, peak_group_radius=2, beam_group_radius=1)
            proc = lambda iq: jax.tree.map(
                lambda x: np.asarray(x)[0], aproc(iq[None]))
            print(f"array mesh: {args.array} beams over dp=1 "
                  f"sp={args.sharded} on {jax.devices()[0].platform}")
        else:
            proc = pl.make_array_processor(p, n_elems=args.array,
                                           n_beams=args.array,
                                           peak_group_radius=2,
                                           beam_group_radius=1)
            print(f"array single chip ({args.array} elems -> "
                  f"{args.array} beams): {jax.devices()[0]}")
    elif args.sharded:
        from fmcw_tpu.parallel import mesh as M, sharded as sh
        mesh = M.make_mesh(dp=1, sp=args.sharded)
        sproc = sh.make_sharded_processor(mesh, p, mode=args.mode,
                                          peak_group_radius=2,
                                          include_maps=True)
        proc = lambda iq: jax.tree.map(
            lambda x: np.asarray(x)[0], sproc(iq[None]))
        print(f"mesh: dp=1 sp={args.sharded} on {jax.devices()[0].platform}")
    elif args.hw_compat:
        hproc = pl.make_processor(p, mode=args.mode,
                                  cfar_geometry="hw_stream",
                                  peak_group_radius=2, include_maps=True)
        hw_carry = {"hist": None}

        def proc(iq):
            out, hw_carry["hist"] = hproc.stream(iq, hist=hw_carry["hist"])
            return out

        print(f"single chip, hw-compat streaming CFAR: {jax.devices()[0]}")
    else:
        proc = pl.make_processor(p, mode=args.mode, peak_group_radius=2)
        print(f"single chip: {jax.devices()[0]}")

    if args.iq_file:
        from fmcw_tpu.runtime.native import FileFrameStreamer
        streamer = FileFrameStreamer(args.iq_file,
                                     (p.n_doppler, p.n_range, 2))
        frames_iter = ((scan, iq, ())
                       for scan, iq in enumerate(streamer.frames(), 1))
        cfg.num_scans = 0  # unknown until the file drains
    elif args.array:
        scen = sc.TacticalScenario(p, cfg)
        frames_iter = ((scan, pl.complex_to_iq(frames), truth)
                       for scan, frames, truth in
                       scen.run_elements(args.array))
    else:
        scen = sc.TacticalScenario(p, cfg)
        frames_iter = ((scan, pl.complex_to_iq(frame), truth)
                       for scan, frame, truth in scen.run())
    state = jt.init_state(p.tracker)
    t0 = time.time()
    last_map = None
    n_scans = 0
    # Per-track raw detection Doppler bins keyed by PRF index — the
    # unfolder needs the *measured* bin at each PRF, not the tracker's
    # alpha-filtered position (which blends bins measured at different
    # PRFs across the stagger).
    raw_bins: dict[int, dict[int, float]] = {}
    # Array mode: per-track associated detection beams (azimuth estimate).
    track_beams: dict[int, list] = {}
    rec = open(args.record, "wb") if args.record else None
    for scan, iq, truth in frames_iter:
        n_scans = scan
        if rec is not None:
            np.ascontiguousarray(iq, dtype=np.int16).tofile(rec)
        out = proc(iq)
        out = jax.tree.map(np.asarray, out)
        if "mag_map" in out:
            last_map = out["mag_map"]
        elif "mag_cube" in out:
            # Render the strongest beam's range-Doppler map.
            b_star = int(np.argmax(out["mag_cube"].max(axis=(1, 2))))
            last_map = out["mag_cube"][b_star]
        v = out["valid"]
        rio.write_detections(det_log, out["range_bin"][v],
                             out["doppler_bin"][v], out["mag"][v], append=True)
        state, rep = jt.step(state, out["range_bin"], out["doppler_bin"],
                             out["mag"].astype(np.int32), out["valid"],
                             tp=p.tracker)
        rep = jax.tree.map(np.asarray, rep)
        ids = np.nonzero(rep["report_mask"])[0]
        # Associate each reported track with this scan's nearest raw
        # detection (within the tracker's gate) and remember its measured
        # Doppler bin under this scan's PRF index.
        if np.any(v):
            det_r = out["range_bin"][v].astype(np.float64)
            det_d = out["doppler_bin"][v].astype(np.float64)
            prf_idx = (scan - 1) % len(cfg.prf_hz)
            for i in ids:
                # Undo the tracker's 12/9-bit Q2 register wrap (bins >= 512
                # / >= 64 log negative on the full map; viz.unwrap_*_q2).
                tr = float(viz.unwrap_range_q2(rep["range_pos"][i],
                                               p.n_range)) / 4.0
                td = float(viz.unwrap_dopp_q2(rep["dopp_pos"][i],
                                              p.n_doppler)) / 4.0
                dist = np.abs(det_r - tr) + np.abs(det_d - td)
                j = int(np.argmin(dist))
                if (abs(det_r[j] - tr) <= p.tracker.assoc_gate_r
                        and abs(det_d[j] - td) <= p.tracker.assoc_gate_d):
                    raw_bins.setdefault(int(i), {})[prf_idx] = det_d[j]
                    if args.array:
                        track_beams.setdefault(int(i), []).append(
                            int(out["beam_bin"][v][j]))
        rio.write_tracks(trk_log, [
            {"id": i, "range_pos": rep["range_pos"][i],
             "dopp_pos": rep["dopp_pos"][i], "range_vel": rep["range_vel"][i],
             "quality": rep["quality"][i], "status": rep["status"][i]}
            for i in ids], active_count=int(rep["active_tracks"]),
            append=True)
        print(f"scan {scan:3d}: dets={int(np.sum(v)):3d} "
              f"tracks={int(rep['active_tracks']):2d} "
              f"truth={len(truth)}")
    if rec is not None:
        rec.close()
        print(f"recorded {n_scans} frames to {args.record}")
    dt = time.time() - t0
    print(f"{n_scans} scans in {dt:.1f}s ({n_scans / max(dt, 1e-9):.1f} "
          f"scans/s)")

    files = viz.render(det_path=det_log, trk_path=trk_log, mag_map=last_map,
                       out_prefix=os.path.join(args.out, "radar"),
                       n_range=p.n_range, n_doppler=p.n_doppler,
                       notch_scan=cfg.notch_scan)
    print("rendered:", ", ".join(files))

    # Staggered-PRF velocity unfolding: the analysis step the reference's
    # 3-PRF stagger exists for (utils/ambiguity.py), fed with the RAW
    # per-PRF detection bins associated above.  Note the tracker gates in
    # bin space (faithful to the reference), so targets whose Doppler bin
    # hops more than assoc_gate_d across the stagger won't hold a track to
    # unfold — a reference-inherited limit, not a resolver one.
    from fmcw_tpu.utils import ambiguity as amb
    quant = max(cfg.prf_hz) * cfg.wavelength / 2.0 / p.n_doppler
    for tid in sorted(raw_bins):
        meas = raw_bins[tid]
        if len(meas) < 2:
            continue
        idx = sorted(meas)
        v, res = amb.unfold_velocity(
            [meas[i] for i in idx], [cfg.prf_hz[i] for i in idx],
            p.n_doppler, wavelength=cfg.wavelength, centered=True)
        flag = "" if res <= 1.5 * quant else "  [low confidence]"
        print(f"track {tid:2d}: radial {v:+7.1f} m/s "
              f"({v * 1.94384:+7.1f} kts, stagger residual {res:.1f} m/s)"
              f"{flag}")

    if args.array and track_beams:
        # Beam index -> steering sine -> azimuth (the steering grid of
        # ops/beamform.steering_matrix at the model's default 60-deg span).
        u = np.linspace(-np.sin(np.deg2rad(60.0)),
                        np.sin(np.deg2rad(60.0)), args.array)
        print("track azimuth estimates (modal detection beam):")
        for tid in sorted(track_beams):
            beams = np.asarray(track_beams[tid])
            b = int(np.bincount(beams, minlength=args.array).argmax())
            az = float(np.degrees(np.arcsin(u[b])))
            print(f"track {tid:2d}: beam {b} -> azimuth {az:+6.1f} deg "
                  f"({len(beams)} scans)")


if __name__ == "__main__":
    main()
