#!/usr/bin/env python
"""Single-frame latency benchmark.

The throughput bench (bench.py) measures steady-state frames/s with many
frames in flight; this tool measures the other reference headline — pipeline
latency (BASELINE.md: 1 CPI corner-turn fill + pipeline stages + 776-cell
CFAR startup; at 200 MHz that is ~655 us + epsilon from ADC to detections).
Here: wall time from a host-resident int16 frame to detections back on the
host, one frame at a time, nothing overlapped.

Usage: python tools/latency_bench.py [--reps 50] [--cpu] [--mode float32]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure(proc, frame, reps):
    import numpy as np
    rng = np.random.default_rng(0)
    # Warm (compile) with a couple of frames.
    for _ in range(2):
        np.asarray(proc(frame)["n_dets"])
    lat = []
    for _ in range(reps):
        f = frame + rng.integers(-4, 4, frame.shape).astype(np.int16)
        t0 = time.perf_counter()
        out = proc(f)                        # host->device + compute dispatch
        int(np.asarray(out["n_dets"]))       # detections back on host
        lat.append(time.perf_counter() - t0)
    lat = np.array(lat) * 1e3
    return {"p50_ms": round(float(np.percentile(lat, 50)), 3),
            "p90_ms": round(float(np.percentile(lat, 90)), 3),
            "min_ms": round(float(lat.min()), 3)}


def measure_device_resident(p, frame, mode, reps=7, k=64, hw_stream=False):
    """DEVICE-RESIDENT single-frame latency: the
    frame is pre-staged in HBM and K frame->detections steps run as ONE
    jitted ``lax.fori_loop`` whose iterations are data-dependent (each
    step's output perturbs the next step's input / carries the hw-stream
    history), so the device executes them strictly serially.  Per-frame
    latency = (T(K) - T(1)) / (K - 1): dispatch and
    readback appear once in both timings and cancel — what remains is the
    on-device frame->detections critical path, the number comparable to
    the FPGA's 1-CPI (655 us) streaming-fill floor
    (rtl/old/radar_core_v2.vhd:16-20)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from fmcw_tpu.models import pipeline as pl

    if hw_stream:
        proc = pl.make_processor(p, mode=mode, include_maps=False,
                                 cfar_geometry="hw_stream")
        from fmcw_tpu.golden.fixed_point import hw_stream_lag
        hlen = 2 * hw_stream_lag(p.cfar, p.n_doppler)
        hdtype = jnp.int32 if mode == "fixed" else jnp.float32

        def make_chain(k):
            @jax.jit
            def chain(iq, byp, so):
                def body(i, carry):
                    acc, hist = carry
                    # The hist carry itself serializes the steps — the
                    # hardware's actual inter-frame dependency.
                    out, hist = proc.stream(iq, mti_bypass=byp,
                                            scale_override=so, hist=hist)
                    return acc + out["n_dets"], hist
                acc, _ = jax.lax.fori_loop(
                    0, k, body, (jnp.int32(0), jnp.zeros((hlen,), hdtype)))
                return acc
            return chain
    else:
        proc = pl.make_processor(p, mode=mode, include_maps=False)
        step = proc.jitted

        def make_chain(k):
            @jax.jit
            def chain(iq, byp, so):
                def body(i, carry):
                    acc, x = carry
                    out = step(x, byp, so)
                    # Data dependency the compiler cannot elide (n_dets is
                    # runtime-valued): serializes the K steps.
                    x = jnp.where(out["n_dets"] < 0, x + jnp.int16(1), x)
                    return acc + out["n_dets"], x
                acc, _ = jax.lax.fori_loop(0, k, body, (jnp.int32(0), iq))
                return acc
            return chain

    byp = jnp.asarray(False)
    so = jnp.asarray(0, jnp.int32)
    iq_dev = jax.device_put(frame)
    c1, ck = make_chain(1), make_chain(k)
    int(np.asarray(c1(iq_dev, byp, so)))           # compile + warm
    int(np.asarray(ck(iq_dev, byp, so)))
    t1s, tks = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        int(np.asarray(c1(iq_dev, byp, so)))
        t1s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        int(np.asarray(ck(iq_dev, byp, so)))
        tks.append(time.perf_counter() - t0)
    # Per-dispatch host jitter rides on both T(1) and T(K);
    # difference against ONE baseline (median of the T(1) reps) rather than
    # per-rep pairs, and size K so (K-1) frames of compute dwarf the
    # residual jitter.  Using the same baseline for p50/p90/min keeps the
    # order statistics coherent (min <= p50 <= p90 by construction);
    # ``floor_est_us`` differences the minima instead (the jitter is
    # one-sided queueing delay, so min-min strips the queueing floor from
    # both sides) — it is a separate estimator of the same quantity and may
    # land on either side of p50 when the baseline reps' jitter spread is a
    # few ms (each ms of baseline spread is ~2 us/frame at K=512).
    t1s, tks = np.array(t1s), np.array(tks)
    base = np.median(t1s)
    med = (np.median(tks) - base) / (k - 1) * 1e6
    p90 = (np.percentile(tks, 90) - base) / (k - 1) * 1e6
    mn = (tks.min() - base) / (k - 1) * 1e6
    floor = (tks.min() - t1s.min()) / (k - 1) * 1e6
    return {"p50_us": round(float(med), 1),
            "p90_us": round(float(p90), 1),
            "min_us": round(float(mn), 1),
            "floor_est_us": round(float(floor), 1),
            "chain_k": k, "reps": reps}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--mode", default=None, choices=[None, "float32", "fixed"],
                    help="one mode only (default: sweep both)")
    ap.add_argument("--device-resident", action="store_true",
                    help="also measure the device-resident serialized "
                         "chain latency (pre-staged frame, no host I/O)")
    ap.add_argument("--chain-k", type=int, default=512)
    ap.add_argument("--out", default=None,
                    help="write a JSON artifact (e.g. LATENCY.json)")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import numpy as np
    import fmcw_tpu
    from fmcw_tpu.golden import reference
    from fmcw_tpu.models import pipeline as pl
    from fmcw_tpu.utils import compile_cache

    compile_cache.setup()
    p = fmcw_tpu.full()
    frame = pl.complex_to_iq(reference.two_target_frame(p))
    modes = [args.mode] if args.mode else ["float32", "fixed"]
    results = {}
    for mode in modes:
        proc = pl.make_processor(p, mode=mode, include_maps=False)
        results[mode] = measure(proc, frame, args.reps)
        r = results[mode]
        print(f"{mode}: single-frame latency over {args.reps} reps (ms): "
              f"p50={r['p50_ms']:.2f} p90={r['p90_ms']:.2f} "
              f"min={r['min_ms']:.2f}")
    device_resident = {}
    if args.device_resident:
        for mode in modes:
            device_resident[mode] = measure_device_resident(
                p, frame, mode, k=args.chain_k)
            r = device_resident[mode]
            print(f"{mode} DEVICE-RESIDENT: p50={r['p50_us']:.0f}us "
                  f"p90={r['p90_us']:.0f}us min={r['min_us']:.0f}us "
                  f"(chained k={r['chain_k']})")
        # hw-compat streaming CFAR: first-detection latency of the as-built
        # streaming geometry, serialized by its real inter-frame carry.
        # Only when fixed mode is in the sweep — --mode float32 must not
        # pay two unrequested fixed-chain compiles.
        if "fixed" in modes:
            device_resident["hw_stream_fixed"] = measure_device_resident(
                p, frame, "fixed", k=min(args.chain_k, 128), hw_stream=True)
            r = device_resident["hw_stream_fixed"]
            print(f"hw_stream/fixed DEVICE-RESIDENT: p50={r['p50_us']:.0f}us "
                  f"(chained k={r['chain_k']})")
    print("[reference budget ~0.66 ms CPI fill + pipeline]")
    if args.out:
        artifact = {
            "what": "host int16 frame -> detections on host, one frame at a "
                    "time, nothing overlapped (1024x128 CPI)",
            "device": {"platform": jax.devices()[0].platform,
                       "kind": jax.devices()[0].device_kind,
                       "count": len(jax.devices())},
            "reps": args.reps,
            "results": results,
            "device_resident": {
                "what": "pre-staged HBM frame -> detections, K steps "
                        "serialized on device by a data dependency; "
                        "per-frame = (T(K)-T(1))/(K-1), so "
                        "dispatch/readback cancel — the on-device "
                        "frame->detections critical path",
                "fpga_comparison": "reference floor is 1 CPI corner-turn "
                        "fill (655.36 us @200 MHz, radar_core_v2.vhd:16-20)"
                        " + 776-cell CFAR startup; measured device-resident"
                        " latency below is the device's equivalent number",
                "results": device_resident,
            } if device_resident else None,
            "methodology_note": (
                "host-path latency includes host->device transfer, "
                "dispatch and readback; the reference hardware's latency "
                "floor is 1 CPI (655 us) of corner-turn fill + pipeline + "
                "776-cell CFAR startup (rtl/old/radar_core_v2.vhd:16-20, "
                "os_cfar_2d.vhd:66-68)."),
        }
        with open(args.out, "w") as fh:
            json.dump(artifact, fh, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
