#!/usr/bin/env python
"""Multi-device / multi-host scaling benchmark (BASELINE configs 3 and 5).

Measures frames/s for the sharded pipeline across mesh shapes and reports
weak-scaling efficiency: each added chip brings its own share of frames
(dp scaling) or its own slice of the map (sp scaling); efficiency =
fps(n) / (n * fps(1)).

Usage:
  python tools/bench_scaling.py [--cpu N] [--batch B] [--mode float32|fixed]
                                [--iters K] [--quick]

Emits one JSON line of per-mesh results plus a ``northstar`` record:
pass/fail against the >= 90% weak-scaling-efficiency target (BASELINE.json
north star) evaluated on the largest dp mesh measured.

On one host with several GPUs, plain ``python tools/bench_scaling.py`` uses
every card.  Across hosts, one command per host:

    JAX_COORDINATOR_ADDRESS=host0:8476 JAX_NUM_PROCESSES=$H \
    JAX_PROCESS_ID=$i python tools/bench_scaling.py --batch 64

``parallel/mesh.maybe_init_distributed`` reads those env vars and the mesh
spans all hosts.  ``--cpu 8`` demonstrates the methodology on the virtual
CPU mesh (its numbers are not device numbers; the sharding/collective
structure is identical — the northstar gate is only meaningful on GPUs).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", type=int, default=0, metavar="N",
                    help="force CPU backend with N virtual devices")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--mode", default="float32", choices=["float32", "fixed"])
    ap.add_argument("--quick", action="store_true",
                    help="quick 128x32 maps (fast CPU demonstration)")
    args = ap.parse_args()

    if args.cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.cpu}")
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import numpy as np
    import fmcw_tpu
    from fmcw_tpu.golden import reference
    from fmcw_tpu.models import pipeline as pl
    from fmcw_tpu.parallel import mesh as M, sharded as sh

    M.maybe_init_distributed()
    n_dev = jax.device_count()
    print(f"devices: {n_dev} x {jax.devices()[0].device_kind}", file=sys.stderr)

    p = fmcw_tpu.quick() if args.quick else fmcw_tpu.full()
    base = pl.complex_to_iq(reference.two_target_frame(p))
    rng = np.random.default_rng(0)

    def bench(mesh, batch_size):
        proc = sh.make_sharded_processor(mesh, p, mode=args.mode,
                                         include_maps=False)
        batch = np.stack([base] * batch_size)
        batch = batch + rng.integers(-8, 8, batch.shape).astype(np.int16)
        out = proc(batch)
        np.asarray(out["n_dets"])
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = proc(batch)
        np.asarray(out["n_dets"])
        dt = time.perf_counter() - t0
        return batch_size * args.iters / dt

    # Chip counts to sweep: powers of two PLUS the full slice, so a
    # 6/12-chip slice gates its northstar on all its chips, not on the
    # largest power of two below them.
    def counts(start):
        ns, n = [], start
        while n <= n_dev:
            ns.append(n)
            n *= 2
        if n_dev not in ns and n_dev >= start:
            ns.append(n_dev)
        return ns

    results = []
    # dp weak scaling: n chips, n * batch frames.
    for n in counts(1):
        mesh = M.make_mesh(dp=n, sp=1, devices=jax.devices()[:n])
        fps = bench(mesh, args.batch * n)
        results.append({"config": f"dp={n}", "chips": n, "fps": round(fps, 1)})
        print(f"dp={n}: {fps:.1f} fps", file=sys.stderr)
    # sp scaling at fixed batch: map sharded across chips.
    for n in counts(2):
        if p.n_doppler % n == 0 and p.n_range % n == 0:
            mesh = M.make_mesh(dp=1, sp=n, devices=jax.devices()[:n])
            fps = bench(mesh, args.batch)
            results.append({"config": f"sp={n}", "chips": n,
                            "fps": round(fps, 1)})
            print(f"sp={n}: {fps:.1f} fps", file=sys.stderr)

    base_fps = results[0]["fps"]
    for r in results:
        r["weak_scaling_eff"] = round(r["fps"] / (r["chips"] * base_fps), 3)
    dp_results = [r for r in results if r["config"].startswith("dp=")]
    biggest = dp_results[-1]
    northstar = {
        "target_eff": 0.90,
        "measured_eff": biggest["weak_scaling_eff"],
        "at": biggest["config"],
        "hardware": jax.devices()[0].device_kind,
        "meaningful": jax.default_backend() == "gpu" and n_dev > 1,
        "pass": biggest["weak_scaling_eff"] >= 0.90,
    }
    print(json.dumps({"results": results, "northstar": northstar}))
    if northstar["meaningful"] and not northstar["pass"]:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
