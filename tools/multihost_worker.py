"""Multi-host validation worker (BASELINE config 5; SURVEY.md §2d/§4).

The reference is a single-chip dataflow machine; this framework's multi-host
story is a ``jax.distributed`` global mesh.  This worker simulates the
topology on the CPU: N processes (one per "host"), each owning
``--local-devices`` virtual CPU devices, joined through the JAX coordination
service with cross-process gloo collectives — the same code path
``parallel/mesh.maybe_init_distributed`` takes on real hosts.

Launched by tests/test_multihost.py (or manually):

    python tools/multihost_worker.py --process-id I --num-processes N \
        --coordinator localhost:PORT [--local-devices 4]

Each process runs the sharded radar pipeline over the GLOBAL mesh in two
regimes and checks every output row it can address against the local
single-device pipeline (mode="fixed" — bit-identical by the parity
invariant):

* dp across hosts (dp=N, sp=local): frame data-parallelism across the host
  boundary — the throughput regime;
* sp across hosts (dp=1, sp=N*local): the all-to-all corner turn and the
  ppermute CFAR halo ring cross the host boundary — the latency regime and
  the hardest collective path.

Prints ``MULTIHOST OK ...`` and exits 0 on success.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--production-shape", action="store_true",
                    help="also run the PRODUCTION 1024x128 CPI with sp "
                         "spanning the process boundary (slow): fixed mode "
                         "asserted bit-identical to single device, float "
                         "mode with grouping to the same positions")
    args = ap.parse_args()

    # Force this process's virtual chip count (scrub any inherited value —
    # pytest's conftest pins 8) before the backend initializes.
    flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
                   os.environ.get("XLA_FLAGS", ""))
    os.environ["XLA_FLAGS"] = (
        f"{flags} --xla_force_host_platform_device_count="
        f"{args.local_devices}").strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=args.coordinator,
                               num_processes=args.num_processes,
                               process_id=args.process_id)

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    import fmcw_tpu
    from fmcw_tpu.golden import reference as ref
    from fmcw_tpu.models import pipeline as pl
    from fmcw_tpu.parallel import mesh as M, sharded as sh

    n_global = args.num_processes * args.local_devices
    assert jax.device_count() == n_global, jax.devices()
    assert jax.local_device_count() == args.local_devices

    p = fmcw_tpu.quick()
    frames = [ref.two_target_frame(p, seed=s) for s in range(4)]
    batch = np.stack([pl.complex_to_iq(f) for f in frames])

    # Local single-device reference (bit-identical contract in fixed mode).
    single = jax.tree.map(
        np.asarray,
        pl.make_batch_processor(p, mode="fixed",
                                peak_group_radius=1)(batch))

    def check_rows(out, tag):
        """Verify every batch row this process can address."""
        v_all = single["valid"]
        seen = set()
        for s_ in out["valid"].addressable_shards:
            b = s_.index[0]
            rows = range(b.start or 0, b.stop if b.stop is not None
                         else batch.shape[0])
            for r, val in zip(rows, np.asarray(s_.data)):
                seen.add(r)
                assert np.array_equal(val, v_all[r]), (tag, r)
        assert seen, tag

        def rows_of(key):
            d = {}
            for s_ in out[key].addressable_shards:
                b = s_.index[0]
                start = b.start or 0
                d.update({start + i: row for i, row in
                          enumerate(np.asarray(s_.data))})
            return d

        for key in ("range_bin", "doppler_bin", "mag", "n_dets"):
            got = rows_of(key)
            for r, val in got.items():
                want = single[key][r]
                if key != "n_dets":
                    val, want = val[v_all[r]], want[v_all[r]]
                assert np.array_equal(val, want), (tag, key, r)
        return len(seen)

    results = []
    for dp, sp in ((args.num_processes, args.local_devices),
                   (1, n_global)):
        mesh = M.make_mesh(dp=dp, sp=sp)
        proc = sh.make_sharded_processor(mesh, p, mode="fixed",
                                         peak_group_radius=1)
        shard = NamedSharding(mesh, P("dp", "sp", None, None))
        gx = jax.make_array_from_callback(batch.shape, shard,
                                          lambda idx: batch[idx])
        out = proc(gx)
        n = check_rows(out, f"dp{dp}sp{sp}")
        results.append(f"dp{dp}sp{sp}:{n}rows")

    # Beam-sharded array model across hosts: beams sharded
    # over the GLOBAL sp axis with ref_angle=1, so the angle-halo ppermute
    # ring (and its wraparound link) crosses the process boundary.  Same
    # XLA front-end on both sides -> identical detection sets vs the
    # single-device array model.
    import dataclasses
    from fmcw_tpu import CfarParams, RadarParams

    pa = RadarParams(n_range=256, n_doppler=64,
                     cfar=dataclasses.replace(CfarParams(), scale_block=2))
    n_elems, n_beams = 4, n_global
    rng = np.random.default_rng(7)
    cubes = []
    for b in range(2):
        z = np.asarray(ref.two_target_frame(pa, seed=50 + b,
                                            targets=((60, 20, 12000),)))
        elems = []
        for e in range(n_elems):
            ph = np.exp(2j * np.pi * 0.5 * e * 0.4)
            noisy = z * ph + (rng.normal(0, 8, z.shape)
                              + 1j * rng.normal(0, 8, z.shape))
            elems.append(pl.complex_to_iq(noisy))
        cubes.append(np.stack(elems))
    batch_a = np.stack(cubes)

    single_a = pl.make_array_processor(pa, n_elems=n_elems, n_beams=n_beams,
                                       ref_angle=1, include_maps=False)
    mesh_a = M.make_mesh(dp=1, sp=n_global)
    proc_a = sh.make_sharded_array_processor(
        mesh_a, pa, n_elems=n_elems, n_beams=n_beams, ref_angle=1)
    def local_view(x):
        """Replicated-across-processes outputs are not fully addressable,
        but every process holds a complete replica — read the local shard
        when its extent covers the global shape."""
        if getattr(x, "is_fully_addressable", True):
            return np.asarray(x)
        sh_ = x.addressable_shards[0]
        return np.asarray(sh_.data) if sh_.data.shape == x.shape else None

    out_a = jax.tree.map(local_view, proc_a(batch_a))
    n_checked = 0
    for i in range(batch_a.shape[0]):
        want = jax.tree.map(np.asarray, single_a(batch_a[i]))
        wv = want["valid"]
        want_set = set(zip(want["beam_bin"][wv].tolist(),
                           want["range_bin"][wv].tolist(),
                           want["doppler_bin"][wv].tolist()))
        assert want_set, "single-device array model found no detections"
        v = out_a["valid"][i]
        got_set = set(zip(out_a["beam_bin"][i][v].tolist(),
                          out_a["range_bin"][i][v].tolist(),
                          out_a["doppler_bin"][i][v].tolist()))
        assert got_set == want_set, ("array", i, got_set ^ want_set)
        assert out_a["n_dets"][i] == want["n_dets"], ("array n_dets", i)
        n_checked += len(want_set)
    results.append(f"array-sp{n_global}:{n_checked}dets")

    if args.production_shape:
        # PRODUCTION shape 1024x128 (the size the reference's corner turn
        # is defined at, rtl/src/corner_turner.vhd:29-36) with sp spanning
        # the process boundary: the all-to-all corner turn and the CFAR
        # halo ring ride the cross-process collectives (gloo).
        pf = fmcw_tpu.full()
        fb = np.stack([pl.complex_to_iq(ref.two_target_frame(pf, seed=0))])
        mesh_f = M.make_mesh(dp=1, sp=n_global)

        def det_set(out, want_keys=("range_bin", "doppler_bin", "mag")):
            o = {k: local_view(v) for k, v in out.items()}
            v = o["valid"][0]
            return set(zip(*[o[k][0][v].tolist() for k in want_keys]))

        # (a) fixed mode, XLA chain: bit-identical to single device.
        proc_f = sh.make_sharded_processor(mesh_f, pf, mode="fixed")
        out_f = proc_f(fb)
        ref_f = jax.tree.map(np.asarray, pl.make_processor(
            pf, mode="fixed", include_maps=False)(fb[0]))
        rv = ref_f["valid"]
        want = set(zip(ref_f["range_bin"][rv].tolist(),
                       ref_f["doppler_bin"][rv].tolist(),
                       ref_f["mag"][rv].tolist()))
        got = det_set(out_f)
        assert got == want and want, ("prod fixed", sorted(got ^ want)[:8])

        # (b) float32 chain with peak grouping: the same detection
        # positions as the single device (magnitudes agree to float
        # tolerance: the all-to-all reorders the matmul sums).
        proc_s = sh.make_sharded_processor(mesh_f, pf, mode="float32",
                                           peak_group_radius=2)
        out_s = proc_s(fb)
        ref_s = jax.tree.map(np.asarray, pl.make_processor(
            pf, mode="float32", include_maps=False,
            peak_group_radius=2)(fb[0]))
        rv = ref_s["valid"]
        want_s = set(zip(ref_s["range_bin"][rv].tolist(),
                         ref_s["doppler_bin"][rv].tolist()))
        got_s = det_set(out_s, ("range_bin", "doppler_bin"))
        assert got_s == want_s and want_s, ("prod float",
                                            sorted(got_s ^ want_s)[:8])
        results.append(f"prod1024x128-sp{n_global}:fixed{len(want)}dets+"
                       f"float{len(want_s)}dets")

    # Multi-host tracking-rate surveillance (BASELINE config 5): every host
    # drives the SAME tracker state from the dp-gathered detections and
    # writes the reference-format logs; host-local numpy frames exercise
    # the replicated-input path of make_sharded_processor.
    import hashlib
    import tempfile

    from fmcw_tpu.runtime import surveillance as sv

    mesh = M.make_mesh(dp=args.num_processes, sp=args.local_devices)
    proc = sh.make_sharded_processor(mesh, p, mode="fixed")
    frames = [pl.complex_to_iq(ref.two_target_frame(p, seed=100 + s))
              for s in range(8)]
    d = os.environ.get("MH_LOG_DIR", tempfile.gettempdir())
    det_log = os.path.join(d, f"mh_det_p{args.process_id}.txt")
    trk_log = os.path.join(d, f"mh_trk_p{args.process_id}.txt")
    scans = list(sv.run_surveillance(proc, frames, p, batch_scans=4,
                                     det_log=det_log, trk_log=trk_log))
    actives = [s.active_tracks for s in scans]
    h = hashlib.sha256(open(det_log, "rb").read()
                       + open(trk_log, "rb").read()).hexdigest()[:12]

    print(f"MULTIHOST OK p{args.process_id}/{args.num_processes} "
          f"({n_global} devices): " + " ".join(results)
          + f" surv:{len(scans)}scans actives={actives} loghash={h}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
