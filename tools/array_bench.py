"""Array-radar model throughput A/B (stderr log; not the headline bench).

Same-run comparison of pipeline.make_array_processor CFAR routes on
device-resident element-space batches (bench.py methodology: median of
timed batches, each ending in block_until_ready, distinct noise per
frame): the counting 2D decision per beam vs the ranked stack, per-cell and
block scale, and the grouped demo configuration.

Run: python tools/array_bench.py [--batch N] [--beams B] [--ref-angle A]
(--ref-angle > 0 measures the angle-extended 3D-CFAR regime instead.)
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import dataclasses

    import jax

    from fmcw_tpu import RadarParams
    from fmcw_tpu.golden import reference
    from fmcw_tpu.models import pipeline as pl
    from fmcw_tpu.utils import compile_cache

    compile_cache.setup()

    import argparse
    ap = argparse.ArgumentParser(
        description="Array-radar model throughput A/B")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--beams", type=int, default=8)
    ap.add_argument("--ref-angle", type=int, default=0)
    args = ap.parse_args()
    batch_size, n_beams, ref_angle = args.batch, args.beams, args.ref_angle
    n_elems = n_beams

    p = RadarParams()
    p_block = p.replace(cfar=dataclasses.replace(p.cfar, scale_mode="block"))
    log(f"devices: {jax.devices()}  batch={batch_size} elems={n_elems} "
        f"beams={n_beams} map={p.n_range}x{p.n_doppler}")

    rng = np.random.default_rng(0)
    z = np.asarray(reference.two_target_frame(p, seed=3))
    elems = np.stack([
        pl.complex_to_iq(z * np.exp(2j * np.pi * 0.5 * e * 0.3))
        for e in range(n_elems)])                     # (E, nd, nr, 2) int16
    batch = np.stack([elems] * batch_size)
    batch = batch + rng.integers(-8, 8, batch.shape).astype(np.int16)
    batch_dev = jax.device_put(batch)

    def batched(p_cfg, **kw):
        proc = pl.make_array_processor(p_cfg, n_elems=n_elems,
                                       n_beams=n_beams, include_maps=False,
                                       **kw)
        import jax.numpy as jnp
        fn = jax.jit(jax.vmap(proc.jitted, in_axes=(0, None, None)))
        return lambda b: fn(b, jnp.asarray(False), jnp.asarray(0, jnp.int32))

    if ref_angle > 0:
        # Angle-extended regime: the cross-beam training set takes the
        # stacked 3D body (ops/cfar.cfar_3d).
        configs = [(f"stack3d/ra{ref_angle}",
                    batched(p, ref_angle=ref_angle))]
    else:
        configs = [
            ("count/percell", batched(p)),
            ("topk/percell", batched(p, cfar_method="topk")),
            ("count/block", batched(p_block)),
            # Production demo config: per-beam 2D grouping + cross-beam
            # grouping (different detection set — no parity probe).
            ("count/block+grouped", batched(
                p_block, peak_group_radius=2, beam_group_radius=1)),
        ]

    def sync(out):
        return np.asarray(out["n_dets"]).sum()

    results = {}
    ref = None
    for name, fn in configs:
        t0 = time.perf_counter()
        out = fn(batch_dev)
        sync(out)
        log(f"{name}: compiled+warm in {time.perf_counter() - t0:.1f}s")
        times = []
        for _ in range(8):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(batch_dev))
            times.append(time.perf_counter() - t0)
        best = batch_size / float(np.median(times))
        o = jax.tree.map(np.asarray, fn(batch_dev))

        def dset(x):
            # Full detection SET (both sides' own valid masks, beam +
            # range + doppler) — a slot-aligned compare under the
            # reference's mask could miss extra detections entirely.
            v = x["valid"][0]
            return set(zip(x["beam_bin"][0][v].tolist(),
                           x["range_bin"][0][v].tolist(),
                           x["doppler_bin"][0][v].tolist()))

        if "grouped" in name:
            ok = "n/a (grouped: different detection set)"
        elif "block" in name:
            ok = "n/a (block scale: different detector)"
        elif ref is None:
            ref = o
            ok = True
        else:
            # Same front-end, decision-equal CFAR routes: identical sets.
            ok = bool(dset(ref)) and dset(ref) == dset(o)
        results[name] = (best, ok)
        log(f"{name}: {best:.1f} cubes/s = {best * n_beams:.0f} beam-maps/s"
            f"  detection-parity={ok}")

    base = results[configs[0][0]][0]
    for name, (fps, ok) in results.items():
        log(f"  {name}: {fps / base:.2f}x vs {configs[0][0]}  parity={ok}")


if __name__ == "__main__":
    main()
