"""Benchmark: radar frames/s on one GPU (range-Doppler + CFAR, 1024x128).

Prints ONE JSON line to stdout:
  {"metric": ..., "value": N, "unit": "frames/s", "vs_baseline": N, ...}
with the device as JAX reports it and the card's name and power limit.
Per-config lines go to stderr.  ``--sweep`` adds the alternative routes.

Baseline: the reference FPGA's design budget of ~1526 frames/s (200 MHz,
fully-streaming 1 sample/clock, 1024x128 CPI — rtl/old/radar_core_v2.vhd:16-19,
BASELINE.md).  vs_baseline = frames/s / 1526.

Methodology: steady-state throughput of the jitted batch pipeline on frames
already in device memory, detections extracted on device.  Every timed batch
ends in block_until_ready; the figure is the median over the timed batches.
A config counts only if its frame 0 passes the golden-model gate of
chip_smoke.py.  The script refuses to run without a GPU.
"""

import json
import sys
import time

import numpy as np

BASELINE_FPS = 1526.0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_config(proc, batch, reps=10):
    """Median frames/s over ``reps`` timed batches (after compile+warm)."""
    import jax
    jax.block_until_ready(proc(batch))
    jax.block_until_ready(proc(batch))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(proc(batch))
        times.append(time.perf_counter() - t0)
    return batch.shape[0] / float(np.median(times))


def main():
    import dataclasses
    import jax
    import chip_smoke as cs
    from fmcw_tpu import RadarParams
    from fmcw_tpu.golden import reference
    from fmcw_tpu.models import pipeline as pl
    from fmcw_tpu.utils import compile_cache

    if jax.default_backend() != "gpu":
        log(f"bench: no GPU (JAX backend {jax.default_backend()!r})")
        return 2
    compile_cache.setup()
    card = cs.card_info()
    log(f"devices: {jax.devices()}; card: {card}")

    p = RadarParams()
    p_block = p.replace(cfar=dataclasses.replace(p.cfar, scale_mode="block"))
    rng = np.random.default_rng(0)
    frame = reference.two_target_frame(p)
    batch_size = 128
    # Distinct noise per frame so no degenerate constant folding.
    noise = rng.integers(-8, 8, (batch_size, p.n_doppler, p.n_range, 2))
    batch = (pl.complex_to_iq(frame)[None] + noise).astype(np.int16)
    frame0 = batch[0, ..., 0].astype(np.float64) + 1j * batch[0, ..., 1]
    batch_dev = jax.device_put(batch)

    H = jax.lax.Precision.HIGH
    configs = [
        # (name, params, make_batch_processor kwargs, headline?)
        ("percell", p, {}, True),
        ("block", p_block, {}, True),
        ("fixed", p, {"mode": "fixed"}, False),
    ]
    if "--sweep" in sys.argv:
        configs += [
            ("percell/topk-cfar", p, {"cfar_method": "topk"}, True),
            ("percell/ct-fft", p, {"fft_method": "ct"}, True),
            ("percell/xla-fft", p, {"fft_method": "xla"}, True),
            ("percell/precision-HIGH", p, {"precision": H}, True),
            ("block/ca", p_block.replace(cfar=dataclasses.replace(
                p_block.cfar, variant="ca")), {}, False),
        ]

    results = {}
    for name, p_cfg, kw, headline in configs:
        try:
            proc = pl.make_batch_processor(p_cfg, include_maps=True, **kw)
            out = jax.tree.map(lambda a: np.asarray(a[0]), proc(batch_dev))
            if kw.get("mode") == "fixed":
                mag, det = reference.process_frame_fixed(frame0, p_cfg)
                gate = cs.gate_fixed(out["mag_map"], out["det_map"], mag, det)
            else:
                ref = reference.process_frame(frame0, p_cfg)
                gate = cs.gate_float(out["mag_map"], out["det_map"],
                                     ref.mag_map, ref.det_map,
                                     ref.threshold_map)
            proc = pl.make_batch_processor(p_cfg, include_maps=False, **kw)
            fps = bench_config(proc, batch_dev)
            results[name] = (fps, gate["ok"], headline,
                             p_cfg.cfar.scale_mode == "cell")
            log(f"{name}: {fps:.1f} frames/s  gate={gate}  "
                f"routes={proc.routes.as_dict()}")
        except Exception as e:  # pragma: no cover
            log(f"{name}: FAILED {type(e).__name__}: {e}")

    best = max((f for f, ok, h, _ in results.values() if ok and h),
               default=0.0)
    # Reference-semantics figure: fastest per-cell adaptive-scale config
    # (the exact os_cfar_2d.vhd:187-199 classification).
    best_percell = max((f for f, ok, h, pc in results.values()
                        if ok and h and pc), default=0.0)
    d = jax.devices()[0]
    print(json.dumps({
        "metric": "radar frames/s per GPU (range-Doppler+CFAR, 1024x128)",
        "value": best,
        "unit": "frames/s",
        "vs_baseline": best / BASELINE_FPS,
        "value_percell": best_percell,
        "vs_baseline_percell": best_percell / BASELINE_FPS,
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
