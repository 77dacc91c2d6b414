#!/usr/bin/env python
"""Stage-split microbenchmark: time FFT-only, CFAR-only, and full-pipeline
variants on the current backend to see where the frame budget goes.

Usage: python tools/stage_bench.py [--batch 32] [--iters 16] [--cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timeit(fn, sync, iters):
    sync(fn())   # compile + warm, fully drained before the clock starts
    sync(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    sync(out)
    return (time.perf_counter() - t0) / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np
    import fmcw_tpu
    from fmcw_tpu.golden import reference
    from fmcw_tpu.models import pipeline as pl
    from fmcw_tpu.ops import fft as F, notch as N, magnitude as M, cfar as C
    from fmcw_tpu.ops import detect as DET
    from fmcw_tpu.utils import compile_cache

    compile_cache.setup()
    p = fmcw_tpu.full()
    B = args.batch
    rng = np.random.default_rng(0)
    base = pl.complex_to_iq(reference.two_target_frame(p))
    batch = np.stack([base] * B)
    batch = batch + rng.integers(-8, 8, batch.shape).astype(np.int16)
    iq = jax.device_put(batch)
    prec = jax.lax.Precision.HIGH

    def sync(x):
        jax.block_until_ready(x)

    @jax.jit
    def ffts_only(iq):
        re = iq[..., 0].astype(jnp.float32)
        im = iq[..., 1].astype(jnp.float32)
        re, im = F.fft_apply(re, im, axis=2, window=True, precision=prec)
        re = jnp.swapaxes(re, 1, 2)
        im = jnp.swapaxes(im, 1, 2)
        re, im = N.mti_notch_float(re, im, axis=2, mode=p.notch_mode,
                                   bypass=jnp.asarray(False),
                                   transient="zero")
        re, im = F.fft_apply(re, im, axis=2, window=True, precision=prec)
        return M.magnitude_float(re, im)

    mag = ffts_only(iq)
    mag = jax.device_put(np.asarray(mag))

    cfar_count = jax.jit(jax.vmap(lambda m: C.cfar_2d_auto(
        m, jnp.int32(0), cfar=p.cfar, method="count", need_debug=False)[0]))
    cfar_topk = jax.jit(jax.vmap(lambda m: C.cfar_2d_auto(
        m, jnp.int32(0), cfar=p.cfar, method="topk", need_debug=True)[0]))
    topk = jax.jit(jax.vmap(lambda d: DET.topk_detections(
        d, max_dets=p.tracker.max_dets)["n_dets"]))

    det = cfar_count(mag)
    full = pl.make_batch_processor(p, mode="float32", include_maps=False,
                                   precision=prec)

    results = {
        "ffts+mag": timeit(lambda: ffts_only(iq), sync, args.iters),
        "cfar-count": timeit(lambda: cfar_count(mag), sync, args.iters),
        "cfar-topk": timeit(lambda: cfar_topk(mag), sync, args.iters),
        "topk": timeit(lambda: topk(det), sync, args.iters),
        "full": timeit(lambda: full(iq), sync, args.iters),
    }
    for k, v in results.items():
        print(f"{k:12s} {v * 1e3:8.3f} ms/batch  "
              f"{B / v:9.1f} frames/s", flush=True)


if __name__ == "__main__":
    main()
