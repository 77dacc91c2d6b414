#!/usr/bin/env python
"""Route evidence on the card: matmul precision and the CFAR decision.

1. Precision.  For the range DFT (ops/fft.dft_apply) and the folded
   slow-time contraction (ops/fft.doppler_apply) at each
   jax.lax.Precision, the error against float64 numpy, and the precision
   and algorithm fields the compiled program's dots carry.  Relative error
   ~1e-7 is float32, ~1e-6 a bf16 triple split, ~1e-3..1e-4 TF32.
2. CFAR.  The counting decision (cfar_2d_count, as jnp compares and as the
   Pallas counting kernel) against the ranked stack (cfar_2d) at the map's
   real width: the compiled program's temporary
   bytes (a materialized (R, D, n_ref) view stack is 67 MB of f32 at
   1024x128), its fusion count, and the median time of a batch of maps.
3. End to end.  make_batch_processor at batch 128, the counting route vs
   the ranked-stack route, in the order A B B A; median frames/s each.
4. Who counts, end to end.  The counting route with its counts taken by
   jnp compares (impl="jnp") vs the Pallas counting kernel
   (impl="kernel"), per-cell and block scale, batch 128, order A B B A.

Writes the compiled CFAR programs to ``--out`` and prints one JSON line.

Usage: python tools/route_probe.py [--out DIR] [--cpu] [--quick]
                                  [--only precision,cfar,end_to_end,count_impl]
"""

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import re
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def median_s(fn, arg, reps=10):
    import jax
    jax.block_until_ready(fn(arg))
    jax.block_until_ready(fn(arg))
    t = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(arg))
        t.append(time.perf_counter() - t0)
    return float(np.median(t))


def dot_fields(hlo: str) -> list:
    """The precision/algorithm settings of every dot or GEMM custom call in
    a compiled program's text, deduplicated."""
    pats = (r'operand_precision=\{[^}]*\}', r'algorithm=[\w.]+',
            r'"precision_config":\{[^}]*\}', r'custom_call_target="[^"]*"')
    found = set()
    for line in hlo.splitlines():
        if " dot(" in line or "custom-call(" in line:
            for pat in pats:
                found.update(re.findall(pat, line))
    return sorted(found)


def probe_precision(p):
    import jax
    import jax.numpy as jnp
    from fmcw_tpu.ops import fft as F
    rng = np.random.default_rng(0)
    nd, nr = p.n_doppler, p.n_range
    re_ = rng.normal(size=(nd, nr)).astype(np.float32) * 1000
    im_ = rng.normal(size=(nd, nr)).astype(np.float32) * 1000
    z = re_.astype(np.float64) + 1j * im_
    cr, ci = F.dft_matrices(nr, window=True, dtype=np.float64)
    want_r = z @ (cr + 1j * ci)
    mr, mi, _, _ = F.doppler_matrices(nd, p.notch_mode, "zero",
                                      dtype=np.float64)
    want_d = z.T @ (mr + 1j * mi)        # contract the chirp axis
    out = {}
    for name in ("DEFAULT", "HIGH", "HIGHEST"):
        prec = getattr(jax.lax.Precision, name)
        rf = jax.jit(lambda a, b: F.fft_apply(a, b, axis=1, window=True,
                                              precision=prec))
        df = jax.jit(lambda a, b: F.doppler_apply(a, b, axis=0,
                                                  bypass=jnp.asarray(False),
                                                  notch_mode=p.notch_mode,
                                                  precision=prec))
        res = {}
        for stage, fn, want in (("range_dft", rf, want_r),
                                ("slow_time", df, want_d)):
            gr, gi = fn(re_, im_)
            got = np.asarray(gr, np.float64) + 1j * np.asarray(gi)
            err = np.max(np.abs(got - want)) / np.max(np.abs(want))
            hlo = fn.lower(re_, im_).compile().as_text()
            res[stage] = {"max_err_of_peak": float(err),
                          "dot_fields": dot_fields(hlo)}
        out[name] = res
    return out


def probe_cfar(p, out_dir, n_maps=32, impls=("jnp", "kernel")):
    import jax
    import jax.numpy as jnp
    from fmcw_tpu.ops import cfar as C
    rng = np.random.default_rng(1)
    maps = jnp.asarray(rng.gamma(2.0, 80.0, (n_maps, p.n_range,
                                             p.n_doppler)).astype(np.float32))
    so = jnp.asarray(0, jnp.int32)
    singles = {f"count_{impl}": functools.partial(
        lambda m, impl: C.cfar_2d_count(m, so, cfar=p.cfar, impl=impl)[0],
        impl=impl) for impl in impls}
    singles["topk"] = lambda m: C.cfar_2d(m, so, cfar=p.cfar)[0]
    fns = {k: jax.jit(jax.vmap(f)) for k, f in singles.items()}
    res = {}
    for name, fn in fns.items():
        compiled = jax.jit(singles[name]).lower(maps[0]).compile()
        hlo = compiled.as_text()
        with open(os.path.join(out_dir, f"cfar_{name}.hlo.txt"), "w") as f:
            f.write(hlo)
        mem = compiled.memory_analysis()
        res[name] = {
            "temp_bytes_per_map": getattr(mem, "temp_size_in_bytes", None),
            "fusions": len(re.findall(r"\bfusion\(", hlo)),
            "ms_per_map": median_s(fn, maps) / n_maps * 1e3,
        }
    d_t = np.asarray(fns["topk"](maps))
    res["decisions_equal"] = all(
        bool(np.array_equal(np.asarray(fns[k](maps)) > 0, d_t > 0))
        for k in singles if k != "topk")
    return res


def probe_end_to_end(p, batch=128, routes=("count", "topk")):
    import jax
    from fmcw_tpu.golden import reference
    from fmcw_tpu.models import pipeline as pl
    rng = np.random.default_rng(2)
    base = pl.complex_to_iq(reference.two_target_frame(p))
    frames = np.stack([base] * batch)
    frames = jax.device_put(
        frames + rng.integers(-8, 8, frames.shape).astype(np.int16))
    procs = {m: pl.make_batch_processor(p, include_maps=False,
                                        cfar_method=m) for m in routes}
    fps = {m: [] for m in procs}
    a, b = routes
    for m in (a, b, b, a):
        fps[m].append(batch / median_s(procs[m], frames))
    return fps


@contextlib.contextmanager
def count_impl(impl):
    """Trace the counting CFAR with its counts taken by ``impl``."""
    from fmcw_tpu.ops import cfar as C
    orig = C.cfar_2d_count
    C.cfar_2d_count = functools.partial(orig, impl=impl)
    try:
        yield
    finally:
        C.cfar_2d_count = orig


def probe_count_impl(p, batch=128, impls=("jnp", "kernel")):
    """frames/s of the counting route with jnp counts vs the kernel's,
    per-cell and block scale, order A B B A.  Each processor is compiled
    inside its count_impl context, so the route is fixed in its program."""
    import jax
    from fmcw_tpu.golden import reference
    from fmcw_tpu.models import pipeline as pl
    rng = np.random.default_rng(3)
    base = pl.complex_to_iq(reference.two_target_frame(p))
    frames = np.stack([base] * batch)
    frames = jax.device_put(
        frames + rng.integers(-8, 8, frames.shape).astype(np.int16))
    a, b = impls[0], impls[-1]
    out = {}
    for scale_mode in ("cell", "block"):
        q = p.replace(cfar=dataclasses.replace(p.cfar, scale_mode=scale_mode))
        procs, dets, kernel_in = {}, {}, {}
        for impl in impls:
            with count_impl(impl):
                procs[impl] = pl.make_batch_processor(q, include_maps=False,
                                                      cfar_method="count")
                dets[impl] = np.asarray(procs[impl](frames)["n_dets"])
                text = procs[impl].jitted.lower(
                    frames, np.bool_(False), np.int32(0)).as_text()
                kernel_in[impl] = "cfar_count_window" in text
        fps = {impl: [] for impl in procs}
        for impl in (a, b, b, a):
            fps[impl].append(batch / median_s(procs[impl], frames))
        out[scale_mode] = {"frames_per_s": fps,
                           "n_dets_equal": bool(np.array_equal(
                               dets[a], dets[b])),
                           "kernel_in_program": kernel_in}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "chiprun_out", "route_probe"))
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--quick", action="store_true",
                    help="the 128x32 quick() map (CPU rehearsal)")
    ap.add_argument("--only", default="precision,cfar,end_to_end,count_impl",
                    help="comma-separated probes to run")
    args = ap.parse_args()
    only = set(args.only.split(","))
    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")
    import jax
    import fmcw_tpu
    from fmcw_tpu.utils import compile_cache
    compile_cache.setup()
    os.makedirs(args.out, exist_ok=True)
    p = fmcw_tpu.quick() if args.quick else fmcw_tpu.full()
    d = jax.devices()[0]
    batch = 4 if args.quick else 128
    # The counting kernel compiles for the GPU only; --cpu probes jnp.
    impls = ("jnp",) if args.cpu else ("jnp", "kernel")
    probes = {
        "precision": lambda: probe_precision(p),
        "cfar": lambda: probe_cfar(p, args.out,
                                   n_maps=4 if args.quick else 32,
                                   impls=impls),
        "end_to_end": lambda: probe_end_to_end(p, batch=batch),
        "count_impl": lambda: probe_count_impl(p, batch=batch,
                                               impls=impls),
    }
    res = {"device": {"platform": d.platform, "kind": d.device_kind,
                      "count": len(jax.devices())},
           "shape": [p.n_range, p.n_doppler]}
    for name, probe in probes.items():
        if name in only:
            res[name] = probe()
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
